"""Host seconds of the engine's warm-up in set-up: the ``engine.warmup``
spans of the traced run's set-up (its nvcc builds and graph captures fall
inside)."""

MOVES = "setup_s"


def read(reading):
    spans = [s for s in getattr(reading, "setup_spans", None) or () if s.name == "engine.warmup"]
    return 1e-9 * sum(s.end - s.start for s in spans) if spans else None
