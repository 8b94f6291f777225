"""Host ms of one pixel step in ``sampler.replay`` (launching the step's
graph), over the calls made with spans on and the profiler off just before
the traced slice."""

from hopbench.spans import host_ms_each

MOVES = "sample_images_per_s"


def read(reading):
    return host_ms_each(getattr(reading, "host_spans", None), "sampler.replay")
