"""The program's spans on a device trace's clock, and what the span readers ask.

A chrome trace of the card (:mod:`hopbench.devtrace`'s profile) with the
program's spans added to it as events of ``"cat": "program_span"`` on its
clock (``hopvae_torch.utils.tracing.chrome_events`` with the trace's
``baseTimeNanoseconds``). :class:`SpanTrace` answers two questions of the
slice (the first ``cudaDeviceSynchronize``'s end to the last's, as
:class:`hopbench.devtrace.Trace` cuts it):

- :meth:`SpanTrace.device_s`: the device seconds of the events whose
  launching runtime call started inside a span of the given names, the
  innermost open span deciding. A CUDA graph's kernels correlate to its
  ``cudaGraphLaunch``, so a replay's kernels go to the span around the
  replay;
- :meth:`SpanTrace.idle_s`: the device's idle seconds that overlap a span of
  the given names, or (``outside``) that no span of a prefix covers.

Every answer is None where the slice holds no span of the names asked.
The per-layer readers that use it (``metrics/*.py`` with ``source``
``program_span``) read ``reading.spans``, a :class:`SpanTrace`,
``reading.host_spans`` (the spans of calls made with spans on and the
profiler off) and ``reading.setup_spans`` (the set-up's spans); a reading
without them gives None.
"""

from __future__ import annotations

import bisect

from hopbench.devtrace import DEVICE_CATS, HOST_CATS, Trace, clip, gaps, merge

CAT = "program_span"


def overlap_us(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """µs in both unions of intervals."""
    a, b = merge(a), merge(b)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


class SpanTrace:
    """Device events ``(launch call's start, start, end)``, the program's
    spans ``(start, end, depth, name)`` sorted by start, and the slice, all
    in the trace's µs."""

    def __init__(self, chrome: dict):
        self.trace = Trace(chrome)
        lo, hi = self.trace.lo, self.trace.hi
        events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
        starts = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
        self.launched = [(starts.get(e.get("args", {}).get("correlation")), e["ts"], e["ts"] + e.get("dur", 0.0))
                         for e in events if e.get("cat") in DEVICE_CATS]
        self.spans = sorted((e["ts"], e["ts"] + e["dur"], e["args"]["depth"], e["name"]) for e in events
                            if e.get("cat") == CAT and lo <= e["ts"] <= hi)
        self._times, self._inner = [], []  # where the innermost open span changes, and its name there
        open_ = []  # (end, name), innermost last
        for s, e, _, name in self.spans:
            while open_ and open_[-1][0] <= s:
                self._cut(open_.pop()[0], open_[-1][1] if open_ else None)
            self._cut(s, name)
            open_.append((e, name))
        while open_:
            self._cut(open_.pop()[0], open_[-1][1] if open_ else None)

    def _cut(self, t: float, name: str | None) -> None:
        self._times.append(t)
        self._inner.append(name)

    def count(self, name: str) -> int:
        """Spans named ``name`` that start in the slice."""
        return sum(1 for s in self.spans if s[3] == name)

    def _named(self, names) -> list[tuple[float, float]]:
        return [(s, e) for s, e, _, n in self.spans if n in names]

    def innermost(self, t: float) -> str | None:
        """The name of the innermost span open at ``t`` (spans nest, as one
        thread's do), None where none is."""
        k = bisect.bisect_right(self._times, t) - 1
        return self._inner[k] if k >= 0 else None

    def device_s(self, names) -> float | None:
        """Seconds of the slice's device events launched inside a span of
        ``names``, innermost span deciding; None without such a span."""
        if not self._named(names):
            return None
        lo, hi = self.trace.lo, self.trace.hi
        total = 0.0
        for launch, s, e in self.launched:
            if launch is not None and self.innermost(launch) in names:
                total += sum(b - a for a, b in clip([(s, e)], lo, hi))
        return total * 1e-6

    def idle(self) -> list[tuple[float, float]]:
        """The device's idle stretches of the slice."""
        return gaps(self.trace.intervals(), self.trace.lo, self.trace.hi)

    def idle_s(self, names=None, outside: str | None = None) -> float | None:
        """Idle seconds of the slice under a span of ``names``, or with
        ``outside`` under no span whose name starts with it; None without
        such a span."""
        if outside is not None:
            covered = [(s, e) for s, e, _, n in self.spans if n.startswith(outside)]
            if not covered:
                return None
            idle = self.idle()
            return (sum(e - s for s, e in idle) - overlap_us(idle, covered)) * 1e-6
        named = self._named(names)
        return overlap_us(self.idle(), named) * 1e-6 if named else None


def per_call_ms(reading, seconds) -> float | None:
    """``seconds`` (a function of the reading's :class:`SpanTrace`) in ms a
    call of the traced slice; None where the reading has no spans or the
    function gives None."""
    st = getattr(reading, "spans", None)
    if st is None or not reading.calls or not st.trace.has_device_events():
        return None
    s = seconds(st)
    return None if s is None else 1e3 * s / reading.calls


def host_ms_each(recorded, name: str) -> float | None:
    """The mean host ms of the spans named ``name`` among ``recorded``
    (``hopvae_torch.utils.tracing.Span`` records); None without one."""
    spans = [s for s in recorded or () if s.name == name]
    return 1e-6 * sum(s.end - s.start for s in spans) / len(spans) if spans else None
