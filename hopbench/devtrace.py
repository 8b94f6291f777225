"""A ``torch.profiler`` trace of a slice of the window, read into intervals.

:func:`profiled` traces the card alone (kernels, copies, sets and the CUDA
runtime calls that launched them) over a block that starts and ends on a
synchronise: recording every host operation as well would slow the
host-bound cells' calls by half or more and read as device idle time. The
slice runs from the end of the first ``cudaDeviceSynchronize`` to the end
of the last. :class:`Trace` holds each device event with the name of the
runtime call that launched it (by the launch's correlation id) and answers
what the per-layer readers ask: busy seconds, the device time of events by
name pattern or by launching call, the top operations and the longest idle
gaps, each named by the runtime call the host was in.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC = "cudaDeviceSynchronize"


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the card over the block; on exit ``holder["trace"]`` is its
    :class:`Trace` (None without a card: nothing to read)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        holder["trace"] = None
        yield
        return

    with profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            holder["trace"] = Trace(json.load(f))
    finally:
        os.remove(path)


def warm_profiler() -> None:
    """Start and stop the profiler once, before anything is captured in a
    CUDA graph, so that its device tracing is set up when graphs are made."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` (in µs) that any interval covers."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi))) * 1e-6


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of ``[lo, hi]`` between the merged intervals."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


class Trace:
    """Device events ``{"name", "ts", "dur", "launch"}`` (µs; ``launch`` the
    runtime call that launched it, or ``""``), the host's runtime calls, and
    the slice ``[lo, hi]``."""

    def __init__(self, chrome: dict):
        events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
        self.host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                           if e.get("cat") in HOST_CATS)
        syncs = [end for _, end, name in self.host if name == SYNC]
        self.lo, self.hi = (syncs[0], syncs[-1]) if len(syncs) >= 2 else (0.0, 0.0)
        launches = {e["args"]["correlation"]: e["name"] for e in events
                    if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
        self.device = [{"name": e["name"], "ts": e["ts"], "dur": e.get("dur", 0.0),
                        "launch": launches.get(e.get("args", {}).get("correlation"), "")}
                       for e in events if e.get("cat") in DEVICE_CATS]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def intervals(self, pattern: str | None = None, launch: str | None = None) -> list[tuple[float, float]]:
        rx = re.compile(pattern) if pattern else None
        return [(d["ts"], d["ts"] + d["dur"]) for d in self.device
                if (rx is None or rx.search(d["name"])) and (launch is None or d["launch"] == launch)]

    def busy_s(self, pattern: str | None = None, launch: str | None = None) -> float:
        """Seconds of the slice in which a matching device event ran."""
        return busy_seconds(self.intervals(pattern, launch), self.lo, self.hi)

    def device_s(self, pattern: str | None = None, launch: str | None = None) -> float:
        """The summed durations of the matching device events in the slice."""
        return sum(e - s for s, e in clip(self.intervals(pattern, launch), self.lo, self.hi)) * 1e-6

    def has_device_events(self) -> bool:
        return bool(clip(self.intervals(), self.lo, self.hi))

    def top_ops(self, n: int = 10) -> list[list]:
        totals = {}
        for d in self.device:
            for s, e in clip([(d["ts"], d["ts"] + d["dur"])], self.lo, self.hi):
                totals[d["name"]] = totals.get(d["name"], 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest idle stretches of the device, each named by the
        runtime call the host was in at its middle (``host`` where none:
        the host was running Python or waiting)."""
        out = []
        for s, e in sorted(gaps(self.intervals(), self.lo, self.hi), key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            names = [name for hs, he, name in self.host if hs <= mid <= he]
            out.append([names[-1] if names else "host", (e - s) * 1e-6])
        return out
