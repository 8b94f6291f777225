"""Spans: named intervals of the host's time, recorded by the program.

The port's one span system. ``with span("engine.forward"): ...`` records
``Span(name, start, end, depth, thread)`` when recording is on: ``start``
and ``end`` in ``time.perf_counter_ns()``, ``depth`` the number of spans
open around it on its thread, ``thread`` its native thread id. Off (the
default), :func:`span` tests one module-level flag and returns one shared
object that does nothing, so a span costs no allocation.

Recording has no setting of its own: a caller that wants spans (a
benchmark, a test, :func:`hopvae_torch.train.profiled`) calls
:func:`enable`, which clears the list, and :func:`disable`. The spans of
the process go to one list, read by :func:`spans`.

On a ``torch.profiler`` trace's clock: :func:`enable` reads
``time.time_ns()`` and ``time.perf_counter_ns()`` together, so
:func:`unix_ns` turns a span's times into Unix-epoch ns, and a chrome
trace's ``ts`` (µs) plus its ``baseTimeNanoseconds`` / 1e3 is Unix-epoch
µs; :func:`chrome_events` gives the spans as events of such a trace.
"""

from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start: int  # perf_counter_ns
    end: int
    depth: int
    thread: int


_on = False
_spans: list[tuple] = []  # the fields of each Span, made into one when read
_anchor = (0, 0)  # (time_ns, perf_counter_ns), read together by enable()
# .state: [the spans open on this thread, its native id]; the id is read once
# a thread, since get_native_id() is a system call
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "start", "depth", "state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            state = _local.state
        except AttributeError:
            state = _local.state = [0, threading.get_native_id()]
        self.state, self.depth = state, state[0]
        state[0] += 1
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.state[0] = self.depth
        _spans.append((self.name, self.start, end, self.depth, self.state[1]))
        return False


def span(name: str):
    """A context manager that records the block as a span named ``name``
    while recording is on, and does nothing otherwise."""
    if not _on:
        return _OFF
    return _On(name)


def enable() -> None:
    """Clear the spans, pair the two clocks, and start recording. The pair
    is the counter beside the middle of two wall-clock reads, the closest
    two of a few tries, so that a preemption between reads does not shift
    the pair."""
    global _on, _anchor
    _spans.clear()
    tries = []
    for _ in range(5):
        before, counter, after = time.time_ns(), time.perf_counter_ns(), time.time_ns()
        tries.append((after - before, (before + after) // 2, counter))
    _anchor = min(tries)[1:]
    _on = True


def disable() -> None:
    """Stop recording; the spans stay until the next :func:`enable`."""
    global _on
    _on = False


def spans() -> list[Span]:
    """The spans closed since :func:`enable`, in the order they closed."""
    return [Span(*s) for s in _spans]


def unix_ns(t: int) -> int:
    """A ``perf_counter_ns`` reading of this recording as Unix-epoch ns."""
    wall, counter = _anchor
    return t - counter + wall


def seconds(name: str, recorded: list[Span] | None = None) -> float:
    """The summed seconds of the spans named ``name`` (of ``recorded``, or
    of :func:`spans`)."""
    return sum(s.end - s.start for s in (spans() if recorded is None else recorded) if s.name == name) * 1e-9


def chrome_events(base_ns: int, recorded: list[Span] | None = None) -> list[dict]:
    """The spans as complete events (``"ph": "X"``, ``"cat":
    "program_span"``) of a chrome trace whose ``baseTimeNanoseconds`` is
    ``base_ns``: ``ts`` and ``dur`` in µs on the trace's clock."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (unix_ns(s.start) - base_ns) / 1e3, "dur": (s.end - s.start) / 1e3, "args": {"depth": s.depth}}
            for s in (spans() if recorded is None else recorded)]
