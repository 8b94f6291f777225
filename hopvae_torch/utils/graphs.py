"""CUDA graph captures that Python's garbage collector cannot break.

``torch.cuda.graph`` no longer collects garbage before a capture
(``torch.compiler.config.force_cudagraph_gc`` is off by default), so the
cyclic collector can run in the middle of one, on any thread, and free
objects that died before it began. Where such an object owns a CUDA graph
(a ``Trainer`` and its epoch runner refer to each other), its destructor
calls ``cudaGraphExecDestroy``, which a capture in CUDA's global mode
refuses: the capture is invalidated and ``capture_end`` raises "operation
failed due to a previous error during capture". Whether it happens depends
on when the collector's thresholds trip, so it fails one run in several.

Every capture of the port runs inside :func:`collector_held`.
"""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def collector_held():
    """One full collection, then the cyclic collector off for the block and
    back on after it (where it was on). Nested blocks leave it off until
    the outermost ends. Objects that die inside are freed by their
    reference counts as ever; cycles wait for the next collection."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
