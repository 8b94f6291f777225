"""Arithmetic the per-layer readers share; each returns None where the
trace has nothing to read (never a 0 for a share)."""

from __future__ import annotations

from hopbench.arith.flops import PEAK_BF16_FLOPS


def _usable(reading) -> bool:
    tr = reading.trace
    return tr is not None and tr.window_s > 0 and tr.has_device_events()


def idle_share(reading):
    """% of the slice in which no kernel, copy or set ran on the card."""
    if not _usable(reading):
        return None
    tr = reading.trace
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(reading, flops_per_image: float):
    """% of the dense bf16 peak: FLOPs per image times the slice's images
    over its length."""
    if not _usable(reading) or not reading.images:
        return None
    return 100.0 * flops_per_image * reading.images / reading.trace.window_s / PEAK_BF16_FLOPS


def roofline(reading, least_s: float, pattern: str):
    """% of the lookups' kernels' device time in the slice that their least
    time ``least_s`` is; the kernels are those whose names match ``pattern``."""
    if not _usable(reading):
        return None
    spent = reading.trace.device_s(pattern)
    return 100.0 * least_s / spent if spent > 0 else None
