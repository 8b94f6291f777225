"""A reconstruct call's host ms minus the device's busy ms a call: padding,
conversion, pageable copies' host side and launches, which the device
waits for. The host ms is the mean of as many calls as the traced slice
holds, made just before it without the profiler (which slows the host);
the busy ms is the traced slice's busy time over its calls."""

MOVES = "recon_images_per_s"


def read(reading):
    tr = reading.trace
    if tr is None or not reading.calls or not tr.has_device_events():
        return None
    return sum(reading.call_ms) / len(reading.call_ms) - 1e3 * tr.busy_s() / reading.calls
