"""Device ms of one pixel step of the PixelCNN sampler: the device time of
the kernels that its captured step's replays launch (``cudaGraphLaunch``;
the sample cell runs no other graph) in the traced slice, over the slice's
pixel steps."""

MOVES = "sample_images_per_s"


def read(reading):
    tr = reading.trace
    if tr is None or not reading.pixel_steps:
        return None
    s = tr.device_s(launch="cudaGraphLaunch")
    return 1e3 * s / reading.pixel_steps if s > 0 else None
