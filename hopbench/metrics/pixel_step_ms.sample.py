"""Device ms of one pixel step of the PixelCNN sampler, read by span: the
device time of the work launched inside ``sampler.replay`` spans (a graph's
kernels correlate to its launch) over the number of those spans, in the
traced slice."""

MOVES = "sample_images_per_s"


def read(reading):
    st = getattr(reading, "spans", None)
    steps = st.count("sampler.replay") if st is not None else 0
    if not steps:
        return None
    return 1e3 * st.device_s(("sampler.replay",)) / steps
