"""Device idle ms a sample call while the host is in ``sampler.replay`` (a
pixel step's graph launch), in the traced slice."""

from hopbench.spans import per_call_ms

MOVES = "sample_images_per_s"


def read(reading):
    return per_call_ms(reading, lambda st: st.idle_s(("sampler.replay",)))
