"""Device idle ms a reconstruct call while the host is in ``engine.forward``
(launching the forward), in the traced slice."""

from hopbench.spans import per_call_ms

MOVES = "recon_images_per_s"


def read(reading):
    return per_call_ms(reading, lambda st: st.idle_s(("engine.forward",)))
