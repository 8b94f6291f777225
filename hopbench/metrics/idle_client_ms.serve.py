"""Device idle ms a reconstruct call while the host is in no ``engine.*``
span: the client between calls, in the traced slice. With the three other
``idle_*_ms.serve`` it sums to the slice's idle ms a call."""

from hopbench.spans import per_call_ms

MOVES = "recon_images_per_s"


def read(reading):
    return per_call_ms(reading, lambda st: st.idle_s(outside="engine."))
