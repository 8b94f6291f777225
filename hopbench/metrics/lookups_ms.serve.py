"""Device ms a reconstruct call of the work launched inside ``model.lookups``
(the three Hopfield lookups and the quantizer between them), in the traced
slice."""

from hopbench.spans import per_call_ms

MOVES = "recon_images_per_s"


def read(reading):
    return per_call_ms(reading, lambda st: st.device_s(("model.lookups",)))
