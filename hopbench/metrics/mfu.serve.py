"""A reconstruct call's share of the card's dense bf16 peak: the copied
forward FLOPs per image times the traced slice's images per second."""

from hopbench.arith import flops
from hopbench.readers import mfu

MOVES = "recon_images_per_s"


def read(reading):
    return mfu(reading, flops.forward_flops_per_image(reading.cfg))
