"""The share of the traced serving slice in which nothing ran on the card."""

from hopbench.readers import idle_share

MOVES = "recon_images_per_s"


def read(reading):
    return idle_share(reading)
