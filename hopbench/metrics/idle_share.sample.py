"""The share of the traced sampling slice in which nothing ran on the card."""

from hopbench.readers import idle_share

MOVES = "sample_images_per_s"


def read(reading):
    return idle_share(reading)
