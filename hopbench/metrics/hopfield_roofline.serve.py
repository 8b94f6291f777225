"""The lookups' least time in the traced serving slice (K1 of each of the
three lookups, every call) over the device time of the lookups' kernels
there."""

from hopbench.arith import flops
from hopbench.readers import roofline

# the Hopfield lookups' kernels (csrc/hopfield_*): K1 to K3 and their helpers
PATTERN = r"stream_(fwd|bwd)\w*_kernel|build_queries\w*_kernel|(partial|slab)_scores_kernel|sum_(groups|rows)_kernel"
MOVES = "recon_images_per_s"


def read(reading):
    return roofline(reading, reading.calls * flops.lookups_least_seconds(reading.cfg, reading.batch, ("K1",)), PATTERN)
