"""The port's hermetic synthetic images against the JAX package's.

``hopvae_torch.data.synthetic_images`` upsamples with numpy where
``hopvae_tpu.data.synthetic_images`` calls ``jax.image.resize``; the f32
sums run in another order, so a value that sits on the edge of a uint8
step can land one step off. Small sets are pixel-equal; the FFHQ fallback
that ffhq_64_scaled trains on (2048 images of 64×64) differs in 10 of
25.2 M values, each by one step.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import numpy as np
import pytest

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.data import get_datasets as jax_get_datasets
from hopvae_tpu.data import synthetic_images as jax_synthetic_images
from hopvae_torch import load_config
from hopvae_torch.data import get_datasets, synthetic_images


@pytest.mark.parametrize("n,size", [(4, 64), (64, 64), (300, 32)])
def test_small_sets_are_pixel_equal(n, size):
    np.testing.assert_array_equal(synthetic_images(n, size, seed=0), jax_synthetic_images(n, size, seed=0))


def test_ffhq_fallback_splits_differ_by_at_most_one_step():
    """Every split of ``get_datasets(ffhq_64_scaled, None)``: at most one
    value per million differs, and by one uint8 step (1/255 after the
    normalisation) at most."""
    ours = get_datasets(load_config("ffhq_64_scaled"), None)
    theirs = jax_get_datasets(jax_load_config("ffhq_64_scaled"), None)
    total = diff = 0
    for a, b in zip(ours, theirs):
        assert a.images.shape == b.images.shape
        np.testing.assert_array_equal(a.labels, b.labels)
        gap = np.abs(a.images.astype(np.float64) - b.images)
        assert gap.max() <= 1 / 255 + 1e-6
        total += gap.size
        diff += int(np.count_nonzero(gap))
    assert total == 2048 * 64 * 64 * 3
    assert diff <= total // 1_000_000, diff
