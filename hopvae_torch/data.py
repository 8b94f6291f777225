"""Data helpers for the port: normalization and hermetic inputs.

Copies of ``MNIST_MEAN``/``MNIST_STD`` and ``_normalize`` from
``hopvae_tpu/data``, plus:

- :func:`golden_digits`: the committed ``assets/digits_28_seed0_64.npy``,
  64 rendered digits (``hopvae_tpu.data.render_digits(64, 28, seed=0)``),
  the golden input on hosts without PIL;
- :func:`synthetic_images`: a numpy-only FFHQ stand-in (smooth random
  low-frequency RGB images). It is not pixel-equal to the JAX package's,
  which resizes with ``jax.image``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
GOLDEN_DIGITS = Path(__file__).resolve().parent / "assets" / "digits_28_seed0_64.npy"

# Recon MSE and aux loss of the JAX package's f32 forward (impl="xla") on
# the golden inputs below, with the named checkpoint from checkpoints/.
# tests/test_torch_model.py holds both packages to these numbers.
GOLDENS = {
    "mnist_digits": {
        "config": "pixelcnn_mnist_28",
        "checkpoint": "PixelCNN-MNIST-28.msgpack",
        "recon_mse": 0.0073064,
        "aux": 3.7088e-5,
    },
    "ffhq64_synthetic4": {
        "config": "ffhq_64_scaled",
        "checkpoint": "Transformer-FFHQ-64.msgpack",
        "recon_mse": 2.108046e-4,
        "aux": 4.265848e-5,
    },
}


def _normalize(x_uint8: np.ndarray, data_set: str) -> np.ndarray:
    x = x_uint8.astype(np.float32) / 255.0
    if data_set == "MNIST":
        x = (x - MNIST_MEAN) / MNIST_STD
        if x.ndim == 3:
            x = x[..., None]
    else:  # CIFAR10 / FFHQ: Normalize((.5,.5,.5),(1,1,1))
        x = x - 0.5
    return x


def golden_digits() -> np.ndarray:
    """(64, 28, 28) uint8 rendered digits."""
    return np.load(GOLDEN_DIGITS)


def golden_input(name: str) -> np.ndarray:
    """The normalized NHWC batch of one entry of ``GOLDENS``."""
    if name == "mnist_digits":
        return _normalize(golden_digits(), "MNIST")
    if name == "ffhq64_synthetic4":
        return _normalize(synthetic_images(4, 64, seed=0), "FFHQ")
    raise KeyError(f"unknown golden {name!r}; available: {tuple(GOLDENS)}")


def _upsample_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Linear interpolation along ``axis`` with half-pixel centers."""
    n = a.shape[axis]
    pos = np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    w = (pos - lo).astype(np.float32)
    shape = [1] * a.ndim
    shape[axis] = size
    w = w.reshape(shape)
    return np.take(a, lo, axis=axis) * (1 - w) + np.take(a, hi, axis=axis) * w


def synthetic_images(n: int, image_size: int, seed: int = 0) -> np.ndarray:
    """(n, s, s, 3) uint8 smooth random images: 8×8 Gaussian noise,
    bilinearly upsampled and stretched to [0, 255]."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    up = _upsample_axis(_upsample_axis(base, 1, image_size), 2, image_size)
    up = (up - up.min()) / (np.ptp(up) + 1e-6)
    return (up * 255).astype(np.uint8)
