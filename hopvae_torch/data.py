"""Data for the port: readers, datasets, batches and hermetic inputs.

The port's own copies of ``hopvae_tpu/data`` (importing any
``hopvae_tpu`` module imports JAX):

- the readers: MNIST IDX files, the CIFAR10 pickles and an FFHQ-style
  image folder (``.npy`` arrays, or image files through PIL);
- :class:`ArrayDataset`, the streaming :class:`LazyImageFolder`,
  :func:`iterate_batches` (a per-process slice of every batch, and a
  prefetch thread) and :func:`get_datasets` with the reference's splits
  (an FFHQ folder of more than ``STREAMING_THRESHOLD`` files streams) and
  the hermetic fallbacks: :func:`render_digits` for MNIST (it needs PIL)
  and :func:`synthetic_images` for CIFAR10 and FFHQ;
- :func:`golden_digits`: the committed ``assets/digits_28_seed0_64.npy``,
  64 rendered digits (``hopvae_tpu.data.render_digits(64, 28, seed=0)``),
  the golden input on hosts without PIL;
- :func:`golden_grid`: the committed ``assets/ffhq64_grid4.npy``, the JAX
  package's quantized grid of the ``ffhq64_synthetic4`` batch;
  :func:`interp_grid`: ``assets/ffhq64_interp_grid4.npy``, its
  interpolation grid (``SERVING_GOLDENS``); :func:`sample_grid`: JAX's
  draws of ``DECODE_GOLDENS`` with the noise of :func:`gumbel_noise`;
  :func:`pixelcnn_grid` and :func:`pixelcnn_sample_grid`: the quantized
  grid of the 64 golden digits and JAX's PixelCNN draws of
  ``PIXELCNN_GOLDENS`` with the noise of :func:`pixelcnn_noise`.

:func:`synthetic_images` upsamples with numpy where the JAX package
calls ``jax.image.resize``, whose f32 sums run in another order. The two
are pixel-equal at (n, size) = (4, 64), (64, 64) and (300, 32); on the
2048-image FFHQ fallback set 10 of 25.2 M values differ, each by 1
(``tests/test_torch_data.py`` holds both).
"""

from __future__ import annotations

import gzip
import os
import pickle
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
ASSETS = Path(__file__).resolve().parent / "assets"
GOLDEN_DIGITS = ASSETS / "digits_28_seed0_64.npy"
GOLDEN_GRID = ASSETS / "ffhq64_grid4.npy"
INTERP_GRID = ASSETS / "ffhq64_interp_grid4.npy"
PIXELCNN_GRID = ASSETS / "mnist28_grid64.npy"
PIXELCNN_SAMPLE_GRID = ASSETS / "mnist28_pixelcnn_sample_grid4.npy"

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

# One training run of the JAX package (Trainer._step_core, impl="xla", f32,
# make_optimizer at a constant lr; tests/test_torch_train.py recomputes
# it): the MNIST backbone on the 64 golden digits, one batch, four steps.
# "losses" are the loss of each step, so step k's is taken after k Adam
# updates; "grad_norms" are the global gradient norms of each top-level
# module at step 0 (watch_gradients' grad_norm/<module>). The tolerances
# are the port's, on the CPU (tests/test_torch_train.py) and with the
# kernels on the card (chip_smoke.py): the eager CPU path lands within
# 1.2e-4 of the losses and 3e-6 of the norms; the rest leaves room for a
# quantizer bin that flips where a logit sits on a .5 edge, which moves
# one token's aux-path gradients.
TRAIN_GOLDEN = {
    "config": "pixelcnn_mnist_28",
    "checkpoint": "PixelCNN-MNIST-28.msgpack",
    "learning_rate": 1e-3,
    "losses": [0.007343466859310865, 0.10418246686458588, 0.030351165682077408, 0.01988830231130123],
    "grad_norms": {
        "encoder": 0.3526909053325653,
        "pre_vq_conv": 0.4854174852371216,
        "hopfield": 1.3237977027893066,
        "embedding_to_index": 1.4161494618747383e-05,
        "index_to_embedding": 0.0007951074512675405,
        "decoder": 0.35033610463142395,
    },
    "loss0_rtol": 1e-3,
    "losses_rtol": 1e-3,
    "grad_norm_rtol": 2e-3,
}

# The Transformer prior on ffhq_64_scaled (prior=Transformer) with the
# weights of Transformer-FFHQ-64.msgpack, JAX f32 (tests/test_torch_prior.py
# recomputes both): "loss" is the second output of
# HopVAE.forward(fit_prior=True) on the ffhq64_synthetic4 batch, the bits
# plus the aux loss; "bits" is the teacher-forced cross-entropy in bits of
# the prior alone on that batch's quantized grid, ``golden_grid()``. The
# grid uses 22 of the 512 levels, and no sigmoid(logit)·511 of the batch
# comes closer than 1.5e-4 of a level to a rounding edge; a bin that
# flips on another machine moves the loss by about 1e-4 relative.
PRIOR_GOLDENS = {
    "config": "ffhq_64_scaled",
    "prior": "Transformer",
    "checkpoint": "Transformer-FFHQ-64.msgpack",
    "loss": 1.1246376037597656,
    "aux": 4.2658456e-5,
    "bits": 1.1245949268341064,
    "bits_rtol": 1e-4,
    "loss_rtol": 1e-3,
    "max_flipped_bins": 2,
}

# Serving with PRIOR_GOLDENS' model (ffhq_64_scaled, prior=Transformer,
# Transformer-FFHQ-64.msgpack), JAX f32 (impl="xla"): HopVAE.interpolate of
# the ffhq64_synthetic4 batch paired with its reverse (image i with image
# 3 - i), and the decode that HopVAE.sample runs after its prior, of
# golden_grid(). "grid" is interpolate's level grid after the prior's
# reconstruct (assets/ffhq64_interp_grid4.npy, interp_grid()); "stats" are
# each output image's mean |v| and mean v². Made, and held, by
# tests/test_torch_sample.py::test_serving_goldens_match_jax, which
# recomputes them with the JAX package:
#     JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sample.py -k goldens
# Before the prior every pre-round level lies at least 4.4e-5 of a level
# from a rounding edge, and the prior's argmax leads by at least 2.8e-4 in
# logit; a level that moves by one moves an image's stats by at most
# 1.5e-4 relative (the port on the CPU, five random bins).
SERVING_GOLDENS = {
    "interpolate": {
        "stats": [[0.5098177194595337, 0.44744181632995605], [0.5093593001365662, 0.4523080885410309],
                  [0.5093593001365662, 0.4523080885410309], [0.5098177194595337, 0.44744181632995605]],
        "max_flipped_bins": 4,
    },
    "decode": {
        "stats": [[0.024585964158177376, 0.0009112516418099403], [0.03067040629684925, 0.0015446488978341222],
                  [0.026895442977547646, 0.001050979015417397], [0.022470392286777496, 0.0007796580903232098]],
    },
    "stats_rtol": 1e-3,
}

# Three prior-phase steps of the JAX package (Trainer._step_core(True) with
# make_optimizer(prior_only=True), impl="xla", f32, constant lr 1e-3) on
# the ffhq64_synthetic4 batch from PRIOR_GOLDENS' weights: the loss of
# each step (step k's is taken after k Adam updates) and the global norm
# of the prior's gradient at step 0. The first Adam step moves each
# weight by about lr, which throws the trained prior off (8.72 bits).
PRIOR_TRAIN_GOLDEN = {
    "config": "ffhq_64_scaled",
    "prior": "Transformer",
    "checkpoint": "Transformer-FFHQ-64.msgpack",
    "input": "ffhq64_synthetic4",
    "learning_rate": 1e-3,
    "losses": [1.1248483657836914, 8.723876953125, 2.5462441444396973],
    "grad_norm": 4.6580376625061035,
    "losses_rtol": 1e-3,
    "grad_norm_rtol": 2e-3,
}


# The Transformer prior's KV-cached decode with PRIOR_GOLDENS' model (the
# JAX package, f32 CPU; tests/test_torch_decode_goldens.py recomputes it):
# "bits" are the teacher-forced bits of golden_grid() through JAX's
# decode_logits with each cache dtype (f32 lands 2e-7 from forward's
# PRIOR_GOLDENS bits); "noise" the numpy recipe of gumbel_noise(); "grids"
# JAX's draws at batch 4 with that noise fed to argmax(logits + noise[t])
# (assets/ffhq64_sample_grid4_*.npy, uint16), and "min_margin" the smallest
# top-two margin of logits + noise along each of the 4 rows, the floor under
# the card's near-tie rule ("near_tie").
DECODE_GOLDENS = {
    "config": "ffhq_64_scaled",
    "checkpoint": "Transformer-FFHQ-64.msgpack",
    "prior": "Transformer",
    "bits": {"float32": 1.1245952, "bfloat16": 1.1247342, "int8": 1.1243891, "int4": 1.1783848},
    "bits_atol": {"float32": 1e-4, "bfloat16": 1e-3, "int8": 1e-3, "int4": 1e-3},
    "noise": {"generator": "numpy.random.default_rng", "seed": 10, "shape": (867, 4, 512)},
    "grids": {"float32": "ffhq64_sample_grid4_f32.npy", "int8": "ffhq64_sample_grid4_int8.npy"},
    "min_margin": {"float32": [2.0514e-3, 1.7595e-3, 9.8600e-3, 2.0504e-4],
                   "int8": [1.9770e-3, 1.0462e-3, 2.1915e-3, 1.9016e-3]},
    "near_tie": 1e-4,
}

# The PixelCNN prior of PixelCNN-MNIST-28.msgpack (pixelcnn_mnist_28), JAX
# f32 (impl="xla"; tests/test_torch_pixelcnn_goldens.py recomputes all of
# it): "bits" are the prior's teacher-forced bits of the 64 golden digits'
# quantized grid (assets/mnist28_grid64.npy, pixelcnn_grid()), "loss" the
# second output of HopVAE.forward(fit_prior=True) on those digits, the bits
# plus the aux loss. The card holds the bits within bits_rtol on the
# committed grid, and the loss within loss_rtol with at most
# max_flipped_bins bins of its own grid off the committed one: one
# pre-round level of the batch lies 1.08e-4 of a level from a rounding
# edge. "noise" is the numpy recipe of pixelcnn_noise(), the (r², C, B, L)
# Gumbel noise of JAX's draws at batch 4 with argmax(logits + noise) as the
# draw (assets/mnist28_pixelcnn_sample_grid4.npy, pixelcnn_sample_grid(),
# uint16), and "min_margin" the smallest top-two margin of logits + noise
# along each of the 4 rows, the floor under the card's near-tie rule.
PIXELCNN_GOLDENS = {
    "config": "pixelcnn_mnist_28",
    "checkpoint": "PixelCNN-MNIST-28.msgpack",
    "input": "mnist_digits",
    "bits": 1.2058744430541992,
    "loss": 1.2059112787246704,
    "bits_rtol": 1e-4,
    "loss_rtol": 1e-3,
    "max_flipped_bins": 2,
    "noise": {"generator": "numpy.random.default_rng", "seed": 11, "shape": (192, 4, 512)},
    "min_margin": [2.5478e-2, 7.1940e-3, 4.7438e-2, 5.3350e-2],
    "near_tie": 1e-4,
}

# Three prior-phase steps of the JAX package as PRIOR_TRAIN_GOLDEN's, with
# PIXELCNN_GOLDENS' model on the 64 golden digits: the loss of each step
# (recon + bits + aux; step k's is taken after k Adam updates) and the
# global norm of the prior's gradient at step 0. The step-0 loss is held
# within loss0_rtol, the later ones within losses_rtol: f32 sums in another
# order move pre-activations across their relu's kink, so the deep blocks'
# step-0 gradients differ from JAX's by up to 2.7e-3 normwise (the port on
# the CPU), a few weights' gradients of 1e-9 to 1e-5 change sign, and Adam
# steps each of those by 2·lr the other way: the CPU port lands 9e-7, 5e-5
# and 1.1e-3 off the three losses.
PIXELCNN_TRAIN_GOLDEN = {
    "config": "pixelcnn_mnist_28",
    "prior": "PixelCNN",
    "checkpoint": "PixelCNN-MNIST-28.msgpack",
    "input": "mnist_digits",
    "learning_rate": 1e-3,
    "losses": [1.2132176160812378, 5.654932498931885, 2.1508164405822754],
    "grad_norm": 3.748903274536133,
    "loss0_rtol": 1e-4,
    "losses_rtol": 5e-3,
    "grad_norm_rtol": 2e-3,
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


def gumbel_noise(shape: tuple = None, seed: int = None) -> np.ndarray:
    """Gumbel noise ``-log(-log(u))`` in f32, ``u`` uniform from
    ``np.random.default_rng(seed)`` raised to f32's ``tiny``; by default
    ``DECODE_GOLDENS``' recipe, the ``(S, B, L)`` noise of its draws."""
    spec = DECODE_GOLDENS["noise"]
    shape = spec["shape"] if shape is None else shape
    seed = spec["seed"] if seed is None else seed
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return -np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny)))


def pixelcnn_noise() -> np.ndarray:
    """``PIXELCNN_GOLDENS``' noise as the PixelCNN sampler takes it:
    ``(r², C, B, L)`` = ``(64, 3, 4, 512)``."""
    spec = PIXELCNN_GOLDENS["noise"]
    return gumbel_noise(spec["shape"], spec["seed"]).reshape(64, 3, *spec["shape"][1:])


def pixelcnn_grid() -> np.ndarray:
    """(64, 8, 8, 3) float32 levels: the JAX quantized grid of the 64
    golden digits under ``PIXELCNN_GOLDENS``' checkpoint."""
    return np.load(PIXELCNN_GRID).astype(np.float32)


def pixelcnn_sample_grid() -> np.ndarray:
    """(4, 8, 8, 3) float32 levels: JAX's PixelCNN draws of
    ``PIXELCNN_GOLDENS`` with :func:`pixelcnn_noise`."""
    return np.load(PIXELCNN_SAMPLE_GRID).astype(np.float32)


def golden_digits() -> np.ndarray:
    """(64, 28, 28) uint8 rendered digits."""
    return np.load(GOLDEN_DIGITS)


def golden_grid() -> np.ndarray:
    """(4, 17, 17, 3) float32 levels: the JAX quantized grid of the
    ``ffhq64_synthetic4`` batch (stored as uint16)."""
    return np.load(GOLDEN_GRID).astype(np.float32)


def interp_grid() -> np.ndarray:
    """(4, 17, 17, 3) float32 levels: the JAX interpolation grid of
    ``SERVING_GOLDENS`` (stored as uint16)."""
    return np.load(INTERP_GRID).astype(np.float32)


def sample_grid(cache_dtype: str) -> np.ndarray:
    """JAX's draws of ``DECODE_GOLDENS`` with that cache dtype, float32."""
    return np.load(ASSETS / DECODE_GOLDENS["grids"][cache_dtype]).astype(np.float32)


def image_stats(images: np.ndarray) -> np.ndarray:
    """Each image's mean |v| and mean v², ``(N, 2)`` in float64: the
    serving goldens' measure."""
    flat = np.asarray(images, np.float64).reshape(len(images), -1)
    return np.stack([np.abs(flat).mean(-1), (flat**2).mean(-1)], -1)


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


def render_digits(n: int, image_size: int = 28, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Hermetic MNIST-like data: PIL-bitmap-font digits with random shifts,
    ``(images uint8 (n, s, s), labels)``; the same images as the JAX
    package's for the same arguments."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, image_size, image_size), np.uint8)
    ys = rng.integers(0, 10, n)
    for i, d in enumerate(ys):
        img = Image.new("L", (image_size, image_size), 0)
        dx, dy = rng.integers(4, 13), rng.integers(2, 11)
        ImageDraw.Draw(img).text((int(dx), int(dy)), str(int(d)), fill=255, font=font)
        xs[i] = np.asarray(img)
    return xs, ys.astype(np.int64)


# ----------------------------------------------------------------- readers


def read_idx(path: str) -> np.ndarray:
    """An IDX (ubyte) file, MNIST's format, optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(path: str, names: tuple) -> str | None:
    for n in names:
        for cand in (os.path.join(path, n), os.path.join(path, "MNIST", "raw", n)):
            for ext in ("", ".gz"):
                if os.path.exists(cand + ext):
                    return cand + ext
    return None


def load_mnist(path: str) -> tuple | None:
    """``(train_x, train_y, test_x, test_y)`` uint8, or None if absent."""
    tr_x = _find(path, ("train-images-idx3-ubyte", "train-images.idx3-ubyte"))
    tr_y = _find(path, ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"))
    te_x = _find(path, ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"))
    te_y = _find(path, ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"))
    if not all((tr_x, tr_y, te_x, te_y)):
        return None
    return read_idx(tr_x), read_idx(tr_y), read_idx(te_x), read_idx(te_y)


def load_cifar10(path: str) -> tuple | None:
    """The standard ``cifar-10-batches-py`` pickles, or None if absent.
    They are pickles: read only files you trust."""
    base = os.path.join(path, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = path
    batches = [os.path.join(base, f"data_batch_{i}") for i in range(1, 6)]
    test = os.path.join(base, "test_batch")
    if not (all(os.path.exists(b) for b in batches) and os.path.exists(test)):
        return None

    def _read(p):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(d[b"labels"], dtype=np.int64)

    xs, ys = zip(*[_read(b) for b in batches])
    te_x, te_y = _read(test)
    return np.concatenate(xs), np.concatenate(ys), te_x, te_y


def list_image_files(path: str) -> list:
    """Sorted recursive listing of the image files under ``path``
    (``.npy`` = pre-resized uint8 HWC arrays)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".npy")
    if not path or not os.path.isdir(path):
        return []
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs if f.lower().endswith(exts))


def _read_image_uint8(path: str, image_size: int) -> np.ndarray:
    """One file → ``(H, W, 3)`` uint8. A ``.npy`` must be pre-resized."""
    if path.endswith(".npy"):
        a = np.load(path)
        if a.dtype != np.uint8 and np.issubdtype(a.dtype, np.integer) and a.size and 0 <= a.min() and a.max() <= 255:
            a = a.astype(np.uint8)  # integer values in range cast losslessly; floats still raise
        if a.shape != (image_size, image_size, 3) or a.dtype != np.uint8:
            raise ValueError(
                f"{path}: expected pre-resized ({image_size},{image_size},3) "
                f"uint8 (or integer values in [0,255]), got {a.shape} {a.dtype}"
            )
        return a
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img)


def load_image_folder(path: str, image_size: int) -> np.ndarray | None:
    """A folder of images → ``(N, H, W, 3)`` uint8 (FFHQ-style)."""
    files = list_image_files(path)
    if not files:
        return None
    out = np.empty((len(files), image_size, image_size, 3), np.uint8)
    for i, fp in enumerate(files):
        out[i] = _read_image_uint8(fp, image_size)
    return out


def _resize_uint8(x: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a uint8 image batch (needs PIL unless the size
    already matches)."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    from PIL import Image

    chan = x.shape[3] if x.ndim == 4 else 1
    out = np.empty((len(x), size, size) + ((chan,) if x.ndim == 4 else ()), np.uint8)
    for i, img in enumerate(x):
        pil = Image.fromarray(img.squeeze() if x.ndim == 3 else img)
        out[i] = np.asarray(pil.resize((size, size), Image.BILINEAR)).reshape(out.shape[1:])
    return out


# ----------------------------------------------------------------- datasets


@dataclass
class ArrayDataset:
    """In-memory dataset of normalized NHWC float32 images + int labels."""

    images: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return len(self.images)

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.images[idx], self.labels[idx]


class LazyImageFolder:
    """A streaming image-folder dataset: it holds the file list alone, and
    ``gather`` reads, checks and normalizes one batch of files, on a
    thread pool of ``min(8, cpu_count)`` threads (PIL's decode and the
    file reads release the GIL). ``.npy`` files (pre-resized
    uint8 HWC arrays) are read without PIL. Pair it with
    ``iterate_batches(..., prefetch=N)`` to read ahead of the device."""

    def __init__(self, files: list, image_size: int, data_set: str = "FFHQ"):
        self.files = list(files)
        self.image_size = image_size
        self.data_set = data_set
        n = min(8, os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="decode") if n > 1 else None

    def __len__(self):
        return len(self.files)

    def _read_one(self, path: str) -> np.ndarray:
        return _read_image_uint8(path, self.image_size)

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        paths = [self.files[int(i)] for i in np.asarray(idx)]
        imgs = list((self._pool.map if self._pool is not None else map)(self._read_one, paths))
        out = np.stack(imgs) if imgs else np.empty((0, self.image_size, self.image_size, 3), np.uint8)
        return _normalize(out, self.data_set), np.zeros(len(idx), np.int64)

    def close(self) -> None:
        """Stop the decode threads."""
        if self._pool is not None:
            self._pool.shutdown()


# an FFHQ folder of more files than this streams by default (about 1 GB of
# 64×64 uint8 RGB)
STREAMING_THRESHOLD = 65536


def _split_indices(n: int, seed: int) -> tuple:
    """The reference's random 70/10/20 train/val/test split of ``n`` items."""
    perm = np.random.default_rng(seed).permutation(n)
    n_tr, n_va = int(n * 0.7), int(n * 0.1)
    return perm[:n_tr], perm[n_tr : n_tr + n_va], perm[n_tr + n_va :]


def _split(x: np.ndarray, seed: int) -> tuple:
    zeros = np.zeros(len(x), np.int64)
    return tuple(ArrayDataset(x[s], zeros[s]) for s in _split_indices(len(x), seed))


def get_datasets(config, path: str | None, *, streaming: bool | None = None):
    """``(train, val, test)`` with the reference's split semantics.

    MNIST: val is test, the 10k test set. CIFAR10: the same. FFHQ: a
    random 70/10/20 split of the folder's files. Without usable files
    under ``path`` each falls back to hermetic data: 4096 + 512 rendered
    digits (PIL), 2048 + 256 or 2048 synthetic images. Sets
    ``config.data_variance`` as the JAX package does.

    ``streaming`` (FFHQ with files only): serve the splits as
    :class:`LazyImageFolder` datasets instead of one array in memory; by
    default (None) where the folder holds more than
    ``STREAMING_THRESHOLD`` files.
    """
    ds_name = config.data_set
    if ds_name == "MNIST":
        raw = load_mnist(path) if path else None
        if raw is None:
            tr_x, tr_y = render_digits(4096, config.image_size, config.seed)
            te_x, te_y = render_digits(512, config.image_size, config.seed + 1)
        else:
            tr_x, tr_y, te_x, te_y = raw
            tr_x = _resize_uint8(tr_x, config.image_size)
            te_x = _resize_uint8(te_x, config.image_size)
        config.data_variance = 1
        test = ArrayDataset(_normalize(te_x, ds_name), te_y)
        return ArrayDataset(_normalize(tr_x, ds_name), tr_y), test, test

    if ds_name == "CIFAR10":
        raw = load_cifar10(path) if path else None
        if raw is None:
            tr_x = synthetic_images(2048, config.image_size, config.seed)
            te_x = synthetic_images(256, config.image_size, config.seed + 1)
            tr_y, te_y = np.zeros(len(tr_x), np.int64), np.zeros(len(te_x), np.int64)
        else:
            tr_x, tr_y, te_x, te_y = raw
        config.data_variance = float(np.var(tr_x / 255.0))
        test = ArrayDataset(_normalize(te_x, ds_name), te_y)
        return ArrayDataset(_normalize(tr_x, ds_name), tr_y), test, test

    if ds_name == "FFHQ":
        config.data_variance = 1
        files = list_image_files(path) if path else []
        if not files:
            return _split(_normalize(synthetic_images(2048, config.image_size, config.seed), ds_name), config.seed)
        if streaming is None:
            streaming = len(files) > STREAMING_THRESHOLD
        if streaming:
            return tuple(LazyImageFolder([files[i] for i in s], config.image_size, ds_name)
                         for s in _split_indices(len(files), config.seed))
        return _split(_normalize(load_image_folder(path, config.image_size), ds_name), config.seed)

    raise ValueError(f"unknown data_set {ds_name!r}")


# how long a consumer that stops waits for its prefetch thread to end
PREFETCH_JOIN_S = 5.0


def _prefetched(gen, depth: int):
    """Run ``gen`` on a daemon thread named ``"prefetch"`` that keeps
    ``depth`` items ready, so reading and decoding overlap the consumer's
    work. An exception in ``gen`` is raised in the consumer. A consumer
    that stops, at the end, early (a break, an exception, the generator
    closed or collected) or on ``gen``'s exception, sets the stop event
    and joins the thread before it returns: the thread sees the event
    within 0.1 s of a ``put``, drops what it holds and ends, so none is
    left behind. A thread still blocked inside ``gen`` (a read that does
    not return) after ``PREFETCH_JOIN_S`` is left to end by itself when
    that read returns; being a daemon, it never keeps the process
    alive."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True, name="prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        if thread is not threading.current_thread():  # a collector may finalize us on the worker
            thread.join(PREFETCH_JOIN_S)


def iterate_batches(
    ds, batch_size: int, *, shuffle: bool, seed: int = 0, drop_remainder: bool = False, prefetch: int = 0,
    local_slice: tuple[int, int] | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Numpy batches ``(images, labels)`` of anything with ``__len__`` and
    ``gather(indices)``. ``shuffle`` permutes with
    ``np.random.default_rng(seed)``, the JAX package's order.

    ``prefetch > 0`` gathers that many batches ahead on a thread.
    ``local_slice=(start, stop)`` yields only that part of every batch (a
    process's share, ``parallel.mesh.process_batch_bounds``): every process
    draws the same order and reads only its own files. It needs
    ``drop_remainder``, since a ragged last batch has no such split."""
    if local_slice is not None and not drop_remainder:
        raise ValueError("local_slice needs drop_remainder=True: the ragged last batch has no per-process split")
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)

    def gen():
        for i in range(0, end, batch_size):
            b = idx[i : i + batch_size]
            if local_slice is not None:
                b = b[local_slice[0] : local_slice[1]]
            yield ds.gather(b)

    return _prefetched(gen(), prefetch) if prefetch > 0 else gen()
