"""Metrics: a JSONL logger, the inverse of the input normalization and
PNG image grids.

Port of ``hopvae_tpu/utils/metrics.py`` without the wandb sink. :func:`save_image_grid` writes the PNG with
``zlib`` and ``struct`` alone, so a grid needs no PIL.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib

import numpy as np

from hopvae_torch.data import MNIST_MEAN, MNIST_STD


class MetricLogger:
    """Appends one JSON record per ``log`` call to ``<out_dir>/metrics.jsonl``,
    under the reference's metric names. Ranks that share ``out_dir`` write
    through one logger: those built with ``primary=False`` write nothing."""

    def __init__(self, out_dir: str, primary: bool = True):
        self.primary = primary
        if primary:
            os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._step = 0

    def log(self, metrics: dict, step: int | None = None) -> None:
        if not self.primary:
            return
        rec = {"time": time.time()}
        rec.update({k: (float(v) if np.isscalar(v) or getattr(v, "ndim", 1) == 0 else v) for k, v in metrics.items()})
        if step is None:
            step = self._step
            self._step += 1
        rec.setdefault("step", step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def denormalize(x: np.ndarray, data_set: str) -> np.ndarray:
    """Invert the dataset normalization back to [0, 1] for viewing."""
    x = np.asarray(x)
    x = x * MNIST_STD + MNIST_MEAN if data_set == "MNIST" else x + 0.5
    return np.clip(x, 0.0, 1.0)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, arr: np.ndarray) -> None:
    """An 8-bit grayscale ``(H, W)`` or RGB ``(H, W, 3)`` ``uint8`` array as a
    PNG: one IDAT of the rows, each with filter type 0 (none)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 3), got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def save_image_grid(path: str, images: np.ndarray, *, ncol: int = 8) -> None:
    """Tile ``(N, H, W, C)`` images in [0, 1] into a PNG grid, ``ncol``
    images a row, with the JAX package's tiling and ``uint8`` conversion."""
    n, h, w, c = images.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    arr = (grid * 255).astype(np.uint8)
    if c == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr)
