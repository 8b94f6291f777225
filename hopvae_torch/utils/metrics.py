"""Metrics: a JSONL logger and the inverse of the input normalization.

Port of ``hopvae_tpu/utils/metrics.py`` without the wandb sink, the
multi-process guard and the PNG grids (those wait for sampling).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from hopvae_torch.data import MNIST_MEAN, MNIST_STD


class MetricLogger:
    """Appends one JSON record per ``log`` call to ``<out_dir>/metrics.jsonl``,
    under the reference's metric names."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._step = 0

    def log(self, metrics: dict, step: int | None = None) -> None:
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
