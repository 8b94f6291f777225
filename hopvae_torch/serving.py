"""Serving: reconstruct and encode over a fixed batch shape on the card.

Port of the reconstruct/encode half of ``hopvae_tpu/serving.py``:

- ``InferenceEngine`` builds the model at ``max_batch``, pads ragged
  batches up to it and slices results back. Where the JAX engine
  compiles ahead of time, this one warms up at construction: the first
  call builds the CUDA kernel and launches it, so no request pays that.
- The default is the production setting: the streaming kernel
  (``impl="cuda"``) and bf16 conv stacks. ``impl="torch"``,
  ``compute_dtype=None`` is the f32 parity path.
- ``python -m hopvae_torch.serving --mode reconstruct`` is a batch
  processor over ``.npy`` inputs (image files need PIL) that writes the
  reconstructions as one ``.npy``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.data import MNIST_MEAN, MNIST_STD
from hopvae_torch.models.hopvae import HopVAE
from hopvae_torch.utils.checkpoint import load_msgpack, params_from_jax

OPS = ("reconstruct", "encode")


class InferenceEngine:
    def __init__(
        self,
        config,
        state: dict,
        *,
        max_batch: int = 64,
        impl: str = "cuda",
        compute_dtype: torch.dtype | None = torch.bfloat16,
        device=None,
        ops: tuple = OPS,
    ):
        """``state`` is a ``HopVAE`` state_dict (see
        ``hopvae_torch.utils.checkpoint.params_from_jax``); ``ops`` names
        the entry points to warm up."""
        unknown = [op for op in ops if op not in OPS]
        if unknown:
            raise NotImplementedError(
                f"ops {unknown} are not ported yet (ROADMAP.md, Queue 1); this engine serves {OPS}"
            )
        self.config = config
        self.max_batch = max_batch
        self.ops = tuple(ops)
        self.model = HopVAE(config, impl=impl, compute_dtype=compute_dtype, device=device)
        self.model.load_state_dict(state)
        self.model.eval()
        self.device = self.model.device
        s, c = config.image_size, config.num_channels
        warm = np.zeros((max_batch, s, s, c), np.float32)
        for op in self.ops:
            getattr(self, op)(warm)

    def _pad(self, x: np.ndarray) -> tuple[torch.Tensor, int]:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        if n < self.max_batch:
            x = np.concatenate([x, np.zeros((self.max_batch - n, *x.shape[1:]), x.dtype)])
        return torch.from_numpy(x).to(self.device), n

    def _require(self, op: str) -> None:
        if op not in self.ops:
            raise RuntimeError(f"{op!r} was not in this engine's ops {self.ops}")

    @torch.inference_mode()
    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        """Normalized NHWC batch → reconstructions (unpadded)."""
        self._require("reconstruct")
        xp, n = self._pad(x)
        return self.model.reconstruct(xp)[0][:n].cpu().numpy()

    @torch.inference_mode()
    def encode(self, x: np.ndarray) -> np.ndarray:
        """Normalized NHWC batch → pre-VQ latent tokens ``(B, r², d)``."""
        self._require("encode")
        xp, n = self._pad(x)
        return self.model._encode_to_tokens(xp)[:n].cpu().numpy()


def state_from_checkpoint(path: str) -> dict:
    """A checkpoint → ``HopVAE`` state_dict, on the host: the JAX package's
    native ``.msgpack``, or else the ``.pt`` that ``hopvae_torch.train``
    writes (its model state; the optimizer's is dropped)."""
    if path.endswith(".msgpack"):
        return params_from_jax(load_msgpack(path))
    return torch.load(path, map_location="cpu")["model"]


# ----------------------------------------------------------------- CLI


def _load_images(paths, config) -> np.ndarray:
    s, c = config.image_size, config.num_channels
    out = []
    for p in paths:
        if p.endswith(".npy"):
            # float arrays must already be model-normalized HWC; uint8
            # arrays are normalized like image files
            a = np.load(p)
            if a.dtype == np.uint8:
                a = a.astype(np.float32) / 255.0
                a = (a - MNIST_MEAN) / MNIST_STD if config.data_set == "MNIST" else a - 0.5
            a = np.asarray(a, np.float32)
            if a.shape == (s, s) and c == 1:
                a = a[..., None]
            if a.shape != (s, s, c):
                raise ValueError(
                    f"{p}: expected shape ({s}, {s}, {c}) (or ({s}, {s}) for 1-channel), got {a.shape}"
                )
            out.append(a)
            continue
        from PIL import Image

        img = Image.open(p).convert("L" if c == 1 else "RGB").resize((s, s), Image.BILINEAR)
        a = np.asarray(img, np.float32) / 255.0
        a = (a - MNIST_MEAN) / MNIST_STD if config.data_set == "MNIST" else a - 0.5
        out.append(a[..., None] if c == 1 else a)
    return np.stack(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batch reconstruction of image/.npy files")
    parser.add_argument("--config", default="mnist_28")
    parser.add_argument("--checkpoint", required=True,
                        help="the JAX package's native .msgpack, or a .pt written by hopvae_torch.train")
    parser.add_argument("--mode", choices=("reconstruct",), default="reconstruct")
    parser.add_argument("--out", default="served")
    parser.add_argument("--max-batch", type=int, default=256,
                        help="engine batch size cap; more inputs are chunked through it")
    parser.add_argument("--impl", default="cuda", choices=("cuda", "torch"))
    parser.add_argument("--compute-dtype", default="bfloat16", choices=("float32", "bfloat16"))
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config key (repeatable)")
    parser.add_argument("inputs", nargs="+", help="image/.npy files")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    try:
        apply_overrides(config, args.set, config_name=args.config)
    except ValueError as e:
        parser.error(str(e))
    if not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")
    x = _load_images(args.inputs, config)
    engine = InferenceEngine(
        config, state_from_checkpoint(args.checkpoint),
        max_batch=min(len(x), args.max_batch), impl=args.impl,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
        device=args.device, ops=("reconstruct",),
    )
    y = np.concatenate(
        [engine.reconstruct(x[i : i + engine.max_batch]) for i in range(0, len(x), engine.max_batch)]
    )
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "reconstructions.npy")
    np.save(path, y)
    print(f"wrote {path} ({len(y)} images, recon MSE {float(np.mean((y - x) ** 2)):.6f})")


if __name__ == "__main__":
    main()
