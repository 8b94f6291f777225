"""Serving: reconstruct, encode, sample and interpolate on the card.

Port of ``hopvae_tpu/serving.py``:

- ``InferenceEngine`` builds the model at ``max_batch``, pads ragged
  batches up to it and slices results back; ``sample`` draws
  ``n_sample`` images from a seed. Where the JAX engine compiles ahead of
  time, this one warms up the ops it serves at construction: the first
  call builds the CUDA kernels and launches them, so no request pays
  that.
- The default is the production setting: the streaming kernels
  (``impl="cuda"``) and bf16 conv stacks. ``impl="torch"``,
  ``compute_dtype=None`` is the f32 parity path.
- ``python -m hopvae_torch.serving --mode reconstruct|sample|interpolate``
  is a batch processor over ``.npy`` inputs (image files need PIL) that
  writes a PNG grid (``reconstructions.png``, ``samples.png`` or
  ``interpolations.png``) and the images as ``.npy`` beside it.
- ``sample`` draws from the config's prior: under ``prior=PixelCNN`` its
  column-incremental sampler, under ``prior=Transformer`` its KV-cached
  decode, whose CUDA graphs the warm-up captures, so no request pays for
  them. An engine serves all four ops by default, as JAX's does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.data import MNIST_MEAN, MNIST_STD
from hopvae_torch.models.hopvae import HopVAE
from hopvae_torch.utils.checkpoint import checkpoint_state, load_reference_checkpoint
from hopvae_torch.utils.metrics import denormalize, save_image_grid
from hopvae_torch.utils.tracing import span

OPS = ("reconstruct", "encode", "sample", "interpolate")
GRIDS = {"reconstruct": "reconstructions", "sample": "samples", "interpolate": "interpolations"}


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
        n_sample: int = 16,
        ops: tuple = OPS,
    ):
        """``state`` is a ``HopVAE`` state_dict (see
        ``hopvae_torch.utils.checkpoint.params_from_jax``); ``ops`` names
        the entry points to serve (all four by default), each warmed up
        here; ``n_sample`` is the number of images a ``sample`` call draws."""
        unknown = [op for op in ops if op not in OPS]
        if unknown:
            raise ValueError(f"unknown ops {unknown}; this engine serves {OPS}")
        self.config = config
        self.max_batch = max_batch
        self.n_sample = n_sample
        self.ops = tuple(ops)
        self.model = HopVAE(config, impl=impl, compute_dtype=compute_dtype, device=device)
        self.model.load_state_dict(state)
        self.model.eval()
        self.device = self.model.device
        s, c = config.image_size, config.num_channels
        warm = np.zeros((max_batch, s, s, c), np.float32)
        for op in self.ops:
            with span("engine.warmup"):
                if op == "sample":
                    self.sample(0)
                elif op == "interpolate":
                    self.interpolate(warm, warm)
                else:
                    getattr(self, op)(warm)

    def _pad(self, x: np.ndarray) -> tuple[torch.Tensor, int]:
        with span("engine.input"):
            x = np.asarray(x, np.float32)
            n = x.shape[0]
            if n > self.max_batch:
                raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
            if n < self.max_batch:
                x = np.concatenate([x, np.zeros((self.max_batch - n, *x.shape[1:]), x.dtype)])
            return torch.from_numpy(x).to(self.device), n

    @staticmethod
    def _output(y: torch.Tensor) -> np.ndarray:
        with span("engine.output"):
            return y.cpu().numpy()

    def _require(self, op: str) -> None:
        if op not in self.ops:
            raise RuntimeError(f"{op!r} was not in this engine's ops {self.ops}")

    @torch.inference_mode()
    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        """Normalized NHWC batch → reconstructions (unpadded)."""
        self._require("reconstruct")
        xp, n = self._pad(x)
        with span("engine.forward"):
            y = self.model.reconstruct(xp)[0]
        return self._output(y[:n])

    @torch.inference_mode()
    def encode(self, x: np.ndarray) -> np.ndarray:
        """Normalized NHWC batch → pre-VQ latent tokens ``(B, r², d)``."""
        self._require("encode")
        xp, n = self._pad(x)
        with span("engine.forward"):
            y = self.model._encode_to_tokens(xp)
        return self._output(y[:n])

    @torch.inference_mode()
    def sample(self, seed: int = 0) -> np.ndarray:
        """``n_sample`` unconditional images, drawn from a generator on the
        engine's device seeded with ``seed`` (torch's draws, not JAX's)."""
        self._require("sample")
        with span("engine.forward"):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            y = self.model.sample(self.n_sample, generator=gen)
        return self._output(y)

    @torch.inference_mode()
    def interpolate(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Pairwise latent-space interpolation of two normalized NHWC
        batches of equal size (unpadded)."""
        self._require("interpolate")
        xp, n = self._pad(x)
        yp, m = self._pad(y)
        if n != m:
            raise ValueError(f"interpolate needs equal batch sizes, got {n} and {m}")
        with span("engine.forward"):
            y = self.model.interpolate(xp, yp)
        return self._output(y[:n])


def state_from_checkpoint(path: str) -> dict:
    """A checkpoint → ``HopVAE`` state_dict, on the host: the JAX package's
    native ``.msgpack``, the ``.pt`` that ``hopvae_torch.train`` writes
    (its model state; the optimizer's is dropped), or the reference's
    torch ``state_dict`` under the port's names. Nothing is merged: load
    it leniently with ``load_reference_checkpoint``."""
    return checkpoint_state(path)[0]


def served_state(config, path: str) -> dict:
    """The state the serving CLI serves: a fresh model of ``config`` on the
    host, seeded with ``config.seed``, with the checkpoint at ``path``
    loaded into it by ``load_reference_checkpoint`` (JAX's serving loads
    the same way into ``model.init``)."""
    torch.manual_seed(config.seed)
    model = HopVAE(config, impl="torch", device="cpu")
    load_reference_checkpoint(model, path)
    return model.state_dict()


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
    parser = argparse.ArgumentParser(description="Batch inference over image/.npy files")
    parser.add_argument("--config", default="mnist_28")
    parser.add_argument("--checkpoint", required=True,
                        help="the JAX package's native .msgpack, a .pt written by hopvae_torch.train, or the "
                             "reference's torch state_dict (.ckpt); loaded leniently")
    parser.add_argument("--mode", choices=("reconstruct", "sample", "interpolate"), default="reconstruct")
    parser.add_argument("--out", default="served")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-sample", type=int, default=16)
    parser.add_argument("--max-batch", type=int, default=256,
                        help="engine batch size cap; more inputs (or pairs) are chunked through it")
    parser.add_argument("--impl", default="cuda", choices=("cuda", "torch"))
    parser.add_argument("--compute-dtype", default="bfloat16", choices=("float32", "bfloat16"))
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config key (repeatable)")
    parser.add_argument("inputs", nargs="*",
                        help="image/.npy files (reconstruct; interpolate pairs the first half with the second)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    try:
        apply_overrides(config, args.set, config_name=args.config)
    except ValueError as e:
        parser.error(str(e))
    if not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")
    # the input counts are checked before the engine builds and warms up
    if args.mode == "interpolate" and (len(args.inputs) < 2 or len(args.inputs) % 2):
        parser.error("interpolate mode needs an even number (≥2) of input files")
    if args.mode == "reconstruct" and not args.inputs:
        parser.error("reconstruct mode needs input files")
    x = _load_images(args.inputs, config) if args.mode != "sample" else None
    batch = {"reconstruct": len(args.inputs), "interpolate": len(args.inputs) // 2, "sample": 1}[args.mode]
    engine = InferenceEngine(
        config, served_state(config, args.checkpoint),
        max_batch=min(batch, args.max_batch), impl=args.impl,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
        device=args.device, n_sample=args.n_sample, ops=(args.mode,),
    )
    step = engine.max_batch
    if args.mode == "reconstruct":
        y = np.concatenate([engine.reconstruct(x[i : i + step]) for i in range(0, len(x), step)])
        note = f"recon MSE {float(np.mean((y - x) ** 2)):.6f}"
    elif args.mode == "interpolate":
        first, second = x[: batch], x[batch:]
        y = np.concatenate([engine.interpolate(first[i : i + step], second[i : i + step])
                            for i in range(0, batch, step)])
        note = "interpolations"
    else:
        y = engine.sample(args.seed)
        note = f"samples, seed {args.seed}"
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, GRIDS[args.mode])
    save_image_grid(f"{stem}.png", denormalize(y, config.data_set))
    np.save(f"{stem}.npy", y)
    print(f"wrote {stem}.png and {stem}.npy ({len(y)} images, {note})")


if __name__ == "__main__":
    main()
