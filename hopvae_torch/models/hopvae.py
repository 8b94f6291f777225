"""HopVAE: a VQ-VAE with a modern-Hopfield bottleneck, in PyTorch.

Port of ``hopvae_tpu/models/hopvae.py``:

- ``forward``: encoder → pre-VQ 1×1 conv → Hopfield retrieval →
  embedding→index lookup → sigmoid → straight-through round to
  ``num_levels`` → index→embedding round-trip, scored only by the aux
  loss ``mean((r - e)**2)``; the decoder sees the pre-quantization
  retrieval ``e``. With ``fit_prior`` it adds the prior's teacher-forced
  cross-entropy in bits over the quantized grid, its gradient stopped.
- ``prior``: ``get_prior(config)``, the PixelCNN, Transformer or Normal
  prior.
- ``sample``: the prior's grid (the PixelCNN's column-incremental
  sampler, the Transformer prior's KV-cached decode, or the Normal
  prior's uniform levels), ``/ (L-1)``, the index→embedding lookup and
  the decoder (:meth:`HopVAE.decode_grid`).
- ``interpolate``: the average of two batches' latents through the
  ``hopfield`` and ``embedding_to_index`` lookups, a relu-pair clamp, the
  straight-through round, ``prior.reconstruct`` and the decode; no
  gradient flows out.
- ``post_vq_conv`` parameters exist but are never applied (kept so
  checkpoints load as they are).

Public tensors are NHWC, as in the JAX package; the conv stacks run on
the NCHW view of that memory (channels-last), and the latent grid is
flattened to ``(B, r², d)`` tokens for the lookups.

``forward`` is differentiable on both paths: with ``impl="cuda"`` the
backward runs through the streaming kernels (``hopvae_torch.train``
trains with it). Under a mesh that splits the patterns over ranks
(``pattern_group``, set by the trainer) every lookup runs over this
rank's pattern rows, the kernels or, on the CPU, their plain versions.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F
from torch import nn

from hopvae_torch.models.layers import Decoder, Encoder
from hopvae_torch.models.priors import get_prior
from hopvae_torch.ops.bottleneck import IMPLS, LAYERS, hopfield_bottleneck
from hopvae_torch.ops.conv import conv2d
from hopvae_torch.ops.hopfield import HopfieldLookup, hopfield_lookup
from hopvae_torch.ops.hopfield_cuda import hopfield_lookup_stream
from hopvae_torch.ops.ste import straight_through_round

PRIOR = "prior."


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for the card without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (with impl='torch') to run on the CPU")
    return device


class HopVAE(nn.Module):
    def __init__(self, config, impl: str = "cuda", compute_dtype: torch.dtype | None = None, device=None):
        """``compute_dtype=torch.bfloat16`` runs both conv stacks in bf16
        from the f32 parameters (JAX's ``_cast``); the bottleneck and the
        losses stay f32. ``impl="cuda"`` needs a CUDA device."""
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.device = resolve_device(device)
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError(f"impl='cuda' runs on a CUDA device, got {self.device}; use impl='torch'")
        self.config = config
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.num_levels = config.num_levels
        self.representation_dim = config.representation_dim
        self.embedding_dim = d = config.embedding_dim
        self.index_dim = di = config.index_dim
        m, dev = config.num_embeddings, self.device
        h, nres, hres = config.num_hiddens, config.num_residual_layers, config.num_residual_hiddens
        self.encoder = Encoder(config.num_channels, h, nres, hres, dev)
        self.pre_vq_conv = nn.Conv2d(h, d, 1, device=dev)
        self.hopfield = HopfieldLookup(d, d, m, dev)
        self.embedding_to_index = HopfieldLookup(d, di, m, dev)
        self.index_to_embedding = HopfieldLookup(di, d, m, dev)
        self.post_vq_conv = nn.Conv2d(di, di, 1, device=dev)  # never applied
        self.decoder = Decoder(d, config.num_channels, h, nres, hres, dev)
        self.prior = get_prior(config, device=dev)
        # set by a Trainer whose mesh splits the patterns over a model group
        # of more than one rank (parallel.mesh): every lookup then runs over
        # this rank's pattern rows and merges with the group's
        self.pattern_group = None

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _encode_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Image ``(B, H, W, C)`` → pre-VQ latent tokens ``(B, r², d)``, f32."""
        cfg = self.config
        expected = (cfg.image_size, cfg.image_size, cfg.num_channels)
        if x.dim() != 4 or tuple(x.shape[1:]) != expected:
            hint = ""
            if x.dim() == 4 and tuple(x.shape[1:]) == (cfg.num_channels, cfg.image_size, cfg.image_size):
                hint = " — input looks NCHW; transpose with x.permute(0, 2, 3, 1)"
            raise ValueError(
                f"expected NHWC input of shape (B, {expected[0]}, {expected[1]}, "
                f"{expected[2]}) for config image_size={cfg.image_size}, got "
                f"{tuple(x.shape)}{hint}"
            )
        z = self.encoder(self._compute(x).permute(0, 3, 1, 2))
        z = conv2d(z, self.pre_vq_conv.weight, self.pre_vq_conv.bias)
        b = z.shape[0]
        return z.permute(0, 2, 3, 1).float().reshape(b, self.representation_dim**2, self.embedding_dim)

    def _tokens_to_image(self, z_embeddings: torch.Tensor) -> torch.Tensor:
        """Latent tokens ``(B, r², d)`` → decoded image ``(B, H, W, C)``, f32."""
        b, r = z_embeddings.shape[0], self.representation_dim
        grid = self._compute(z_embeddings).reshape(b, r, r, self.embedding_dim)
        out = self.decoder(grid.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1).float()

    def bottleneck_layers(self) -> dict:
        return {name: getattr(self, name) for name in LAYERS}

    def backbone(self, x: torch.Tensor):
        """``(x_recon, zq, aux_loss)``: the reconstruction, the quantized
        grid ``(B, r², index_dim)`` and the embedding round-trip loss."""
        z = self._encode_to_tokens(x)
        e, zq, r = hopfield_bottleneck(self.bottleneck_layers(), z, self.num_levels, impl=self.impl,
                                       group=self.pattern_group)
        return self._tokens_to_image(e), zq, torch.mean((r - e) ** 2)

    def prior_bits(self, zq: torch.Tensor) -> torch.Tensor:
        """The prior's teacher-forced cross-entropy in bits, averaged over
        the grid ``zq``, whose gradient is stopped."""
        b, r = zq.shape[0], self.representation_dim
        grid = zq.detach().reshape(b, r, r, self.index_dim)
        logp = F.log_softmax(self.prior(grid), dim=-1)
        ce = -torch.gather(logp, -1, grid.to(torch.int64)[..., None])[..., 0]
        return torch.mean(ce) * math.log2(math.e)  # nats → bits

    def forward(self, x: torch.Tensor, *, fit_prior: bool = False):
        """``(x_recon, aux_loss)`` for a normalized NHWC batch; with
        ``fit_prior`` the aux loss also holds the prior's bits."""
        x_recon, zq, aux = self.backbone(x)
        if fit_prior:
            return x_recon, self.prior_bits(zq) + aux
        return x_recon, aux

    def reconstruct(self, x: torch.Tensor):
        return self.forward(x)

    def _lookup(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One lookup of the bottleneck outside ``backbone``, by ``impl``:
        the streaming kernels (K1 on the card) or the eager lookup; over
        the pattern shards where ``pattern_group`` is set."""
        layer = getattr(self, name)
        if self.impl == "cuda" or self.pattern_group is not None:
            return hopfield_lookup_stream(layer, x, self.impl, self.pattern_group)
        return hopfield_lookup(layer, x)

    def decode_grid(self, grid: torch.Tensor) -> torch.Tensor:
        """A level grid ``(B, r, r, index_dim)`` of levels in ``[0, L-1]`` →
        images ``(B, H, W, C)``: ``grid / (L-1)``, the ``index_to_embedding``
        lookup and the decoder (JAX's ``sample`` and ``interpolate`` after
        their prior step)."""
        b, r = grid.shape[0], self.representation_dim
        tokens = (grid / (self.num_levels - 1)).reshape(b, r * r, self.index_dim)
        return self._tokens_to_image(self._lookup("index_to_embedding", tokens))

    @torch.no_grad()
    def sample(self, num_samples: int = 1, generator: torch.Generator | None = None) -> torch.Tensor:
        """``num_samples`` unconditional images from the prior's grid, drawn
        with ``generator`` (on the model's device), then decoded: one
        ``index_to_embedding`` lookup (K1 on the card) and the decoder."""
        grid = self.prior.sample(num_samples, generator=generator, device=self.device)
        return self.decode_grid(grid.to(torch.int32).float())

    @torch.no_grad()
    def interpolation_grid(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The level grid ``(B, r, r, index_dim)`` that :meth:`interpolate`
        decodes, for two batches of one shape: the average of their
        latents through the ``hopfield`` and ``embedding_to_index`` lookups,
        clamped to ``[0, 1]`` by a relu pair (not the forward's sigmoid),
        rounded to ``L`` levels, then ``prior.reconstruct`` (the identity
        under ``prior="None"``, the teacher-forced argmax under the
        PixelCNN and Transformer priors)."""
        b, r = x.shape[0], self.representation_dim
        z = (self._encode_to_tokens(x) + self._encode_to_tokens(y)) / 2
        zi = self._lookup("embedding_to_index", self._lookup("hopfield", z))
        zi = 1.0 - F.relu(1.0 - F.relu(zi))
        zq = straight_through_round(zi * (self.num_levels - 1))
        return self.prior.reconstruct(zq.reshape(b, r, r, self.index_dim))

    @torch.no_grad()
    def interpolate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Latent-space interpolation of two normalized NHWC batches: the
        decode of :meth:`interpolation_grid`; ``x`` unchanged where the
        shapes differ, as in the JAX package. No gradient flows out."""
        if x.shape != y.shape:
            return x
        return self.decode_grid(self.interpolation_grid(x, y))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``, lenient on the prior alone, as the
        JAX package's ``lenient_merge`` is: a stored ``prior.*`` tensor loads
        where this model's prior has one of that name and shape; every
        other prior tensor keeps its fresh initialization, stored ones with
        no counterpart are ignored, and a warning lists them. A checkpoint
        of another prior family (or none) thus leaves the prior fresh, and
        one of the same family at another width keeps the leaves whose shape
        still matches. Everything else loads as ``strict`` says."""
        state = dict(state_dict)
        fresh = {k: v for k, v in self.state_dict().items() if k.startswith(PRIOR)}
        stored = {k: state.pop(k) for k in list(state) if k.startswith(PRIOR)}
        if fresh:
            dropped = [f"{k} (not in checkpoint)" for k in fresh if k not in stored]
            for k, v in stored.items():
                if k not in fresh:
                    dropped.append(f"{k} (in checkpoint, no such param)")
                elif tuple(v.shape) != tuple(fresh[k].shape):
                    dropped.append(f"{k} (shape {tuple(v.shape)} != {tuple(fresh[k].shape)})")
            state.update(fresh)
            state.update({k: v for k, v in stored.items() if k in fresh and tuple(v.shape) == tuple(fresh[k].shape)})
            if dropped:
                shown = ", ".join(dropped[:8]) + (" …" if len(dropped) > 8 else "")
                print(f"warning: lenient load: {len(dropped)} prior tensor(s) kept the prior's fresh "
                      f"initialization or were ignored: {shown}", file=sys.stderr)
        elif stored:
            print(
                f"warning: lenient load: the checkpoint's prior subtree ({len(stored)} tensors) does not "
                f"match this model's prior={self.config.prior!r} (no tensors); dropped it",
                file=sys.stderr,
            )
        return super().load_state_dict(state, strict=strict, assign=assign)
