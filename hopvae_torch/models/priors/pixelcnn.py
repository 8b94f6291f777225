"""PixelCNN autoregressive prior over the latent level grid.

Port of ``hopvae_tpu/models/priors/pixelcnn.py``: a masked-conv PixelCNN
(van den Oord et al. 2016) whose causality is raster order over the
pixels with the channel innermost (channel c of a pixel sees the
channels before it):

- a 7×7 mask-A conv in, ``prior_num_res_blocks`` (4) residual pairs of a
  3×3 and a 1×1 mask-B conv, and two 1×1 mask-B heads, the last with
  ``C·L`` outputs in channel-major order; ``prior_num_filters`` (96)
  features split into ``index_dim`` groups (``_group_mask``);
- ``forward(grid)``: levels ``(B, r, r, C)`` → logits ``(B, r, r, C, L)``
  on the input normalized as ``grid / (L-1) · 2 - 1``;
- ``sample``: the column-incremental sampler (``pixelcnn_sample.py``);
  ``reconstruct``: the argmax of ``forward``; ``interpolate``: ``(x+y)/2``.

Each conv's ``weight`` is OIHW and its causality mask a non-persistent
buffer (JAX keeps the mask as a leaf under ``stop_gradient``, so Adam
gives it zero updates; here it is no parameter at all). Parameters keep
the JAX names (``conv_in``, ``res.<i>.conv_a``, ``res.<i>.conv_b``,
``conv_out1``, ``conv_out2``), so the bridge maps them one to one.

Every conv and matmul of the prior runs in full f32, TF32 off, whatever
the global flags say: JAX runs them at ``Precision.HIGHEST`` and never
casts the prior to bf16, and normalized levels are not exact in TF32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hopvae_torch.models.priors.pixelcnn_sample import ColumnSampler
from hopvae_torch.ops.conv import conv2d, full_f32

PIXELCNN_KEYS = frozenset(("conv_in", "res", "conv_out1", "conv_out2"))


def _group_mask(kh: int, kw: int, c_in: int, c_out: int, n_groups: int, *, mask_type: str) -> np.ndarray:
    """Binary mask ``(kh, kw, c_in, c_out)`` (HWIO) of raster and channel
    causality: rows above the center and columns left of it in the center
    row are visible; at the center, input group ``gi`` feeds output group
    ``go`` iff ``gi < go`` (mask A) or ``gi <= go`` (mask B), the groups
    being contiguous splits of the channels."""
    m = np.zeros((kh, kw, c_in, c_out), np.float32)
    cy, cx = kh // 2, kw // 2
    m[:cy] = 1.0
    m[cy, :cx] = 1.0
    gi = np.arange(c_in) * n_groups // c_in
    go = np.arange(c_out) * n_groups // c_out
    if mask_type == "A":
        center = (gi[:, None] < go[None, :]).astype(np.float32)
    else:
        center = (gi[:, None] <= go[None, :]).astype(np.float32)
    m[cy, cx] = center
    return m


class MaskedConv2d(nn.Module):
    """A square conv whose weight is multiplied by a fixed causality mask,
    padded to keep the grid's size; weight and bias uniform in
    ``±1/sqrt(fan_in)`` (JAX's distribution, not its bits)."""

    def __init__(self, k: int, c_in: int, c_out: int, n_groups: int, mask_type: str, device=None):
        super().__init__()
        bound = 1.0 / np.sqrt(c_in * k * k)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k, device=device).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(c_out, device=device).uniform_(-bound, bound))
        mask = _group_mask(k, k, c_in, c_out, n_groups, mask_type=mask_type).transpose(3, 2, 0, 1)  # OIHW
        self.register_buffer("mask", torch.from_numpy(np.ascontiguousarray(mask)).to(device), persistent=False)

    def masked_weight(self) -> torch.Tensor:
        return self.weight * self.mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW ``x`` → NCHW, f32 without TF32."""
        k = self.weight.shape[-1]
        return conv2d(x, self.masked_weight(), self.bias, padding=k // 2, full_f32=True)


class ResBlock(nn.Module):
    def __init__(self, f: int, n_groups: int, device=None):
        super().__init__()
        self.conv_a = MaskedConv2d(3, f, f, n_groups, "B", device)
        self.conv_b = MaskedConv2d(1, f, f, n_groups, "B", device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.conv_b(F.relu(self.conv_a(F.relu(h))))


class PixelCNNPrior(nn.Module):
    """Masked-conv PixelCNN over a ``(B, r, r, index_dim)`` level grid."""

    has_params = True

    def __init__(self, config, device=None):
        super().__init__()
        self.index_dim = c = config.index_dim
        self.representation_dim = config.representation_dim
        self.num_levels = lvl = config.num_levels
        self.features = f = int(getattr(config, "prior_num_filters", 96))
        self.n_res = int(getattr(config, "prior_num_res_blocks", 4))
        if f % c:
            raise ValueError(f"prior_num_filters={f} must split into index_dim={c} channel groups")
        self.conv_in = MaskedConv2d(7, c, f, c, "A", device)
        self.res = nn.ModuleList(ResBlock(f, c, device) for _ in range(self.n_res))
        self.conv_out1 = MaskedConv2d(1, f, f, c, "B", device)
        self.conv_out2 = MaskedConv2d(1, f, c * lvl, c, "B", device)
        self._samplers = {}  # (mode, batch) -> ColumnSampler, graphs captured on the card

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Level grid ``(B, r, r, C)`` of floats in ``[0, L-1]`` → logits
        ``(B, r, r, C, L)``, teacher-forced."""
        b, r = grid.shape[0], self.representation_dim
        x = grid.float() / (self.num_levels - 1) * 2.0 - 1.0
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for block in self.res:
            h = block(h)
        h = self.conv_out1(F.relu(h))
        logits = self.conv_out2(F.relu(h))
        return logits.permute(0, 2, 3, 1).reshape(b, r, r, self.index_dim, self.num_levels)

    def reconstruct(self, grid: torch.Tensor) -> torch.Tensor:
        """Teacher-forced denoise: the argmax re-prediction per position."""
        return torch.argmax(self.forward(grid), dim=-1).to(grid.dtype)

    def interpolate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (x + y) / 2

    # ------------------------------------------------------------ sample

    def _sampler(self, mode: str, b: int, eager: bool) -> ColumnSampler:
        """The sampler for (``mode``, ``b``): on the card, unless ``eager``,
        the one captured at the first call of that key and kept (its taps
        are refreshed from the parameters at every run); else a fresh one
        whose step runs eagerly."""
        if not self.conv_in.weight.is_cuda or eager:
            return ColumnSampler(self, b, mode)
        sampler = self._samplers.get((mode, b))
        if sampler is None:
            sampler = self._samplers[(mode, b)] = ColumnSampler(self, b, mode)
            sampler.capture()
        return sampler

    def sample(self, num_samples: int = 1, generator: torch.Generator | None = None, device=None, *,
               _gumbel: torch.Tensor | None = None, eager: bool = False) -> torch.Tensor:
        """``num_samples`` grids ``(B, r, r, C)`` of float levels, drawn pixel
        by pixel in raster order, channel by channel: ``argmax(logits + g)``
        with ``g = -log(-log(u))``, ``u`` uniform on ``[tiny, 1)`` (the form
        of ``jax.random.categorical``). The noise of each row of pixels is
        drawn from ``generator`` (on the prior's device) as one ``(r, C, B,
        L)`` block before its steps run; ``_gumbel`` ``(r², C, B, L)``
        replaces those draws (the tests feed JAX and the port the same
        noise). ``device``, if given, must be the prior's. ``eager`` skips
        the CUDA graphs."""
        dev = self.conv_in.weight.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"the prior's parameters are on {dev}, not {device}")
        r, c, lvl = self.representation_dim, self.index_dim, self.num_levels
        if _gumbel is not None:
            if not isinstance(_gumbel, torch.Tensor):
                _gumbel = torch.from_numpy(np.array(_gumbel, np.float32))
            _gumbel = _gumbel.to(device=dev, dtype=torch.float32)
            if tuple(_gumbel.shape) != (r * r, c, num_samples, lvl):
                raise ValueError(f"_gumbel must be (r², C, B, L) = {(r * r, c, num_samples, lvl)}, "
                                 f"got {tuple(_gumbel.shape)}")
        with torch.inference_mode(), full_f32():
            sampler = self._sampler("sample", num_samples, eager)
            return sampler.run(generator=generator, gumbel=_gumbel).clone()  # the sampler's buffer

    def step_logits(self, grid: torch.Tensor, *, eager: bool = False) -> torch.Tensor:
        """Teacher-forced logits ``(B, r, r, C, L)`` through the sampler's own
        step: at each pixel the tap partials, then the center chain of each
        channel with the grid's earlier channels set, as ``sample`` computes
        them before its draws. It must match :meth:`forward` on ``grid``."""
        dev = self.conv_in.weight.device
        with torch.inference_mode(), full_f32():
            sampler = self._sampler("logits", grid.shape[0], eager)
            out = sampler.run(grid=grid.to(device=dev, dtype=torch.float32))
        r, c = self.representation_dim, self.index_dim
        return out.reshape(r, r, c, grid.shape[0], self.num_levels).permute(3, 0, 1, 2, 4).clone()
