"""Modern-Hopfield lookup: softmax attention over a learned pattern memory.

Port of ``hopvae_tpu/ops/hopfield.py``. For ``x (..., S, d_in)`` and
``β = 1/√d_in``::

    K   = LN_stored(P)                    # (M, d_in)
    Q   = LN_state(X)                     # (..., S, d_in)
    V   = LN_proj(P) @ W_inᵀ + b_in       # (M, d_in)
    A   = softmax(β · Q Kᵀ, axis=-1)      # (..., S, M)
    out = (A V) @ W_outᵀ + b_out          # (..., S, d_out)

``hopfield_lookup`` is the eager path, the parity anchor of the port;
``hopvae_torch.ops.hopfield_cuda`` folds the same parameters into two
tables and streams them through the hand-written kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LN_EPS = 1e-5


class HopfieldLookup(nn.Module):
    """Parameters of one lookup layer, named as the JAX pytree is.

    ``in_proj``/``out_proj`` are ``nn.Linear`` (weight ``(out, in)``, the
    transpose of the JAX kernel); the three LayerNorms run over ``d_in``.
    """

    def __init__(self, d_in: int, d_out: int, quantity: int, device=None):
        super().__init__()
        self.lookup_weights = nn.Parameter(torch.empty(quantity, d_in, device=device))
        self.in_proj = nn.Linear(d_in, d_in, device=device)
        self.out_proj = nn.Linear(d_in, d_out, device=device)
        self.norm_stored = nn.LayerNorm(d_in, eps=LN_EPS, device=device)
        self.norm_state = nn.LayerNorm(d_in, eps=LN_EPS, device=device)
        self.norm_proj = nn.LayerNorm(d_in, eps=LN_EPS, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX init: patterns ~ N(0, 1), Xavier-uniform projections,
        zero biases, identity LayerNorms."""
        with torch.no_grad():
            self.lookup_weights.normal_(generator=generator)
            for lin in (self.in_proj, self.out_proj):
                fan_out, fan_in = lin.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.zero_()
            for ln in (self.norm_stored, self.norm_state, self.norm_proj):
                ln.reset_parameters()

    @property
    def d_in(self) -> int:
        return self.lookup_weights.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hopfield_lookup(self, x)


def hopfield_lookup(layer: HopfieldLookup, x: torch.Tensor) -> torch.Tensor:
    """Eager lookup of ``x (..., S, d_in)`` through ``layer``."""
    patterns = layer.lookup_weights
    k = layer.norm_stored(patterns)
    q = layer.norm_state(x)
    v = layer.in_proj(layer.norm_proj(patterns))
    beta = 1.0 / math.sqrt(layer.d_in)
    attn = torch.softmax(torch.matmul(q, k.T) * beta, dim=-1)
    return layer.out_proj(torch.matmul(attn, v))
