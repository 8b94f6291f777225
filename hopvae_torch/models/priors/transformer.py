"""Causal-Transformer prior over the latent level grid.

Port of the training half of ``hopvae_tpu/models/priors/transformer.py``:
the config rules of ``__init__``, the teacher-forced ``forward`` and the
protocol's ``reconstruct`` and ``interpolate``. The AR order is raster
over ``(i, j)`` with the channel innermost, so position ``p = (i·r + j)·C
+ c`` and ``S = r²·C``.

- The input is shifted right: BOS at position 0, then the embeddings of
  tokens ``0 … S-2``, plus the position embedding.
- Pre-LN blocks: causal self-attention through the ``prior_attn``
  backend (``ops/attention.py``), then an MLP with tanh-approximated GELU
  (``jax.nn.gelu``'s default). Grouped-query attention projects K and V
  to ``prior_kv_heads`` heads and repeats each in place over its group
  (``jnp.repeat``, that is ``repeat_interleave``).
- ``prior_attn="auto"`` takes dense below S = 512, else flash for head
  widths the kernels take (≤ 128 or a multiple of 128), else blocked.
  Flash on CUDA tensors runs the hand-written kernels (K5).

Parameters keep the JAX names (``tok_emb``, ``bos``, ``pos_emb``,
``blocks.<i>.{ln1, qkv, out, ln2, mlp_in, mlp_out}``, ``ln_f``, ``head``),
with Linear weights ``(out, in)``. The head count is a reshape over the
same parameter shapes, so it must be the one the weights were trained
with. Not ported yet (ROADMAP.md, Queue 1 item 6): the KV-cached decode
(``sample``, ``decode_logits``) with its int8/int4 caches.
"""

from __future__ import annotations

import sys
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from hopvae_torch.ops.attention import blocked_causal_attention, dense_causal_attention, flash_causal_attention

LN_EPS = 1e-5
# from this sequence length "auto" leaves the dense backend, whose
# (B, heads, S, S) scores are saved per layer for the backward
_AUTO_STREAMING_SEQ = 512
_DECODE_NOT_PORTED = "the KV-cached decode is not ported yet (ROADMAP.md, Queue 1 item 6)"
CACHE_DTYPES = {"bfloat16": "bfloat16", "bf16": "bfloat16", "int8": "int8", "int4": "int4",
                "float32": "float32", "f32": "float32"}


def _init_linear(layer: nn.Linear) -> None:
    nn.init.normal_(layer.weight, std=0.02)
    nn.init.zeros_(layer.bias)


class Block(nn.Module):
    """One pre-LN block: causal self-attention, then the MLP."""

    def __init__(self, d: int, heads: int, kv_heads: int, attn: str, q_block: int, kv_block: int, device=None):
        super().__init__()
        self.heads, self.kv_heads, self.attn = heads, kv_heads, attn
        self.q_block, self.kv_block = q_block, kv_block
        self.kv_width = kv_heads * (d // heads)
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.qkv = nn.Linear(d, d + 2 * self.kv_width, device=device)
        self.out = nn.Linear(d, d, device=device)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.mlp_in = nn.Linear(d, 4 * d, device=device)
        self.mlp_out = nn.Linear(4 * d, d, device=device)
        for layer in (self.qkv, self.out, self.mlp_in, self.mlp_out):
            _init_linear(layer)

    def attention(self, q, k, v):
        if self.attn == "blocked":
            return blocked_causal_attention(q, k, v, q_block=self.q_block, kv_block=self.kv_block)
        if self.attn == "flash":
            return flash_causal_attention(q, k, v)
        return dense_causal_attention(q, k, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h, kv, kvw = self.heads, self.kv_heads, self.kv_width
        dh = d // h
        qkv = self.qkv(self.ln1(x))
        # views of the projection: the kernels read them with their strides
        q = qkv[..., :d].reshape(b, s, h, dh)
        k = qkv[..., d : d + kvw].reshape(b, s, kv, dh)
        v = qkv[..., d + kvw :].reshape(b, s, kv, dh)
        if kv != h:  # each KV head serves its group of query heads in place
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        x = x + self.out(self.attention(q, k, v).reshape(b, s, d))
        z = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(z)


class TransformerPrior(nn.Module):
    """Decoder-only transformer over a ``(B, r, r, index_dim)`` level grid."""

    has_params = True

    def __init__(self, config, device=None):
        super().__init__()
        self.index_dim = config.index_dim
        self.representation_dim = config.representation_dim
        self.num_levels = config.num_levels
        self.d = d = getattr(config, "prior_d_model", 128)
        self.heads = getattr(config, "prior_heads", 4)
        self.n_layers = getattr(config, "prior_layers", 4)
        if d % self.heads:
            raise ValueError(f"prior_d_model={d} must split into prior_heads={self.heads}")
        self.kv_heads = int(getattr(config, "prior_kv_heads", self.heads))
        if not (1 <= self.kv_heads <= self.heads) or self.heads % self.kv_heads:
            raise ValueError(f"prior_kv_heads={self.kv_heads} must divide prior_heads={self.heads}")
        dh = d // self.heads
        if self.kv_heads < self.heads and dh < 128:
            # the JAX package's rule, measured on its TPU (a cache narrower
            # than one 128-lane tile saves no bytes there); kept so both
            # packages warn alike
            warnings.warn(
                f"prior_kv_heads={self.kv_heads} < heads with head dim {dh} < 128 — measured SLOWER "
                "on TPU (no physical cache-byte saving below one 128-lane tile per head)",
                stacklevel=2,
            )
        self.seq = s = self.representation_dim**2 * self.index_dim
        attn = getattr(config, "prior_attn", "auto")
        if attn == "auto":
            if s < _AUTO_STREAMING_SEQ:
                attn = "dense"
            elif dh <= 128 or dh % 128 == 0:
                attn = "flash"
            else:
                attn = "blocked"
        if attn not in ("dense", "blocked", "flash"):
            raise ValueError(f"prior_attn must be auto|dense|blocked|flash, got {attn!r}")
        if attn == "dense" and s >= 1024:
            print(
                f"warning: prior_attn=dense at S={s} materializes "
                f"{self.heads * s**2 * 4 / 2**20:.0f} MiB of attention scores per sample per layer "
                "(training OOM risk) — use prior_attn=flash (the auto default at this size)",
                file=sys.stderr,
            )
        self.attn = attn
        q_block = getattr(config, "prior_q_block", 256)
        kv_block = getattr(config, "prior_kv_block", 256)
        cdt = str(getattr(config, "prior_cache_dtype", "auto"))
        if cdt == "auto":
            cdt = "int8" if s >= _AUTO_STREAMING_SEQ else "bfloat16"
        if cdt not in CACHE_DTYPES:
            raise ValueError(f"prior_cache_dtype must be float32|bfloat16|int8|int4, got {cdt!r}")
        self.cache_dtype = CACHE_DTYPES[cdt]  # read by the decode, which is not ported yet

        lvl = self.num_levels
        self.tok_emb = nn.Parameter(0.02 * torch.randn(lvl, d, device=device))
        self.bos = nn.Parameter(0.02 * torch.randn(d, device=device))
        self.pos_emb = nn.Parameter(0.02 * torch.randn(s, d, device=device))
        self.blocks = nn.ModuleList(
            Block(d, self.heads, self.kv_heads, attn, q_block, kv_block, device) for _ in range(self.n_layers)
        )
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.head = nn.Linear(d, lvl, device=device)
        _init_linear(self.head)

    def _embed_inputs(self, tokens: torch.Tensor) -> torch.Tensor:
        """Shift right: position p's input is token p-1, BOS at 0."""
        b, s = tokens.shape
        emb = F.embedding(tokens[:, :-1], self.tok_emb)
        bos = self.bos.expand(b, 1, self.d)
        return torch.cat([bos, emb], dim=1) + self.pos_emb[:s]

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Level grid ``(B, r, r, C)`` of floats in ``[0, L-1]`` → logits
        ``(B, r, r, C, L)``, teacher-forced."""
        b, r, c = grid.shape[0], self.representation_dim, self.index_dim
        tokens = grid.to(torch.int64).reshape(b, self.seq)
        x = self._embed_inputs(tokens)
        for block in self.blocks:
            x = block(x)
        return self.head(self.ln_f(x)).reshape(b, r, r, c, self.num_levels)

    def reconstruct(self, grid: torch.Tensor) -> torch.Tensor:
        """Teacher-forced denoise: the argmax re-prediction per position."""
        return torch.argmax(self.forward(grid), dim=-1).to(grid.dtype)

    def interpolate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (x + y) / 2

    def sample(self, *args, **kwargs):
        raise NotImplementedError(f"sample: {_DECODE_NOT_PORTED}")

    def decode_logits(self, *args, **kwargs):
        raise NotImplementedError(f"decode_logits: {_DECODE_NOT_PORTED}")
