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
  widths ≤ 128 or a multiple of 128 (JAX's rule), else blocked. Flash on
  CUDA tensors runs the hand-written kernels (K5), built for head widths
  8 to 256 and, past 256, every multiple of 128 (one wide instance); any
  other width under ``prior_attn=flash`` (48, 96, 320) is zero-padded to
  the next one the kernels take.

- The KV-cached decode (``sample``, ``decode_logits``): one position at
  a time through every block (``Block.decode_step``), over per-layer K/V
  caches in ``prior_cache_dtype`` (f32, bf16, or int8 and int4 codes with
  per-(token, kv-head) absmax scales, ``_quantize_token``), in segments
  of ``prior_decode_segment`` positions whose steps read the caches'
  growing prefix (``decode.py``; on the card each segment's step replays
  from a CUDA graph). ``sample`` draws Gumbel-argmax, the form of
  ``jax.random.categorical``, from a ``torch.Generator``; ``decode_logits``
  runs the same step teacher-forced, its caches f32 by default, and must
  match ``forward``.

Parameters keep the JAX names (``tok_emb``, ``bos``, ``pos_emb``,
``blocks.<i>.{ln1, qkv, out, ln2, mlp_in, mlp_out}``, ``ln_f``, ``head``),
with Linear weights ``(out, in)``. The head count is a reshape over the
same parameter shapes, so it must be the one the weights were trained
with.
"""

from __future__ import annotations

import math
import sys
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from hopvae_torch.models.priors.decode import QMAX, Decoder
from hopvae_torch.ops.attention import blocked_causal_attention, dense_causal_attention, flash_causal_attention
from hopvae_torch.ops.conv import full_f32

LN_EPS = 1e-5
# from this sequence length "auto" leaves the dense backend, whose
# (B, heads, S, S) scores are saved per layer for the backward
_AUTO_STREAMING_SEQ = 512
CACHE_DTYPES = {"bfloat16": "bfloat16", "bf16": "bfloat16", "int8": "int8", "int4": "int4",
                "float32": "float32", "f32": "float32"}
MASK = -1e30  # JAX's fill past t (not -inf): exp(MASK - max) is 0 in f32


def _quantize_token(x: torch.Tensor, kv: int, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, kv-head) absmax quantization: ``(B, kv·dh)`` → codes
    ``(B, kv·dh)`` in ``[-qmax, qmax]`` as int8, and f32 scales ``(B, kv)``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    b, w = x.shape
    xh = x.reshape(b, kv, w // kv)
    s = torch.clamp(xh.abs().amax(dim=-1) / qmax, min=1e-12)
    q = torch.clamp(torch.round(xh / s[..., None]), -qmax, qmax).to(torch.int8)
    return q.reshape(b, w), s


class TokenEmbedding(torch.autograd.Function):
    """``F.embedding(tokens, table)`` with a backward that repeats bit for
    bit: the table's gradient is one f32 product of the tokens' one-hot
    rows with the cotangent (TF32 off). CUDA's embedding backward sums a
    level's rows in an order that changes from run to run: on an H100 with
    torch 2.11, two prior-phase steps from one state gave ``tok_emb``
    gradients up to 9.7e-8 apart, and the steps drifted apart from there.
    At the prior's full width (221,952 tokens, 512 levels, d 128) the
    product is 29 GFLOP."""

    @staticmethod
    def forward(ctx, tokens, table):
        ctx.save_for_backward(tokens)
        ctx.levels = table.shape[0]
        return F.embedding(tokens, table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1, 1)
        onehot = torch.zeros(flat.shape[0], ctx.levels, dtype=g.dtype, device=g.device).scatter_(1, flat, 1.0)
        with full_f32():
            return None, onehot.T @ g.reshape(flat.shape[0], -1)


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

    def decode_step(self, x_t: torch.Tensor, cache: dict, t: torch.Tensor, valid: torch.Tensor,
                    qmax: float | None = None) -> torch.Tensor:
        """One position ``t`` (a one-element int64 tensor) through the block:
        ``x_t (B, d)`` → ``(B, d)``. Writes this position's k and v (codes
        and scales when ``qmax`` is set) into ``cache`` (``k``, ``v`` of
        shape ``(B, kv, S, dh)``; ``ks``, ``vs`` of ``(B, kv, S)``) at ``t``,
        then attends over the prefix ``[:len(valid)]``, where ``valid`` is
        ``arange(len) <= t``. Each KV head serves its group of query heads."""
        b, d = x_t.shape
        h, kv, kvw = self.heads, self.kv_heads, self.kv_width
        dh = d // h
        qkv = self.qkv(self.ln1(x_t))
        q, k, v = qkv[:, :d], qkv[:, d : d + kvw], qkv[:, d + kvw :]
        if qmax is not None:
            k, sk = _quantize_token(k, kv, qmax)
            v, sv = _quantize_token(v, kv, qmax)
            cache["ks"].index_copy_(2, t, sk[..., None])
            cache["vs"].index_copy_(2, t, sv[..., None])
        cache["k"].index_copy_(2, t, k.reshape(b, kv, 1, dh).to(cache["k"].dtype))
        cache["v"].index_copy_(2, t, v.reshape(b, kv, 1, dh).to(cache["v"].dtype))
        n = valid.shape[0]
        keys = cache["k"][:, :, :n].float()  # the prefix, read back as f32
        values = cache["v"][:, :, :n].float()
        scores = torch.matmul(q.reshape(b, kv, h // kv, dh), keys.transpose(-1, -2)) / math.sqrt(dh)
        if qmax is not None:
            scores = scores * cache["ks"][:, :, None, :n]
        att = torch.softmax(torch.where(valid, scores, MASK), dim=-1)
        if qmax is not None:
            att = att * cache["vs"][:, :, None, :n]
        x = x_t + self.out(torch.matmul(att, values).reshape(b, d))
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
        self.cache_dtype = CACHE_DTYPES[cdt]  # sample's; decode_logits takes its own (f32 by default)
        # positions a decode segment adds (see decode.py)
        self.decode_segment = int(getattr(config, "prior_decode_segment", 64 if s <= 256 else 128))
        self._graphed = {}  # the card's captured decoders, by (mode, batch, cache dtype, weights)

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
        emb = TokenEmbedding.apply(tokens[:, :-1], self.tok_emb)
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

    # ------------------------------------------------------------ decode

    def _empty_caches(self, b: int, cache_dtype: str) -> list[dict]:
        """Each layer's caches at full length S, zeroed: ``k``, ``v`` of
        ``(B, kv, S, dh)`` in the cache dtype (int4's codes in int8), and
        for int8 and int4 the f32 scales ``ks``, ``vs`` of ``(B, kv, S)``."""
        kv, dh, dev = self.kv_heads, self.d // self.heads, self.tok_emb.device
        storage = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(cache_dtype, torch.int8)
        caches = []
        for _ in range(self.n_layers):
            one = {name: torch.zeros(b, kv, self.seq, dh, dtype=storage, device=dev) for name in ("k", "v")}
            if cache_dtype in QMAX:
                one.update({name: torch.zeros(b, kv, self.seq, device=dev) for name in ("ks", "vs")})
            caches.append(one)
        return caches

    def _decode_step(self, dec: Decoder, start: int, stop: int) -> None:
        """Position ``dec.t`` of the segment ``[start, stop)`` through every
        block and the head; then the draw (``sample``: ``argmax(logits +
        g)`` with the noise row ``t - start``) or the logits
        (``decode_logits``) go to ``dec.out`` at ``t``, the next input token
        to ``dec.prev``, and ``t`` advances by one. Every index is a device
        tensor, so a captured step replays for each position."""
        t = dec.t
        valid = dec.positions[:stop] <= t
        x = torch.where(t == 0, self.bos, F.embedding(dec.prev, self.tok_emb)) + self.pos_emb.index_select(0, t)
        for block, cache in zip(self.blocks, dec.caches):
            x = block.decode_step(x, cache, t, valid, dec.qmax)
        logits = self.head(self.ln_f(x))
        if dec.mode == "sample":
            draw = torch.argmax(logits + dec.noise.index_select(0, t - start)[0], dim=-1)
            dec.out.index_copy_(0, t, draw[None])
            dec.prev.copy_(draw)
        else:
            dec.out.index_copy_(0, t, logits[None])
            dec.prev.copy_(dec.tokens.index_select(1, t)[:, 0])
        t.add_(1)

    def _decode_all(self, mode: str, b: int, cache_dtype: str, eager: bool, fill=None, tokens=None) -> torch.Tensor:
        """All S positions in segments: ``dec.out`` of the decoder for
        (``mode``, ``b``, ``cache_dtype``). On the card, unless ``eager``,
        each segment's step replays from its CUDA graph, captured at the
        first call of that key and kept; elsewhere the step runs eagerly."""
        if not self.tok_emb.is_cuda or eager:
            dec = Decoder(self, b, cache_dtype, mode)
        else:
            key = (mode, b, cache_dtype, tuple(p.data_ptr() for p in self.parameters()))
            dec = self._graphed.get(key)
            if dec is None:
                dec = self._graphed[key] = Decoder(self, b, cache_dtype, mode)
                dec.capture()
        if tokens is not None:
            dec.tokens.copy_(tokens)
        return dec.run(fill)

    def decode_logits(self, grid: torch.Tensor, cache_dtype: str = "float32", *, eager: bool = False) -> torch.Tensor:
        """Teacher-forced logits ``(B, r, r, C, L)`` through the KV-cached
        decode that ``sample`` runs: BOS at position 0, then the embedding
        of the grid's token at ``t - 1``, plus ``pos_emb[t]``. With f32
        caches it must match ``forward``; other cache dtypes measure the
        quantized caches' error. ``eager`` skips the CUDA graphs."""
        if str(cache_dtype) not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be float32|bfloat16|int8|int4, got {cache_dtype!r}")
        cdt = CACHE_DTYPES[str(cache_dtype)]
        b, r, c = grid.shape[0], self.representation_dim, self.index_dim
        tokens = grid.to(device=self.tok_emb.device, dtype=torch.int64).reshape(b, self.seq)
        with torch.inference_mode():
            logits = self._decode_all("logits", b, cdt, eager, tokens=tokens)
        return logits.transpose(0, 1).reshape(b, r, r, c, self.num_levels).clone()  # a card decoder's buffer

    def sample(self, num_samples: int = 1, generator: torch.Generator | None = None, device=None, *,
               _gumbel: torch.Tensor | None = None, eager: bool = False) -> torch.Tensor:
        """``num_samples`` grids ``(B, r, r, C)`` of float levels, drawn
        autoregressively with caches in ``self.cache_dtype``: at each
        position ``argmax(logits + g)``, ``g = -log(-log(u))`` with ``u``
        uniform on ``[tiny, 1)`` (``jax.random.categorical``'s form). Each
        segment's ``u`` is drawn from ``generator`` (on the prior's device)
        as one ``(n, B, L)`` block, ``n`` the segment's positions, before its
        steps run. ``_gumbel`` ``(S, B, L)`` replaces those draws (the
        tests feed JAX and the port the same noise). ``device``, if given,
        must be the prior's. ``eager`` skips the CUDA graphs."""
        dev = self.tok_emb.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"the prior's parameters are on {dev}, not {device}")
        b, r, c, lvl = num_samples, self.representation_dim, self.index_dim, self.num_levels
        if _gumbel is not None:
            _gumbel = torch.as_tensor(_gumbel, dtype=torch.float32).to(dev)
            if tuple(_gumbel.shape) != (self.seq, b, lvl):
                raise ValueError(f"_gumbel must be (S, B, L) = {(self.seq, b, lvl)}, got {tuple(_gumbel.shape)}")

        def fill(noise: torch.Tensor, start: int, stop: int) -> None:
            if _gumbel is not None:
                noise.copy_(_gumbel[start:stop])
            else:
                torch.rand(noise.shape, generator=generator, device=dev, out=noise)
                gumbel_(noise)

        with torch.inference_mode():
            draws = self._decode_all("sample", b, self.cache_dtype, eager, fill=fill)
        return draws.transpose(0, 1).reshape(b, r, r, c).float()


def gumbel_(u: torch.Tensor) -> torch.Tensor:
    """Uniform ``[0, 1)`` draws → Gumbel noise in place: ``-log(-log(u))``
    with ``u`` raised to f32's ``tiny`` (``jax.random.gumbel``'s form)."""
    return u.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()
