"""Causal self-attention over ``(B, S, heads, dh)`` tensors, three backends.

Port of ``hopvae_tpu/ops/attention.py``; the Transformer prior picks one
with ``prior_attn``:

- :func:`dense_causal_attention`: one masked softmax over the whole
  ``(B, heads, S, S)`` score tensor; small S only.
- :func:`blocked_causal_attention`: the flash-style online softmax over
  KV blocks in plain torch, one ``(B, heads, q_block, kv_block)`` score
  tile at a time, future blocks skipped. It is the plain version of the
  kernels below, with the JAX fallback's masking: the finite ``_NEG``,
  masked probabilities zeroed after the exp, and ``acc / max(l, 1e-30)``.
  JAX wraps each query block in ``jax.checkpoint``; here autograd keeps
  the tiles, which is fine at the sizes the CPU runs.
- :func:`flash_causal_attention`: on CUDA tensors the hand-written
  kernels (``ops/attention_cuda.py``: K5 forward, dK/dV and dQ), on CPU
  tensors :func:`blocked_causal_attention`, as the JAX package does off
  the TPU. A head width the kernels do not take (48, 96, 192; 320 past
  256) is zero-padded to the next one (64, 128, 256; the next multiple of
  128) and the output sliced back:
  zero columns add nothing to ``q·kᵀ`` and give zero output columns, so
  this is exact, and autograd through the pad and the slice gives the
  gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hopvae_torch.ops.attention_cuda import FlashCausalAttention, kernel_width

# Finite stand-in for -inf: exp(x - m) underflows to exactly 0 for masked
# entries without the NaN of (-inf) - (-inf) in rows whose first block is
# fully masked (padded query rows).
_NEG = -1e30


def _scale(dh: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(dh) if scale is None else scale


def blocked_causal_attention(q, k, v, *, q_block: int = 256, kv_block: int = 256, scale: float | None = None):
    """Causal ``softmax(QKᵀ·scale)V`` over ``(B, S, heads, dh)`` tensors,
    one query block at a time with an online softmax over KV blocks.
    ``S`` need not divide the block sizes: the tail is masked."""
    b, s, h, dh = q.shape
    scale = _scale(dh, scale)
    q_block, kv_block = min(q_block, max(s, 1)), min(kv_block, max(s, 1))
    qt, kt, vt = (a.transpose(1, 2).float() for a in (q, k, v))  # (B, h, S, dh)
    outs = []
    for q0 in range(0, s, q_block):
        qi = qt[:, :, q0 : q0 + q_block]
        q_pos = torch.arange(q0, q0 + q_block, device=q.device)[: qi.shape[2]]
        acc = qi.new_zeros(b, h, qi.shape[2], dh)
        m = qi.new_full((b, h, qi.shape[2]), _NEG)
        l = qi.new_zeros(b, h, qi.shape[2])
        for k0 in range(0, q0 + q_block, kv_block):  # blocks past the diagonal are skipped
            if k0 >= s:
                break
            kj, vj = kt[:, :, k0 : k0 + kv_block], vt[:, :, k0 : k0 + kv_block]
            k_pos = torch.arange(k0, k0 + kj.shape[2], device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            sc = torch.where(mask, torch.matmul(qi, kj.transpose(-1, -2)) * scale, _NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)  # no exp(NEG - NEG) = 1 ghosts
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vj)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def kernel_causal_attention(q, k, v, scale: float):
    """The kernels' route of :func:`flash_causal_attention`: a head width
    the kernels do not take is zero-padded to the next one they take
    (:func:`~hopvae_torch.ops.attention_cuda.kernel_width`) and the output
    sliced back; ``scale`` is the caller's, that of the true width.
    :class:`FlashCausalAttention` takes the plain versions on CPU tensors,
    so the CPU tests hold this route (the padding too) against JAX."""
    dh = q.shape[-1]
    width = kernel_width(dh)
    if width == dh:
        return FlashCausalAttention.apply(q, k, v, scale)
    q, k, v = (F.pad(a, (0, width - dh)) for a in (q, k, v))
    return FlashCausalAttention.apply(q, k, v, scale)[..., :dh]


def flash_causal_attention(q, k, v, *, scale: float | None = None):
    """Causal attention over ``(B, S, heads, dh)``: the hand-written
    kernels on CUDA tensors (:func:`kernel_causal_attention`),
    :func:`blocked_causal_attention` on CPU tensors."""
    scale = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return blocked_causal_attention(q, k, v, scale=scale)
    return kernel_causal_attention(q, k, v, scale)


def dense_causal_attention(q, k, v, *, scale: float | None = None):
    """One masked softmax over the full ``(B, heads, S, S)`` scores."""
    b, s, h, dh = q.shape
    scale = _scale(dh, scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    att = torch.softmax(torch.where(mask, scores, _NEG), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", att, v.float()).to(q.dtype)
