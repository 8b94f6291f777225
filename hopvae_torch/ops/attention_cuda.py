"""Causal flash attention through the hand-written Hopper kernels (K5).

Port of the Mosaic flash attention that ``hopvae_tpu/ops/attention.py``
(``flash_causal_attention``) calls on the TPU, forward and backward, over
``(B, S, heads, dh)`` f32 tensors:

- K5-fwd ``csrc/causal_attention_fwd.cu`` (:func:`causal_attention_fwd`):
  ``out = softmax(scale·QKᵀ, causal)·V`` and the row log-sum-exp ``lse``
  ``(B, heads, S)``;
- K5-dkv ``csrc/causal_attention_bwd.cu`` (:func:`causal_attention_bwd_dkv`):
  ``dK`` and ``dV``;
- K5-dq, the same file (:func:`causal_attention_bwd_dq`): ``dQ``.

The backward kernels rebuild ``P = exp(scale·QKᵀ − lse)`` from the
forward's ``lse`` and take ``delta = rowsum(dO ⊙ O)`` from torch, so the
``(S, S)`` matrices never reach device memory. The inputs may be strided
views (the prior's q, k and v are slices of one projection); only the
head width must be contiguous. Each wrapper launches its kernel on CUDA
tensors, counting the launch in its ``launches``, and takes its plain
version on CPU tensors; the plain versions hold the ``(S, S)`` matrices.
"""

from __future__ import annotations

import ctypes

import torch

from hopvae_torch.utils.nvcc import bind, launch

HEAD_DIMS = (8, 16, 32, 64, 128)  # the head widths the kernels are built for
_NOT_BUILT = "ROADMAP.md, Queue 2: K5 at head width 256"


# ------------------------------------------------------------ plain versions


def _scores(q, k, scale):
    """``scale·QKᵀ`` as ``(B, heads, S, S)`` and the causal mask."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return sc, torch.ones(s, s, dtype=torch.bool, device=q.device).tril()


def causal_attention_fwd_reference(q, k, v, scale: float):
    """Plain torch version of K5-fwd: ``(out, lse)``."""
    sc, mask = _scores(q, k, scale)
    lse = torch.logsumexp(torch.where(mask, sc, float("-inf")), dim=-1)
    p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v), lse


def attention_delta(out, g):
    """``rowsum(dO ⊙ O)`` as ``(B, heads, S)``, the backward's shift."""
    return (g * out).sum(-1).transpose(1, 2).contiguous()


def _dscores(q, k, v, g, lse, delta, scale):
    """``(P, dS)`` rebuilt from ``lse``: ``dS = P ⊙ (dO·Vᵀ − delta)``."""
    sc, mask = _scores(q, k, scale)
    p = torch.where(mask, torch.exp(sc - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, v) - delta[..., None])
    return p, ds


def causal_attention_bwd_dkv_reference(q, k, v, g, lse, delta, scale: float):
    """Plain torch version of K5-dkv: ``(dK, dV)``."""
    p, ds = _dscores(q, k, v, g, lse, delta, scale)
    return torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale, torch.einsum("bhqk,bqhd->bkhd", p, g)


def causal_attention_bwd_dq_reference(q, k, v, g, lse, delta, scale: float):
    """Plain torch version of K5-dq: ``dQ``."""
    _, ds = _dscores(q, k, v, g, lse, delta, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale


def causal_attention_bwd_reference(q, k, v, out, lse, g, scale: float):
    """Plain backward for the cotangent ``g`` of ``out``: ``(dQ, dK, dV)``,
    from the forward's ``lse`` as the kernels do."""
    delta = attention_delta(out, g)
    dk, dv = causal_attention_bwd_dkv_reference(q, k, v, g, lse, delta, scale)
    return causal_attention_bwd_dq_reference(q, k, v, g, lse, delta, scale), dk, dv


# ------------------------------------------------------------ kernels


def _check(q, k, v, *rest) -> tuple[int, int, int, int]:
    """Types, devices and shapes; ``rest`` is the backward's ``(g, lse,
    delta)``. The head width of q, k, v and g must be contiguous."""
    named = {"q": q, "k": k, "v": v}
    named.update(zip(("g", "lse", "delta"), rest))
    for name, a in named.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, heads, dh), got {tuple(q.shape)}")
    b, s, h, dh = q.shape
    for name in ("k", "v", "g"):
        if name in named and named[name].shape != q.shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} does not match q {tuple(q.shape)}")
        if name in named and named[name].stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its head width")
    if q.stride(-1) != 1:
        raise ValueError("q must be contiguous along its head width")
    for name in ("lse", "delta"):
        if name in named and (named[name].shape != (b, h, s) or not named[name].is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {(b, h, s)}, got {tuple(named[name].shape)}")
    if 0 in (b, s, h):
        raise ValueError(f"empty attention: {tuple(q.shape)}")
    return b, s, h, dh


def _require_kernel(q, dh: int) -> None:
    if dh == 256:
        raise NotImplementedError(f"the flash kernels are not built for head width 256 ({_NOT_BUILT})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not in {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")


def _launch(name: str, ptrs, strided, shape, scale: float, device) -> None:
    """Launch ``lib.name``: ``ptrs``, then ``(B, S, heads, dh)``, the batch,
    sequence and head strides of each strided input, the scale and the
    stream."""
    stem = "causal_attention_fwd" if name == "causal_attention_fwd" else "causal_attention_bwd"
    argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4 + [ctypes.c_longlong] * (3 * len(strided))
                + [ctypes.c_float, ctypes.c_void_p])
    strides = [st for a in strided for st in a.stride()[:3]]
    launch(name, bind(stem, name, argtypes), device, *(a.data_ptr() for a in ptrs), *shape, *strides, scale)


def causal_attention_fwd(q, k, v, scale: float):
    """K5-fwd: ``(out (B, S, heads, dh), lse (B, heads, S))``. CUDA tensors
    launch the kernel (counted in ``causal_attention_fwd.launches``); CPU
    tensors take the plain version. Forward-only: differentiate through
    :class:`FlashCausalAttention`."""
    b, s, h, dh = _check(q, k, v)
    if q.device.type == "cpu":
        return causal_attention_fwd_reference(q, k, v, scale)
    _require_kernel(q, dh)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise RuntimeError("causal_attention_fwd is forward-only: differentiate through FlashCausalAttention")
    out = torch.empty(b, s, h, dh, device=q.device)
    lse = torch.empty(b, h, s, device=q.device)
    _launch("causal_attention_fwd", (q, k, v, out, lse), (q, k, v), (b, s, h, dh), scale, q.device)
    causal_attention_fwd.launches += 1
    return out, lse


causal_attention_fwd.launches = 0


def causal_attention_bwd_dkv(q, k, v, g, lse, delta, scale: float):
    """K5-dkv: ``(dK, dV)`` for the cotangent ``g`` of ``out``, from the
    forward's ``lse`` and :func:`attention_delta`. CUDA tensors launch the
    kernel (counted in ``causal_attention_bwd_dkv.launches``); CPU tensors
    take the plain version."""
    b, s, h, dh = _check(q, k, v, g, lse, delta)
    if q.device.type == "cpu":
        return causal_attention_bwd_dkv_reference(q, k, v, g, lse, delta, scale)
    _require_kernel(q, dh)
    dk = torch.empty(b, s, h, dh, device=q.device)
    dv = torch.empty(b, s, h, dh, device=q.device)
    _launch("causal_attention_bwd_dkv", (q, k, v, g, lse, delta, dk, dv), (q, k, v, g), (b, s, h, dh),
            scale, q.device)
    causal_attention_bwd_dkv.launches += 1
    return dk, dv


causal_attention_bwd_dkv.launches = 0


def causal_attention_bwd_dq(q, k, v, g, lse, delta, scale: float):
    """K5-dq: ``dQ``, from the same inputs as :func:`causal_attention_bwd_dkv`.
    CUDA tensors launch the kernel (counted in
    ``causal_attention_bwd_dq.launches``); CPU tensors take the plain
    version."""
    b, s, h, dh = _check(q, k, v, g, lse, delta)
    if q.device.type == "cpu":
        return causal_attention_bwd_dq_reference(q, k, v, g, lse, delta, scale)
    _require_kernel(q, dh)
    dq = torch.empty(b, s, h, dh, device=q.device)
    _launch("causal_attention_bwd_dq", (q, k, v, g, lse, delta, dq), (q, k, v, g), (b, s, h, dh),
            scale, q.device)
    causal_attention_bwd_dq.launches += 1
    return dq


causal_attention_bwd_dq.launches = 0


class FlashCausalAttention(torch.autograd.Function):
    """Causal ``softmax(scale·QKᵀ)V`` over ``(B, S, heads, dh)`` f32
    tensors, differentiable in q, k and v: K5-fwd forward, K5-dkv and
    K5-dq backward (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = causal_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.float()
        if g.stride(-1) != 1:
            g = g.contiguous()
        delta = attention_delta(out, g)
        dk, dv = causal_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        dq = causal_attention_bwd_dq(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None
