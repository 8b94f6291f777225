"""Streaming Hopfield lookup through the hand-written Hopper kernel.

Port of the forward half of ``hopvae_tpu/ops/hopfield_pallas.py``
(``_fold_layer``, ``_attn_call_fwd``, ``_lookup_streaming``). Attention
rows sum to 1, so each lookup's out-projection and both biases fold into
a value table and a constant shift::

    K = LN_stored(P)            U = (LN_proj(P) @ W_inᵀ + b_in) @ W_outᵀ
    out = softmax(β · LN_state(x) Kᵀ) @ U + b_out

``fold_layer`` does that folding in plain, differentiable f32 torch.
``stream_lookup_fwd`` runs the rest in ``csrc/hopfield_stream_fwd.cu``
on CUDA tensors; ``stream_lookup_fwd_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hopvae_torch.ops.hopfield import LN_EPS, HopfieldLookup
from hopvae_torch.utils.nvcc import load_library

SOURCE = "hopfield_stream_fwd"
SUPPORTED = ((64, 64), (64, 3), (3, 64))  # (d_in, d_out) the kernel is built for


def fold_layer(layer: HopfieldLookup):
    """One lookup's parameters → ``(K, U, b, s, t)``: keys, folded value
    table, output shift, and the state LayerNorm's scale and shift."""
    patterns = layer.lookup_weights
    mean = patterns.mean(-1, keepdim=True)
    var = patterns.var(-1, unbiased=False, keepdim=True)
    normed = (patterns - mean) * torch.rsqrt(var + LN_EPS)
    k = normed * layer.norm_stored.weight + layer.norm_stored.bias
    v = normed * layer.norm_proj.weight + layer.norm_proj.bias
    v = torch.matmul(v, layer.in_proj.weight.T) + layer.in_proj.bias
    u = torch.matmul(v, layer.out_proj.weight.T)
    return k, u, layer.out_proj.bias, layer.norm_state.weight, layer.norm_state.bias


def stream_lookup_fwd_reference(x2, K, U, s, t):
    """Plain torch version of the kernel: ``(out, m, l)`` with ``m`` the
    row max of the scaled scores and ``l`` the softmax denominator, both
    ``(N, 1)``. Materializes the ``(N, M)`` scores.

    The state LayerNorm runs in float64 and rounds once, as the kernel's
    does: at ``d_in = 3`` a row whose values nearly agree loses most
    digits of ``x - mean`` in f32."""
    d = x2.shape[1]
    x64 = x2.double()
    mean = x64.sum(-1, keepdim=True) / d
    cent = x64 - mean
    var = (cent * cent).sum(-1, keepdim=True) / d
    q = (cent * torch.rsqrt(var + LN_EPS) * s.double() + t.double()).float()
    sc = torch.matmul(q, K.T) * (1.0 / math.sqrt(d))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    return torch.matmul(p, U) / l, m, l


def _check(x2, K, U, s, t) -> tuple[int, int, int, int]:
    named = {"x2": x2, "K": K, "U": U, "s": s, "t": t}
    for name, a in named.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != x2.device:
            raise ValueError(f"{name} is on {a.device}, x2 on {x2.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dim() != 2 or K.dim() != 2 or U.dim() != 2:
        raise ValueError("x2, K and U must be 2-D")
    n, d_in = x2.shape
    m, d_out = U.shape
    if K.shape != (m, d_in) or s.shape != (d_in,) or t.shape != (d_in,):
        raise ValueError(
            f"shapes disagree: x2 {tuple(x2.shape)}, K {tuple(K.shape)}, "
            f"U {tuple(U.shape)}, s {tuple(s.shape)}, t {tuple(t.shape)}"
        )
    if (d_in, d_out) not in SUPPORTED:
        raise ValueError(f"(d_in, d_out) = {(d_in, d_out)} not in {SUPPORTED}")
    if n == 0 or m == 0:
        raise ValueError("x2 and the tables need at least one row")
    return n, m, d_in, d_out


def _kernel():
    lib = load_library(SOURCE)
    fn = lib.hopfield_stream_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stream_lookup_fwd(x2, K, U, s, t):
    """``(out, m, l)`` of the streaming lookup of ``x2 (N, d_in)``.

    CUDA tensors launch the kernel (and count the launch in
    ``stream_lookup_fwd.launches``); CPU tensors take the plain version.
    The kernel has no backward yet, so inputs that need a gradient raise.
    """
    n, m, d_in, d_out = _check(x2, K, U, s, t)
    if x2.device.type == "cpu":
        return stream_lookup_fwd_reference(x2, K, U, s, t)
    if x2.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x2, K, U, s, t)):
        raise RuntimeError("the streaming kernel is forward-only: run it under torch.no_grad()")
    out = torch.empty(n, d_out, device=x2.device)
    m_stat = torch.empty(n, 1, device=x2.device)
    l_stat = torch.empty(n, 1, device=x2.device)
    fn = _kernel()
    with torch.cuda.device(x2.device):
        err = fn(
            x2.data_ptr(), K.data_ptr(), U.data_ptr(), s.data_ptr(), t.data_ptr(),
            out.data_ptr(), m_stat.data_ptr(), l_stat.data_ptr(),
            n, m, d_in, d_out, torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hopfield_stream_fwd launch failed: cudaError {err}")
    stream_lookup_fwd.launches += 1
    return out, m_stat, l_stat


stream_lookup_fwd.launches = 0


def hopfield_lookup_stream(layer: HopfieldLookup, x: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """One lookup of ``x (..., d_in)`` with folded tables; ``impl="cuda"``
    launches the kernel and needs CUDA tensors, ``impl="torch"`` runs the
    plain version."""
    k, u, b, s, t = fold_layer(layer)
    *lead, d = x.shape
    x2 = x.reshape(-1, d).contiguous()
    if impl == "cuda":
        if x2.device.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {x2.device}; use impl='torch'")
        out, _, _ = stream_lookup_fwd(x2, k, u, s, t)
    elif impl == "torch":
        out, _, _ = stream_lookup_fwd_reference(x2, k, u, s, t)
    else:
        raise ValueError(f"impl must be 'cuda' or 'torch', got {impl!r}")
    return (out + b).reshape(*lead, u.shape[1])
