"""Streaming Hopfield lookup through the hand-written Hopper kernels.

Port of ``hopvae_tpu/ops/hopfield_pallas.py`` (``_fold_layer``,
``_attn_ln_stream`` with its forward and backward, ``_lookup_streaming``).
Attention rows sum to 1, so each lookup's out-projection and both biases
fold into a value table and a constant shift::

    K = LN_stored(P)            U = (LN_proj(P) @ W_inᵀ + b_in) @ W_outᵀ
    out = softmax(β · LN_state(x) Kᵀ) @ U + b_out

``fold_layer`` does that folding in plain, differentiable f32 torch, so
the gradients of the patterns, projections and LayerNorms flow through
it by autograd. The rest is :class:`StreamLookup`, an autograd function
over ``(x2, K, U, s, t)`` with three kernels:

- K1 ``csrc/hopfield_stream_fwd.cu`` (:func:`stream_lookup_fwd`): the
  forward, which also writes the softmax row stats ``m`` and ``l``;
- K2 ``csrc/hopfield_stream_bwd_dx.cu`` (:func:`stream_bwd_dx`): ``dx``,
  ``ds`` and ``dt``;
- K3 ``csrc/hopfield_stream_bwd_dku.cu`` (:func:`stream_bwd_dku`): ``dK``
  and ``dU``.

The backward kernels rebuild the attention from ``m`` and ``l``, so the
``(N, M)`` matrix never reaches device memory. Each wrapper launches its
kernel on CUDA tensors (counting the launch in its ``launches``) and
takes its plain version on CPU tensors: ``stream_lookup_fwd_reference``
and ``stream_lookup_bwd_reference``, which hold the ``(N, M)`` matrices.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hopvae_torch.ops.hopfield import LN_EPS, HopfieldLookup
from hopvae_torch.utils.nvcc import bind, launch, load_library

SUPPORTED = ((64, 64), (64, 3), (3, 64))  # (d_in, d_out) the kernels are built for
IMPLS = ("cuda", "torch")


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


# ------------------------------------------------------------ plain versions


def _state_ln(x2):
    """``(x̂, inv)`` of the state LayerNorm, in float64. The kernels run
    it in double and round once too: at ``d_in = 3`` a row whose values
    nearly agree loses most digits of ``x - mean`` in f32."""
    d = x2.shape[1]
    x64 = x2.double()
    cent = x64 - x64.sum(-1, keepdim=True) / d
    inv = torch.rsqrt((cent * cent).sum(-1, keepdim=True) / d + LN_EPS)
    return cent * inv, inv


def _query(xhat, s, t):
    return (xhat * s.double() + t.double()).float()


def stream_lookup_fwd_reference(x2, K, U, s, t):
    """Plain torch version of K1: ``(out, m, l)`` with ``m`` the row max
    of the scaled scores and ``l`` the softmax denominator, both
    ``(N, 1)``. Materializes the ``(N, M)`` scores."""
    xhat, _ = _state_ln(x2)
    sc = torch.matmul(_query(xhat, s, t), K.T) * (1.0 / math.sqrt(x2.shape[1]))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    return torch.matmul(p, U) / l, m, l


def _attention_grads(x2, K, U, s, t, g, m, l, delta):
    """The attention rebuilt from the row stats, and the score cotangent:
    ``(A, dS, q, x̂, inv)``."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    xhat, inv = _state_ln(x2)
    q = _query(xhat, s, t)
    a = torch.exp(torch.matmul(q, K.T) * beta - m) / l
    ds = a * (torch.matmul(g, U.T) - delta) * beta
    return a, ds, q, xhat, inv


def stream_bwd_dx_reference(x2, K, U, s, t, g, m, l, delta):
    """Plain torch version of K2: ``(dx, ds, dt)``. The LayerNorm backward
    runs in float64, as in the kernel."""
    _, dsc, _, xhat, inv = _attention_grads(x2, K, U, s, t, g, m, l, delta)
    dq = torch.matmul(dsc, K).double()
    dxhat = dq * s.double()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.float(), (dq * xhat).sum(0).float(), dq.sum(0).float()


def stream_bwd_dku_reference(x2, K, U, s, t, g, m, l, delta):
    """Plain torch version of K3: ``(dK, dU)``."""
    a, dsc, q, _, _ = _attention_grads(x2, K, U, s, t, g, m, l, delta)
    return torch.matmul(dsc.T, q), torch.matmul(a.T, g)


def stream_lookup_bwd_reference(x2, K, U, s, t, g, m, l, delta):
    """Plain backward of the streaming lookup: ``(dx, dK, dU, ds, dt)``
    for the cotangent ``g (N, d_out)`` of ``out``, from the forward's row
    stats and ``delta = rowsum(g ⊙ out)``. The same math as K2 and K3,
    written out with the ``(N, M)`` matrices in memory."""
    dx, ds, dt = stream_bwd_dx_reference(x2, K, U, s, t, g, m, l, delta)
    dk, du = stream_bwd_dku_reference(x2, K, U, s, t, g, m, l, delta)
    return dx, dk, du, ds, dt


# ------------------------------------------------------------ kernels


def _check(x2, K, U, s, t, *rest) -> tuple[int, int, int, int]:
    """Types, devices, layouts and shapes of a lookup's arrays; ``rest`` is
    the backward's ``(g, m, l, delta)``."""
    named = {"x2": x2, "K": K, "U": U, "s": s, "t": t}
    named.update(zip(("g", "m", "l", "delta"), rest))
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
    if rest:
        g, *stats = rest
        if g.shape != (n, d_out) or any(a.shape != (n, 1) for a in stats):
            raise ValueError(
                f"backward shapes disagree: g {tuple(g.shape)} (want {(n, d_out)}), "
                f"m, l, delta {[tuple(a.shape) for a in stats]} (want {(n, 1)})"
            )
    if (d_in, d_out) not in SUPPORTED:
        raise ValueError(f"(d_in, d_out) = {(d_in, d_out)} not in {SUPPORTED}")
    if n == 0 or m == 0:
        raise ValueError("x2 and the tables need at least one row")
    return n, m, d_in, d_out


def _bind(stem: str, name: str, n_ptrs: int, n_ints: int):
    """``lib.name`` of ``csrc/<stem>.cu``: pointers, then ints, then the stream."""
    return bind(stem, name, [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p])


def _workspace_floats(stem: str, name: str, *sizes: int) -> int:
    fn = getattr(load_library(stem), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(sizes)
        fn.restype = ctypes.c_longlong
    return fn(*sizes)


def _require_cuda(x2) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2.device}")


def stream_lookup_fwd(x2, K, U, s, t):
    """K1: ``(out, m, l)`` of the streaming lookup of ``x2 (N, d_in)``.

    CUDA tensors launch the kernel (counted in
    ``stream_lookup_fwd.launches``); CPU tensors take the plain version.
    This function is forward-only, so on the card inputs that need a
    gradient raise: differentiate through :func:`stream_lookup`.
    """
    n, m, d_in, d_out = _check(x2, K, U, s, t)
    if x2.device.type == "cpu":
        return stream_lookup_fwd_reference(x2, K, U, s, t)
    _require_cuda(x2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x2, K, U, s, t)):
        raise RuntimeError("stream_lookup_fwd is forward-only: differentiate through stream_lookup")
    out = torch.empty(n, d_out, device=x2.device)
    m_stat = torch.empty(n, 1, device=x2.device)
    l_stat = torch.empty(n, 1, device=x2.device)
    fn = _bind("hopfield_stream_fwd", "hopfield_stream_fwd", 8, 4)
    launch("hopfield_stream_fwd", fn, x2.device,
            *(a.data_ptr() for a in (x2, K, U, s, t, out, m_stat, l_stat)), n, m, d_in, d_out)
    stream_lookup_fwd.launches += 1
    return out, m_stat, l_stat


stream_lookup_fwd.launches = 0


def stream_bwd_dx(x2, K, U, s, t, g, m, l, delta):
    """K2: ``(dx, ds, dt)`` of the lookup for the cotangent ``g`` of its
    output, from K1's row stats ``m``, ``l`` and ``delta = rowsum(g ⊙
    out)``, all ``(N, 1)``. CUDA tensors launch the kernel (counted in
    ``stream_bwd_dx.launches``); CPU tensors take the plain version."""
    n, m_pat, d_in, d_out = _check(x2, K, U, s, t, g, m, l, delta)
    if x2.device.type == "cpu":
        return stream_bwd_dx_reference(x2, K, U, s, t, g, m, l, delta)
    _require_cuda(x2)
    stem = "hopfield_stream_bwd_dx"
    dx = torch.empty(n, d_in, device=x2.device)
    ds = torch.empty(d_in, device=x2.device)
    dt = torch.empty(d_in, device=x2.device)
    work = torch.empty(_workspace_floats(stem, f"{stem}_workspace", n, d_in), device=x2.device)
    launch(stem, _bind(stem, stem, 13, 4), x2.device,
            *(a.data_ptr() for a in (x2, K, U, s, t, g, m, l, delta, dx, ds, dt, work)),
            n, m_pat, d_in, d_out)
    stream_bwd_dx.launches += 1
    return dx, ds, dt


stream_bwd_dx.launches = 0


def stream_bwd_dku(x2, K, U, s, t, g, m, l, delta):
    """K3: ``(dK, dU)`` of the lookup, from the same inputs as
    :func:`stream_bwd_dx`. CUDA tensors launch the kernel (counted in
    ``stream_bwd_dku.launches``); CPU tensors take the plain version."""
    n, m_pat, d_in, d_out = _check(x2, K, U, s, t, g, m, l, delta)
    if x2.device.type == "cpu":
        return stream_bwd_dku_reference(x2, K, U, s, t, g, m, l, delta)
    _require_cuda(x2)
    stem = "hopfield_stream_bwd_dku"
    dk = torch.empty(m_pat, d_in, device=x2.device)
    du = torch.empty(m_pat, d_out, device=x2.device)
    floats = _workspace_floats(stem, f"{stem}_workspace", n, m_pat, d_in, d_out)
    work = torch.empty(floats, device=x2.device)
    launch(stem, _bind(stem, stem, 12, 4), x2.device,
            *(a.data_ptr() for a in (x2, K, U, s, t, g, m, l, delta, dk, du, work)),
            n, m_pat, d_in, d_out)
    stream_bwd_dku.launches += 1
    return dk, du


stream_bwd_dku.launches = 0


class StreamLookup(torch.autograd.Function):
    """``softmax(β · LN(x2) Kᵀ) @ U`` with the state LayerNorm's ``s``,
    ``t``, differentiable in all five inputs (JAX's ``_attn_ln_stream``).
    The output shift ``b`` is added by the caller."""

    @staticmethod
    def forward(ctx, x2, K, U, s, t):
        out, m, l = stream_lookup_fwd(x2, K, U, s, t)
        ctx.save_for_backward(x2, K, U, s, t, m, l, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2, K, U, s, t, m, l, out = ctx.saved_tensors
        g = g.float().contiguous()
        delta = (g * out).sum(-1, keepdim=True)
        dx, ds, dt = stream_bwd_dx(x2, K, U, s, t, g, m, l, delta)
        dk, du = stream_bwd_dku(x2, K, U, s, t, g, m, l, delta)
        return dx, dk, du, ds, dt


def stream_lookup(x2, K, U, s, t):
    """The differentiable streaming lookup of ``x2 (N, d_in)``: the kernels
    on CUDA tensors, their plain versions on CPU tensors."""
    return StreamLookup.apply(x2, K, U, s, t)


def hopfield_lookup_stream(layer: HopfieldLookup, x: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """One lookup of ``x (..., d_in)`` with folded tables, differentiable.
    ``impl="cuda"`` launches the kernels and needs CUDA tensors;
    ``impl="torch"`` takes their plain versions and needs CPU tensors."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    want = "cuda" if impl == "cuda" else "cpu"
    if x.device.type != want:
        other = "torch" if impl == "cuda" else "cuda"
        raise ValueError(f"impl={impl!r} needs {want.upper()} tensors, got {x.device}; use impl={other!r}")
    k, u, b, s, t = fold_layer(layer)
    *lead, d = x.shape
    out = stream_lookup(x.reshape(-1, d).contiguous(), k, u, s, t)
    return (out + b).reshape(*lead, u.shape[1])
