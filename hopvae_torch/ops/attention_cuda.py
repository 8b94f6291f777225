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
``(S, S)`` matrices never reach device memory. All three run every product
on the tensor cores in three TF32 passes of their own (f32-grade, whatever
``torch.backends.cuda.matmul.allow_tf32`` says). The inputs may be strided
views (the prior's q, k and v are slices of one projection); only the
head width must be contiguous. The kernels take the head widths of
``HEAD_DIMS`` on built instances, and every multiple of ``WIDE_STEP`` past
the last of them on wide instances: up to ``BWD_WIDE_MAX`` the forward
and the backward split the depth across the blocks of a thread-block
cluster, which compute each tile's scores once
(:func:`forward_attributes` and :func:`backward_attributes` name the
cluster); past it the forward runs its window kernel over windows of
output columns, on causal scores computed once, split over the card
first, where their scratch fits (:func:`forward_workspace` is then more
than 0), else streaming q and k in depth chunks in every window; the
backward raises there.
:func:`kernel_width` names the width that any other head is zero-padded
to. Each wrapper launches its kernel
on CUDA tensors, counting the launch in its ``launches`` (through
``nvcc.count``: a launch inside a CUDA graph's capture counts at each
replay), and takes its plain version on CPU tensors; the plain versions hold the ``(S, S)``
matrices.
"""

from __future__ import annotations

import ctypes

import torch

from hopvae_torch.utils.nvcc import bind, count, kernel_attributes, launch, load_library

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the head widths of the built instances
WIDE_STEP = 128  # past HEAD_DIMS[-1], the wide kernels take every multiple of this
BWD_WIDE_MAX = 8192  # the widest cluster, 16 blocks of 512 columns: the backward's widest head


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


def kernel_width(dh: int) -> int:
    """The narrowest head width the kernels take that holds ``dh``: one of
    ``HEAD_DIMS``, or past them the next multiple of ``WIDE_STEP``."""
    if dh < 1:
        raise ValueError(f"head width must be at least 1, got {dh}")
    for width in HEAD_DIMS:
        if dh <= width:
            return width
    return -(-dh // WIDE_STEP) * WIDE_STEP


def forward_workspace(b: int, s: int, h: int, dh: int) -> int:
    """Floats of device scratch that K5-fwd takes at ``(B, S, heads, dh)``,
    as the built library plans it (``causal_attention_fwd_workspace``):
    past ``BWD_WIDE_MAX``, where the window kernel computes the causal
    scores once, split over the card first (each depth chunk of 64 apart,
    then added in chunk order into ``(B·heads, S, S)``, from which every
    window of output columns replays its online softmax), the chunks' sums
    and S; 0 where that scratch would pass the plan's cap and every window
    recomputes the scores (the same bits), and at every other width."""
    fn = load_library("causal_attention_fwd").causal_attention_fwd_workspace
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return fn(b, s, h, dh)


def _require_kernel(q, dh: int, widest: int | None = None) -> None:
    if kernel_width(dh) != dh:
        raise ValueError(f"head width {dh} is not one the kernels take ({HEAD_DIMS} or a multiple of "
                         f"{WIDE_STEP} past them): flash_causal_attention zero-pads it")
    if widest is not None and dh > widest:
        raise ValueError(f"head width {dh} is past {widest}, the widest the backward kernels take")
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
    launch(name, bind(stem, name, argtypes), device, *(None if a is None else a.data_ptr() for a in ptrs), *shape,
           *strides, scale)


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
    floats = forward_workspace(b, s, h, dh) if dh > BWD_WIDE_MAX else 0
    work = torch.empty(floats, device=q.device) if floats else None
    _launch("causal_attention_fwd", (q, k, v, out, lse, work), (q, k, v), (b, s, h, dh), scale, q.device)
    count(causal_attention_fwd)
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
    _require_kernel(q, dh, BWD_WIDE_MAX)
    dk = torch.empty(b, s, h, dh, device=q.device)
    dv = torch.empty(b, s, h, dh, device=q.device)
    _launch("causal_attention_bwd_dkv", (q, k, v, g, lse, delta, dk, dv), (q, k, v, g), (b, s, h, dh),
            scale, q.device)
    count(causal_attention_bwd_dkv)
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
    _require_kernel(q, dh, BWD_WIDE_MAX)
    dq = torch.empty(b, s, h, dh, device=q.device)
    _launch("causal_attention_bwd_dq", (q, k, v, g, lse, delta, dq), (q, k, v, g), (b, s, h, dh),
            scale, q.device)
    count(causal_attention_bwd_dq)
    return dq


causal_attention_bwd_dq.launches = 0

def _cluster(attrs: dict, stem: str, name: str, *args: int) -> dict:
    """``attrs`` with the cluster that ``lib.name(args..., out)`` reports:
    its blocks, the depth slice a block owns at most, the clusters the card
    holds at once and whether that is positive (a cluster that cannot be
    held cannot launch)."""
    out = (ctypes.c_int * 3)()
    err = getattr(load_library(stem), name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}{args} failed: cudaError {err}")
    return {**attrs, "cluster": out[0], "slice": out[1], "active_clusters": out[2], "cluster_ok": out[2] > 0}


def forward_attributes(dh: int) -> dict:
    """K5-fwd's build at head width ``dh`` as the card reports it (past
    256 the wide instance's): registers and spilled (local) bytes a
    thread, dynamic shared bytes, threads a block and blocks an SM, and
    its tiles (query rows resident, keys streamed). Past 256 up to
    ``BWD_WIDE_MAX`` also the cluster, as :func:`backward_attributes`
    reports it. Launches nothing."""
    attrs = kernel_attributes("causal_attention_fwd", dh)
    if HEAD_DIMS[-1] < dh <= BWD_WIDE_MAX:
        attrs = _cluster(attrs, "causal_attention_fwd", "causal_attention_fwd_cluster", dh)
    return attrs


def backward_attributes(kernel: str, dh: int) -> dict:
    """K5-dkv's (``kernel="dkv"``) or K5-dq's (``"dq"``) build at head width
    ``dh``, as :func:`forward_attributes` reports it (resident and streamed
    rows: keys and query rows in K5-dkv, query rows and keys in K5-dq).
    Past 256 also the cluster: its blocks, the depth slice a block owns at
    most, the clusters the card holds at once and whether that is positive
    (a cluster that cannot be held cannot launch). Launches nothing."""
    dkv = int(kernel == "dkv")
    attrs = kernel_attributes("causal_attention_bwd", dh, dkv)
    if dh > HEAD_DIMS[-1]:
        attrs = _cluster(attrs, "causal_attention_bwd", "causal_attention_bwd_cluster", dh, dkv)
    return attrs


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
