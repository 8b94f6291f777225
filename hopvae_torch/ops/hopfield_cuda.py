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
``(N, M)`` matrix never reaches device memory. All three run their
products on the tensor cores in three TF32 passes. Each wrapper launches
its kernel on CUDA tensors (counting the launch in its ``launches``
through ``nvcc.count``: a launch inside a CUDA graph's capture counts at
each replay) and takes its plain version on CPU tensors:
``stream_lookup_fwd_reference`` and ``stream_lookup_bwd_reference``, which
hold the ``(N, M)`` matrices.

Widths: the plain versions and the kernels take every ``(d_in, d_out)``
of at least 1 (:func:`kernel_takes`), as the Pallas kernels do. Up to
``BUILT_WIDTH`` on both sides a call runs on a built instance, zero-padded
in shared memory; past it on either side on the wide variants, q built
first (:func:`kernel_route` names the route). The wide kernels run on a
thread-block cluster (``csrc/hopfield_cluster.cuh``: the depth split
across the blocks of a cluster, each tile's scores computed once) where
:func:`forward_cluster` (K1) and :func:`backward_cluster` (K2, K3) say
so, and elsewhere on the window kernels (``csrc/hopfield_wide.cuh``: every
product's depth streamed in chunks of 64, the outputs in column windows of
128 on a grid axis, each window recomputing the scores).

Pattern sharding (JAX's ``_attn_tp_merge``, ``_attn_ln_stream_tp``):
:class:`ShardedStreamLookup` runs K1 on each pattern shard's rows and
merges the shards' ``(out, m, l)`` (:func:`merge_lookup_stats`, its two
reductions passed in: :class:`LocalShards` in one process, or a rank's
model group, ``parallel.mesh.PatternGroup``); its backward runs K2 and K3
on each shard fed the merged stats. No kernel of its own.

K4 ``csrc/hopfield_bottleneck_fused.cu`` (:func:`bottleneck_fused_fwd`,
plain version :func:`bottleneck_fused_fwd_reference`) is the port of the
TPU's single-shot fused bottleneck forward ``_kernel``: the three lookups
(K1's pattern walk three times), the sigmoid and the round in one launch,
for lookups that chain as ``(d, d), (d, di), (di, d)``; past
``BUILT_WIDTH`` each of its three stages takes K1's wide route (cluster or
window kernel by the stage's widths), a launch each. As in the JAX
package, no entry point routes to it: serving and training run the
streaming lookups.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hopvae_torch.ops.hopfield import LN_EPS, HopfieldLookup
from hopvae_torch.utils.nvcc import bind, count, kernel_attributes, launch, load_library

SUPPORTED = ((64, 64), (64, 3), (3, 64))  # the bottleneck's (d_in, d_out) at the configs' default widths
BUILT_WIDTH = 256  # K1 to K4 have built instances up to this width on both sides; wider runs the wide variants
CLUSTER_MAX = 8192  # the wide K1 to K4 run on a cluster up to this wider side (16 blocks of 512 columns)
WINDOW_IN = 128  # and past this d_in (K1: and d_out), where the window kernels have more than one window
IMPLS = ("cuda", "torch")


def kernel_takes(d_in: int, d_out: int) -> bool:
    """Whether K1, K2 and K3 (and K4, for each of its lookups) take the
    widths ``(d_in, d_out)`` on the card: every width of at least 1."""
    return d_in >= 1 and d_out >= 1


def kernel_route(d_in: int, d_out: int) -> str:
    """``"instance"`` where both widths are at most ``BUILT_WIDTH`` (a
    built instance, zero-padded), ``"wide"`` past it on either side."""
    if not kernel_takes(d_in, d_out):
        raise ValueError(f"widths must be at least 1, got {(d_in, d_out)}")
    return "instance" if max(d_in, d_out) <= BUILT_WIDTH else "wide"


def forward_cluster(d_in: int, d_out: int) -> bool:
    """Whether K1 (and a wide stage of K4) runs on its thread-block
    cluster at ``(d_in, d_out)``: where K2 and K3 do
    (:func:`backward_cluster`), with ``d_out`` past ``WINDOW_IN`` too
    (``fwd_plan`` in ``csrc/hopfield_cluster.cuh``): up to it the window
    kernel has one window, computes each score once, and ran faster. Other
    wide widths take the window kernel."""
    return backward_cluster(d_in, d_out) and d_out > WINDOW_IN


def backward_cluster(d_in: int, d_out: int) -> bool:
    """Whether K2 and K3 run on their thread-block cluster at ``(d_in,
    d_out)``: past ``BUILT_WIDTH`` and up to ``CLUSTER_MAX`` on the
    wider side, with ``d_in`` past ``WINDOW_IN`` (``plan`` in
    ``csrc/hopfield_cluster.cuh``). Other wide widths take the window
    kernels."""
    return kernel_route(d_in, d_out) == "wide" and d_in > WINDOW_IN and max(d_in, d_out) <= CLUSTER_MAX


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
    stem = "hopfield_stream_fwd"
    ptrs = [a.data_ptr() for a in (x2, K, U, s, t, out, m_stat, l_stat)]
    if kernel_route(d_in, d_out) == "wide":
        work = torch.empty(_workspace_floats(stem, f"{stem}_workspace", n, m, d_in, d_out), device=x2.device)
        launch(stem, _bind(stem, f"{stem}_wide", 9, 4), x2.device, *ptrs, work.data_ptr(), n, m, d_in, d_out)
    else:
        launch(stem, _bind(stem, stem, 8, 4), x2.device, *ptrs, n, m, d_in, d_out)
    count(stream_lookup_fwd)
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
    work = torch.empty(_workspace_floats(stem, f"{stem}_workspace", n, m_pat, d_in, d_out), device=x2.device)
    launch(stem, _bind(stem, stem, 13, 4), x2.device,
            *(a.data_ptr() for a in (x2, K, U, s, t, g, m, l, delta, dx, ds, dt, work)),
            n, m_pat, d_in, d_out)
    count(stream_bwd_dx)
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
    count(stream_bwd_dku)
    return dk, du


stream_bwd_dku.launches = 0


def _cluster(stem: str, entry: str, d_in: int, d_out: int) -> dict:
    """The cluster of ``(d_in, d_out)`` through ``<entry>(d_in, d_out,
    out)`` of ``csrc/<stem>.cu``: its blocks, the depth slice a block owns
    at most, the clusters the card holds at once and whether that is
    positive (a cluster that cannot be held cannot launch)."""
    out = (ctypes.c_int * 3)()
    err = getattr(load_library(stem), entry)(d_in, d_out, out)
    if err != 0:
        raise RuntimeError(f"{entry}{(d_in, d_out)} failed: cudaError {err}")
    return {"cluster": out[0], "slice": out[1], "active_clusters": out[2], "cluster_ok": out[2] > 0}


def forward_attributes(d_in: int, d_out: int) -> dict:
    """K1's build for ``(d_in, d_out)`` as the card reports it: registers
    and spilled (local) bytes a thread, dynamic shared bytes, threads a
    block, blocks an SM, and its tiles (token rows resident, patterns
    streamed). Where it runs on its cluster (:func:`forward_cluster`)
    also the cluster, as :func:`backward_attributes`. Launches nothing."""
    stem = "hopfield_stream_fwd"
    attrs = kernel_attributes(stem, d_in, d_out)
    if forward_cluster(d_in, d_out):
        attrs |= _cluster(stem, f"{stem}_cluster", d_in, d_out)
    return attrs


def fused_attributes(d: int, di: int) -> dict:
    """K4's build for the bottleneck widths ``(d, di)``, as
    :func:`forward_attributes` (the streamed tile is its first lookup's;
    past ``BUILT_WIDTH`` its first stage's kernel). Past ``BUILT_WIDTH``
    also ``stages``: for each stage's widths, its cluster where it runs
    on one (:func:`forward_cluster`), else ``{"cluster": None}`` (the
    window kernel)."""
    stem = "hopfield_bottleneck_fused"
    attrs = kernel_attributes(stem, d, di)
    if kernel_route(d, di) == "wide":
        attrs["stages"] = {f"{a}x{b}": _cluster(stem, f"{stem}_cluster", a, b) if forward_cluster(a, b)
                           else {"cluster": None} for a, b in ((d, d), (d, di), (di, d))}
    return attrs


def backward_attributes(kernel: str, d_in: int, d_out: int) -> dict:
    """K2's (``kernel="dx"``) or K3's (``"dku"``) build for ``(d_in, d_out)``
    as the card reports it: registers and spilled (local) bytes a thread,
    dynamic shared bytes, threads a block, blocks an SM, and its tiles
    (token rows resident and patterns streamed in K2; patterns resident
    and token rows streamed in K3). Where they run on their cluster
    (:func:`backward_cluster`) also the cluster (:func:`_cluster`).
    Launches nothing."""
    stem = f"hopfield_stream_bwd_{kernel}"
    attrs = kernel_attributes(stem, d_in, d_out)
    if backward_cluster(d_in, d_out):
        attrs |= _cluster(stem, f"{stem}_cluster", d_in, d_out)
    return attrs


def _folded(layers) -> list:
    """The three lookups' folded tables, contiguous, in the kernel's order
    ``(K, U, b, s, t)`` each."""
    return [[a.contiguous() for a in fold_layer(layer)] for layer in layers]


def fused_widths(layers) -> tuple[int, int]:
    """``(d, di)`` of three lookups that chain as the bottleneck's do,
    ``(d, d), (d, di), (di, d)``; ``ValueError`` where they do not."""
    widths = tuple((layer.d_in, layer.out_proj.weight.shape[0]) for layer in layers)
    (d, d1), (d2, di), (di3, d3) = widths
    if not d == d1 == d2 == d3 or di != di3:
        raise ValueError(f"the lookups' (d_in, d_out) are {widths}: they must chain as (d, d), (d, di), (di, d)")
    return d, di


def bottleneck_fused_fwd_reference(hopfield: HopfieldLookup, embedding_to_index: HopfieldLookup,
                                   index_to_embedding: HopfieldLookup, x: torch.Tensor, num_levels: int):
    """Plain torch version of K4: ``(e, zq, r)`` of the bottleneck for
    ``x (..., d)``, each lookup through :func:`stream_lookup_fwd_reference`
    with its shift added, the index rounded half to even."""
    *lead, d = x.shape
    (k1, u1, b1, s1, t1), (k2, u2, b2, s2, t2), (k3, u3, b3, s3, t3) = _folded(
        (hopfield, embedding_to_index, index_to_embedding))
    e = stream_lookup_fwd_reference(x.reshape(-1, d), k1, u1, s1, t1)[0] + b1
    logits = stream_lookup_fwd_reference(e, k2, u2, s2, t2)[0] + b2
    zq = torch.round(torch.sigmoid(logits) * (num_levels - 1))
    r = stream_lookup_fwd_reference(zq / (num_levels - 1), k3, u3, s3, t3)[0] + b3
    return e.reshape(*lead, d), zq.reshape(*lead, zq.shape[-1]), r.reshape(*lead, d)


def bottleneck_fused_fwd(hopfield: HopfieldLookup, embedding_to_index: HopfieldLookup,
                         index_to_embedding: HopfieldLookup, x: torch.Tensor, num_levels: int):
    """K4: ``(e, zq, r)`` of the bottleneck for ``x (..., d)`` in one
    launch, the tables folded by :func:`fold_layer`; the lookups chain as
    ``(d, d), (d, di), (di, d)`` (:func:`fused_widths`).

    CUDA tensors launch the kernel (counted in
    ``bottleneck_fused_fwd.launches``, once a call: past ``BUILT_WIDTH``
    the call's three stages take K1's wide route, launches of their own);
    CPU tensors take the plain version. Forward-only: on the card, with
    autograd on and a parameter or ``x`` that needs a gradient, it raises
    (the streaming bottleneck is the differentiable path)."""
    layers = (hopfield, embedding_to_index, index_to_embedding)
    d, di = fused_widths(layers)
    if x.dtype != torch.float32 or x.shape[-1] != d:
        raise ValueError(f"x must be float32 (..., {d}), got {x.dtype} {tuple(x.shape)}")
    if num_levels < 2:
        raise ValueError(f"num_levels must be at least 2, got {num_levels}")
    if x.device.type == "cpu":
        return bottleneck_fused_fwd_reference(*layers, x, num_levels)
    params = [p for layer in layers for p in layer.parameters()]
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, *params)):
        raise RuntimeError("bottleneck_fused_fwd is forward-only: run it under torch.no_grad or "
                           "torch.inference_mode, or differentiate the streaming bottleneck")
    _require_cuda(x)
    *lead, _ = x.shape
    x2 = x.reshape(-1, d).contiguous()
    n = x2.shape[0]
    if n == 0:
        raise ValueError("x needs at least one token")
    tables = _folded(layers)
    e = torch.empty(n, d, device=x.device)
    zq = torch.empty(n, di, device=x.device)
    r = torch.empty(n, d, device=x.device)
    stem = "hopfield_bottleneck_fused"
    ptrs = [x2.data_ptr(), *(a.data_ptr() for table in tables for a in table), e.data_ptr(), zq.data_ptr(),
            r.data_ptr()]
    sizes = (n, *(table[0].shape[0] for table in tables), d, di, num_levels)
    if kernel_route(d, di) == "wide":
        work = torch.empty(_workspace_floats(stem, f"{stem}_workspace", n, d, di), device=x.device)
        launch(stem, _bind(stem, f"{stem}_wide", 20, 7), x.device, *ptrs, work.data_ptr(), *sizes)
    else:
        launch(stem, _bind(stem, stem, 19, 7), x.device, *ptrs, *sizes)
    count(bottleneck_fused_fwd)
    return e.reshape(*lead, d), zq.reshape(*lead, di), r.reshape(*lead, d)


bottleneck_fused_fwd.launches = 0


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


# ------------------------------------------------------ sharded patterns


def merge_lookup_stats(o, m, l, pmax, psum):
    """The softmax merge of pattern shards (JAX's ``_attn_tp_merge``):
    ``(out, gm, gl)`` from each shard's K1 output ``o`` and row stats ``m``,
    ``l`` (natural-log units of the β-scaled scores, as
    :func:`stream_lookup_fwd_reference` gives them)::

        gm = max_r m      w = l · exp(m - gm)      gl = Σ_r w      out = Σ_r o · w / gl

    ``pmax`` and ``psum`` are the two reductions over the shards, passed
    in: over a stacked shard axis in one process (:class:`LocalShards`), or
    across a model group of ranks (``parallel.mesh.PatternGroup``). ``gm``
    and ``gl`` are the unsharded lookup's ``m`` and ``l``."""
    gm = pmax(m)
    w = l * torch.exp(m - gm)
    gl = psum(w)
    return psum(o * w) / gl, gm, gl


class LocalShards:
    """``n`` pattern shards held in one process: ``split`` cuts a table into
    its row blocks, and the reductions run over the stacked shard axis
    (the tests' and the chip check's stand-in for a model group)."""

    def __init__(self, n: int):
        self.n = n

    def split(self, t: torch.Tensor) -> tuple:
        if t.shape[0] % self.n:
            raise ValueError(f"{t.shape[0]} patterns do not split into {self.n} shards")
        return t.chunk(self.n)

    def max(self, a: torch.Tensor) -> torch.Tensor:
        return a.amax(0, keepdim=True)

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        return a.sum(0, keepdim=True)


class ShardedStreamLookup(torch.autograd.Function):
    """:class:`StreamLookup` over pattern shards (JAX's ``_attn_ln_stream_tp``):
    ``K`` and ``U`` hold this rank's rows, which ``group.split`` cuts into
    the shards it runs here (one on a rank of a model group). The forward
    runs K1 on each shard and merges by :func:`merge_lookup_stats`; the
    backward feeds the merged ``gm``, ``gl`` and output into K2 and K3 on
    each shard, and sums the partial ``dx``, ``ds`` and ``dt`` over the
    shards. ``dK`` and ``dU`` are the shards' own rows, complete. The
    cotangent is not reduced: every rank of a model group holds all of it
    (JAX's ``psum`` of it undoes shard_map's split, which torch has not)."""

    @staticmethod
    def forward(ctx, x2, K, U, s, t, group):
        parts = [stream_lookup_fwd(x2, k, u, s, t) for k, u in zip(group.split(K), group.split(U))]
        out, gm, gl = (a[0] for a in merge_lookup_stats(*(torch.stack(p) for p in zip(*parts)), group.max,
                                                         group.sum))
        ctx.group = group
        ctx.save_for_backward(x2, K, U, s, t, gm, gl, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2, K, U, s, t, gm, gl, out = ctx.saved_tensors
        group = ctx.group
        g = g.float().contiguous()
        delta = (g * out).sum(-1, keepdim=True)
        dx, ds, dt, dk, du = [], [], [], [], []
        for k, u in zip(group.split(K), group.split(U)):
            for acc, a in zip((dx, ds, dt), stream_bwd_dx(x2, k, u, s, t, g, gm, gl, delta)):
                acc.append(a)
            for acc, a in zip((dk, du), stream_bwd_dku(x2, k, u, s, t, g, gm, gl, delta)):
                acc.append(a)
        dx, ds, dt = (group.sum(torch.stack(a))[0] for a in (dx, ds, dt))
        return dx, torch.cat(dk), torch.cat(du), ds, dt, None


def hopfield_lookup_stream(layer: HopfieldLookup, x: torch.Tensor, impl: str = "cuda", group=None) -> torch.Tensor:
    """One lookup of ``x (..., d_in)`` with folded tables, differentiable.
    ``impl="cuda"`` launches the kernels and needs CUDA tensors;
    ``impl="torch"`` takes their plain versions and needs CPU tensors.
    With a ``group`` (:class:`LocalShards`, or a rank's
    ``parallel.mesh.PatternGroup``) the layer's ``lookup_weights`` are this
    rank's rows and the lookup runs :class:`ShardedStreamLookup`."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    want = "cuda" if impl == "cuda" else "cpu"
    if x.device.type != want:
        other = "torch" if impl == "cuda" else "cuda"
        raise ValueError(f"impl={impl!r} needs {want.upper()} tensors, got {x.device}; use impl={other!r}")
    k, u, b, s, t = fold_layer(layer)
    *lead, d = x.shape
    x2 = x.reshape(-1, d).contiguous()
    out = stream_lookup(x2, k, u, s, t) if group is None else ShardedStreamLookup.apply(x2, k, u, s, t, group)
    return (out + b).reshape(*lead, u.shape[1])
