"""Widths past 256: the dispatch of K1 to K5, their routes against JAX,
and the wide kernels' precision scheme emulated on the CPU.

Past a width of 256 the streaming lookups (K1 to K4) run their wide
variants. Up to 8192 K5's forward and backward, the lookups' backward K2
and K3 (with d_in past 128) and forward K1 (with d_in and d_out past
128; K4's stages likewise) split the depth across the blocks of a
cluster: each block's slice of 128 (256 past 1024, 512 past 2048) in
warp parts of 64, each part in a fresh sum, the parts of a slice added
in order, the slices in rank order, the small TF32 parts truncated
(``cluster_tf32``); the products over keys, query rows, patterns or
tokens by tiles of 32 (16 past 1024). Elsewhere the window kernels run:
each product's depth streamed in chunks of 64, each chunk's three-pass
TF32 products summed in a fresh sum and added to the running one, the
outputs in column windows. The plain versions that the CPU runs hold the
same functions at any width; ``tests/test_torch_hopfield.py`` holds them
against the Pallas kernels in interpret mode at (384, 3), (3, 384) and
(300, 520). Here: the dispatch rules; a head of 320 through the kernels'
zero padding and a Transformer prior with one head of 512 against JAX;
and the three-pass schemes at width 512 (the cluster's also at 384 and
1280; K1's, K2's and K3's at 512 → 512, (384, 3), (3, 384) and (300,
700), K1's also at (384, 384), (1280, 300) and (300, 2304)) against the
plain versions, within the limits ``chip_smoke.py`` holds the kernels
to. Measured here (N 300, M 1024, 512 → 512; K5 at B 2, S 48, one head),
three passes: K1 out 6.9e-7, m 5.5e-7, l 1.9e-6 from the plain version,
in the cluster's order at most 1.1e-6, 1.1e-6 and 3.8e-6 at the seven
widths (from float64 3.7e-7, 2.7e-7, 9.9e-7), the attention K2 and K3
rebuild from the wide K1's stats summing to 1 within 1.5e-7 a row (at
most 1.46e-7, at (384, 3), where K1's window order meets K2's cluster
order); K2 and K3 normwise at most 1.3e-6, in the cluster's order
1.5e-6, 2.7e-6, 3.7e-6 and 1.8e-6 at the four widths (from float64
4.7e-7 to 1.2e-6); K5 in the window kernel's order at 512 forward
5.1e-7, backward 5.6e-7; in the cluster's order at 384, 512 and 1280
forward 4.5e-7, 5.5e-7 and 3.1e-7, backward 1.1e-6, 4.8e-7 and 8.4e-7.
One pass: K1's m 3.0e-4 and l 1.1e-3 from float64 (the cluster's order
8.5e-4 to 2.3e-3), K2 and K3 7.1e-4 (the cluster's order 7.1e-4 to
5.2e-3), K5's forward 4.6e-4 (the cluster's order 3.6e-4 to 4.6e-4), the
cluster's backward 5.7e-4 to 6.8e-4.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.ops import attention as jax_attention
from hopvae_torch.ops import attention as A
from hopvae_torch.ops import attention_cuda as ac
from hopvae_torch.ops import hopfield_cuda as hc
from test_torch_hopfield_tf32 import (BWD_NORMWISE, OUT_ATOL, STAT_RTOL, _float64_backward, _float64_forward,
                                      _forward_errors, _normwise, round_tf32)
from test_torch_attention_tf32 import ATTN_BWD_NORMWISE, ATTN_FWD_NORMWISE
from test_torch_prior import _jax_nll_bits, _nll_bits, _pair, _prior_state

DC = 64  # the wide kernels' depth chunk
TILE = 32  # their streamed tile (patterns in K1, K2; tokens in K3; keys in K5)


@pytest.mark.parametrize("width,padded", [(257, 384), (300, 384), (384, 384), (512, 512), (1000, 1024)])
def test_widths_past_256_are_taken(width, padded):
    """K1 to K4 take every width on their wide variants, whichever side is
    past 256; K5 takes every multiple of 128 past 256, and its route pads
    any other width to the next one. Nothing raises."""
    for d_in, d_out in ((width, 3), (3, width), (width, width)):
        assert hc.kernel_takes(d_in, d_out) and hc.kernel_route(d_in, d_out) == "wide"
    # K1 to K3 (and K4's wide stages) on their clusters where both widths pass 128; (width, 3) and (3, width)
    # on the narrow-side kernels, (width, 3) in the cluster's order
    assert hc.on_cluster(width, width) and not hc.on_cluster(width, 3) and not hc.on_cluster(3, width)
    assert hc.cluster_order(width, 3) and not hc.cluster_order(3, width)
    assert ac.kernel_width(width) == padded
    assert ac.kernel_width(padded) == padded


@pytest.mark.parametrize("d_in,d_out,cluster", [(129, 300, True), (128, 300, False), (8192, 3, False),
                                                (8320, 3, False), (3, 8192, False), (256, 256, False),
                                                (384, 3, False), (300, 64, False), (384, 200, True)])
def test_lookup_backward_route(d_in, d_out, cluster):
    """Where K2 and K3 run on their cluster (``hopfield_cluster::plan``,
    K1's too): past 256 on the wider side up to 8192, with d_in and d_out
    past 128 (with d_in up to 128 dq and dK have one window; with d_out up
    to 128 their whole window or their split products compute each score
    once); elsewhere past 256 on the narrow-side kernels, up to 256 on the
    built instances."""
    assert hc.on_cluster(d_in, d_out) == cluster


@pytest.mark.parametrize("d_in,d_out,cluster", [(257, 129, True), (129, 300, True), (128, 300, False),
                                                (300, 128, False), (384, 3, False), (3, 384, False),
                                                (384, 384, True), (8192, 129, True), (8320, 300, False),
                                                (256, 256, False)])
def test_lookup_forward_route(d_in, d_out, cluster):
    """Where K1 (and each wide stage of K4) runs on its cluster
    (``hopfield_cluster::plan``): past 256 on the wider side up to
    8192, with both d_in and d_out past 128 (up to 128 on either side the
    window kernel computes each score once, or recomputes only scores of
    that depth, and ran faster). Elsewhere past 256 the window kernel
    runs; up to 256 the built instances."""
    assert hc.on_cluster(d_in, d_out) == cluster


def test_padded_wide_head_matches_jax(monkeypatch):
    """A head of 320 through ``kernel_causal_attention``: zero-padded to
    384, the wide kernels' width, then ``FlashCausalAttention`` on the
    plain versions, against JAX's ``flash_causal_attention`` (blocked off
    the TPU). Values within rtol 1e-5, atol 1e-6; the gradients of
    ``sum(out * w)`` within rtol 1e-4, atol 1e-5 (tests/test_torch_attention.py)."""
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.standard_normal((2, 37, 1, 320), dtype=np.float32) for _ in range(4))
    jflash = jax_attention.flash_causal_attention
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v))))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jflash(q, k, v) * w), (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    widths = []
    fwd = ac.causal_attention_fwd
    monkeypatch.setattr(ac, "causal_attention_fwd", lambda q, *rest: widths.append(q.shape[-1]) or fwd(q, *rest))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = A.kernel_causal_attention(*leaves, 1 / math.sqrt(320))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    for leaf, g, name in zip(leaves, jgrads, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=f"d{name}")
    assert widths == [384]


def test_one_head_of_512_prior_matches_jax():
    """``--set prior_d_model=512 --set prior_heads=1 --set prior_attn=flash``
    at a tiny size (one layer, S = 48): the head of 512 takes the wide
    kernels unpadded on the card, the blocked path on the CPU. Logits
    within rtol 1e-4, atol 1e-5 and every parameter's NLL gradient within
    rtol 5e-4, atol 1e-6 of JAX (tests/test_torch_prior.py)."""
    jprior, params, prior, cfg = _pair(prior_d_model=512, prior_heads=1, prior_layers=1, prior_attn="flash")
    assert prior.blocks[0].attn == jprior.attn == "flash" and ac.kernel_width(512) == 512
    rng = np.random.default_rng(6)
    g = rng.integers(0, cfg.num_levels, (2, 4, 4, 3)).astype(np.float32)
    want = jax.jit(jprior.forward)(params, jnp.asarray(g))
    jgrads = jax.jit(jax.grad(lambda p: _jax_nll_bits(jprior.forward(p, jnp.asarray(g)), jnp.asarray(g))))(params)
    got = prior(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _nll_bits(got, torch.from_numpy(g)).backward()
    want_grads = _prior_state(jgrads)
    for name, p in prior.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------ the scheme at 512


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of f32 values, as the tensor cores read a TF32
    operand passed whole (truncation)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def chunked_tf32(a: torch.Tensor, b: torch.Tensor, passes: int, chunk: int = DC, trunc: bool = False) -> torch.Tensor:
    """``a @ b`` over the last axis of ``a`` as the wide kernels run a
    product: 8-deep steps of one or three TF32 passes (small·big,
    big·small, big·big), each ``chunk`` of the depth summed in a fresh f32
    sum that is added to the running one. ``trunc``: the small parts
    truncated, not rounded (the wide backward's split)."""
    a_big, b_big = round_tf32(a), round_tf32(b)
    small = trunc_tf32 if trunc else round_tf32
    a_small, b_small = small(a - a_big), small(b - b_big)
    total = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], chunk):
        part = torch.zeros_like(total)
        for k0 in range(c0, min(c0 + chunk, a.shape[-1]), 8):
            ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
            if passes == 3:
                part = part + a_small[ka] @ b_big[kb]
                part = part + a_big[ka] @ b_small[kb]
            part = part + a_big[ka] @ b_big[kb]
        total = total + part
    return total


def wide_forward(x2, K, U, s, t, passes):
    """``(out, m, l)`` of the wide forward walk: the scores over depth
    chunks, an online softmax over pattern tiles of 32, each tile's ``P U``
    in a fresh sum, the denominator a compensated sum."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    q = hc._query(hc._state_ln(x2)[0], s, t)
    n = x2.shape[0]
    m, l, l_lo = torch.full((n, 1), -1e30), torch.zeros(n, 1), torch.zeros(n, 1)
    acc = torch.zeros(n, U.shape[1])
    for p0 in range(0, K.shape[0], TILE):
        sc = chunked_tf32(q, K[p0:p0 + TILE].T.contiguous(), passes) * beta
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        a, b = l * alpha, l_lo * alpha + p.sum(-1, keepdim=True)
        total = a + b
        bb = total - a
        l, l_lo = total, (a - (total - bb)) + (b - bb)
        acc = acc * alpha + chunked_tf32(p, U[p0:p0 + TILE].contiguous(), passes, chunk=TILE)
        m = m_new
    l = l + l_lo
    return acc / l, m, l


def cluster_forward(x2, K, U, s, t, passes):
    """``(out, m, l)`` of the wide forward in its cluster kernel's order:
    the scores through :func:`cluster_tf32` with the slice the plan picks
    from the wider of ``d_in`` and ``d_out`` (a narrower side's last slice
    holds only its real columns, as the kernel's zero padding leaves it),
    an online softmax over the plan's pattern tiles with the compensated
    denominator, each tile's ``P U`` in a fresh sum with the small parts
    truncated."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    q = hc._query(hc._state_ln(x2)[0], s, t)
    slice_, tile = _cluster_plan(max(x2.shape[1], U.shape[1]))
    n = x2.shape[0]
    m, l, l_lo = torch.full((n, 1), -1e30), torch.zeros(n, 1), torch.zeros(n, 1)
    acc = torch.zeros(n, U.shape[1])
    for p0 in range(0, K.shape[0], tile):
        sc = cluster_tf32(q, K[p0:p0 + tile].T.contiguous(), passes, slice_=slice_) * beta
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        a, b = l * alpha, l_lo * alpha + p.sum(-1, keepdim=True)
        total = a + b
        bb = total - a
        l, l_lo = total, (a - (total - bb)) + (b - bb)
        acc = acc * alpha + chunked_tf32(p, U[p0:p0 + tile].contiguous(), passes, chunk=tile, trunc=True)
        m = m_new
    l = l + l_lo
    return acc / l, m, l


def wide_backward(x2, K, U, s, t, g, m, l, delta, passes, cluster: bool = False):
    """``(dx, dK, dU, ds, dt)`` of the wide K2 and K3: ``q Kᵀ`` and ``g Uᵀ``
    over depth chunks, ``dS K`` over pattern tiles and ``Aᵀ g``, ``dSᵀ q``
    over token tiles, each tile in a fresh sum; the LayerNorm backward in
    float64. With ``cluster`` in the cluster kernel's order: ``q Kᵀ`` and
    ``g Uᵀ`` through :func:`cluster_tf32` with the slice the plan picks
    from the wider side (a narrower side's slices past its width are
    empty, and its last slice and part hold only its real columns, as the
    kernel's zero padding leaves them), the products over pattern or token
    tiles of the plan's tile in fresh sums with the small parts truncated."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    xhat, inv = hc._state_ln(x2)
    q = hc._query(xhat, s, t)
    scores = lambda a, b: chunked_tf32(a, b, passes)  # noqa: E731
    tiled = lambda a, b: chunked_tf32(a, b, passes, chunk=TILE)  # noqa: E731
    if cluster:
        slice_, tile = _cluster_plan(max(x2.shape[1], U.shape[1]))
        scores = lambda a, b: cluster_tf32(a, b, passes, slice_=slice_)  # noqa: E731
        tiled = lambda a, b: chunked_tf32(a, b, passes, chunk=tile, trunc=True)  # noqa: E731
    a = torch.exp(scores(q, K.T.contiguous()) * beta - m) / l
    dsc = a * (scores(g, U.T.contiguous()) - delta) * beta
    dq = tiled(dsc, K).double()
    dxhat = dq * s.double()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dk = tiled(dsc.T.contiguous(), q)
    du = tiled(a.T.contiguous(), g)
    return dx.float(), dk, du, (dq * xhat).sum(0).float(), dq.sum(0).float()


def _lookup_case(d_in=512, d_out=512, n=300, m_patterns=1024, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, k, u, g = f(n, d_in), f(m_patterns, d_in), f(m_patterns, d_out), f(n, d_out)
    s, t = 1 + 0.2 * f(d_in), 0.2 * f(d_in)
    out, m, l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    return x, k, u, s, t, g, m, l, (g * out).sum(-1, keepdim=True)


@pytest.mark.parametrize("passes,d_in,d_out,order", [
    (3, 512, 512, "window"), (1, 512, 512, "window"),
    (3, 512, 512, "cluster"), (1, 512, 512, "cluster"), (3, 384, 384, "cluster"), (1, 384, 384, "cluster"),
    (3, 384, 3, "cluster"), (1, 384, 3, "cluster"), (3, 3, 384, "cluster"), (1, 3, 384, "cluster"),
    (3, 300, 700, "cluster"), (1, 300, 700, "cluster"), (3, 1280, 300, "cluster"), (1, 1280, 300, "cluster"),
    (3, 300, 2304, "cluster"), (1, 300, 2304, "cluster"),
], ids=["3", "1", "3-cluster512x512", "1-cluster512x512", "3-cluster384x384", "1-cluster384x384",
        "3-cluster384x3", "1-cluster384x3", "3-cluster3x384", "1-cluster3x384", "3-cluster300x700",
        "1-cluster300x700", "3-cluster1280x300", "1-cluster1280x300", "3-cluster300x2304", "1-cluster300x2304"])
def test_wide_lookup_forward_scheme_at_512(passes, d_in, d_out, order):
    """The wide K1 in the window kernel's order at 512 → 512, and in the
    cluster kernel's order at 512 → 512, (384, 384), (384, 3), (3, 384)
    (300, 700), (1280, 300) and (300, 2304) (the last two on slices of 256
    and 512; N 300, M 1024): with three passes out, m and l
    within ``OUT_ATOL`` and ``STAT_RTOL`` of the f32 plain version, and no
    farther from float64 than twice the plain version's distance, or 5e-8,
    5e-7 and 2e-6. With one pass the row stats miss ``STAT_RTOL`` from
    float64."""
    x, k, u, s, t, *_ = _lookup_case(d_in, d_out)
    if order == "window":
        got = wide_forward(x, k, u, s, t, passes)
    else:
        got = cluster_forward(x, k, u, s, t, passes)
    exact = _float64_forward(x, k, u, s, t)
    if passes == 1:
        assert max(_forward_errors(got, exact)[1:]) > STAT_RTOL
        return
    plain = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    out_err, m_err, l_err = _forward_errors(got, plain)
    assert out_err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL
    for mine, theirs, floor in zip(_forward_errors(got, exact), _forward_errors(plain, exact), (5e-8, 5e-7, 2e-6)):
        assert mine <= max(2 * theirs, floor)


@pytest.mark.parametrize("d_in,d_out", [(512, 512), (384, 384), (384, 3), (3, 384), (300, 700), (1280, 300)])
def test_wide_forward_stats_rebuild_rows_summing_to_one(d_in, d_out):
    """The attention that K2 and K3 rebuild from the wide forward's ``m``
    and ``l`` (N 300, M 1024, three passes; the forward in its cluster's
    order where ``hc.on_cluster``, else in the window kernels' order, whose
    parts the narrow-side kernel keeps: its own order, the backward's, is
    held in ``tests/test_torch_window.py``), with the scores in the
    backward's own order (its cluster's slices where ``hc.cluster_order``,
    on either route, else its window kernels' chunks of 64), sums to 1
    within 1.5e-7 on every
    row, as against the narrow K1's stats
    (``tests/test_torch_hopfield_tf32.py``). (K1's cluster order against
    the backward's window order at (3, 384) misses it: 3.7e-7, the small
    TF32 parts truncated in one and rounded in the other.)"""
    x, k, u, s, t, *_ = _lookup_case(d_in, d_out)
    if hc.on_cluster(d_in, d_out):
        _, m, l = cluster_forward(x, k, u, s, t, 3)
    else:
        _, m, l = wide_forward(x, k, u, s, t, 3)
    q = hc._query(hc._state_ln(x)[0], s, t)
    if hc.cluster_order(d_in, d_out):
        scores = cluster_tf32(q, k.T.contiguous(), 3, slice_=_cluster_plan(max(d_in, d_out))[0])
    else:
        scores = chunked_tf32(q, k.T.contiguous(), 3)
    a = torch.exp(scores * (1.0 / math.sqrt(d_in)) - m) / l
    assert float((a.double().sum(-1) - 1).abs().max()) <= 1.5e-7


@pytest.mark.parametrize("passes,d_in,d_out,order", [
    (3, 512, 512, "window"), (1, 512, 512, "window"),
    (3, 512, 512, "cluster"), (1, 512, 512, "cluster"), (3, 384, 3, "cluster"), (1, 384, 3, "cluster"),
    (3, 3, 384, "cluster"), (1, 3, 384, "cluster"), (3, 300, 700, "cluster"), (1, 300, 700, "cluster"),
], ids=["3", "1", "3-cluster512x512", "1-cluster512x512", "3-cluster384x3", "1-cluster384x3", "3-cluster3x384",
        "1-cluster3x384", "3-cluster300x700", "1-cluster300x700"])
def test_wide_lookup_backward_scheme_at_512(passes, d_in, d_out, order):
    """The wide K2 and K3 in the window kernels' order at 512 → 512, and
    in the cluster kernel's order at 512 → 512, (384, 3), (3, 384) and
    (300, 700) (N 300, M 1024): with three passes each of dx, dK, dU, ds,
    dt within ``BWD_NORMWISE`` of the f32 plain version, and within twice
    its distance from float64 (or 2e-6). One pass misses ``BWD_NORMWISE``
    from float64. (On the card (384, 3) and (3, 384) take the narrow-side
    kernels, which ran faster there, (384, 3) in the cluster's order:
    ``hc.on_cluster``, ``hc.score_order``.)"""
    args = _lookup_case(d_in, d_out, seed=4)
    got = wide_backward(*args, passes=passes, cluster=order == "cluster")
    exact = _float64_backward(args)
    if passes == 1:
        assert _normwise(got, exact) > BWD_NORMWISE
        return
    plain = hc.stream_lookup_bwd_reference(*args)
    for a, b in zip(got, plain):
        assert _normwise([a], [b]) <= BWD_NORMWISE
    assert _normwise(got, exact) <= max(2 * _normwise(plain, exact), 2e-6)


def cluster_tf32(a: torch.Tensor, b: torch.Tensor, passes: int, slice_: int = 128, part: int = DC) -> torch.Tensor:
    """``a @ b`` over the last axis of ``a`` as the wide backward's cluster
    sums its scores and ``g vᵀ``: a block's slice of ``slice_`` columns in
    warp parts of ``part``, each part's 8-deep steps in a fresh sum (small
    parts truncated); a slice's parts added in order in a fresh sum, the
    slices added in rank order."""
    total = None
    for s0 in range(0, a.shape[-1], slice_):
        rank_sum = None
        for p0 in range(s0, min(s0 + slice_, a.shape[-1]), part):
            piece = chunked_tf32(a[..., p0:p0 + part], b[..., p0:p0 + part, :], passes, chunk=part, trunc=True)
            rank_sum = piece if rank_sum is None else rank_sum + piece
        total = rank_sum if total is None else total + rank_sum
    return total


def _cluster_plan(dh: int) -> tuple[int, int]:
    """The cluster's slice width and streamed tile at depth ``dh`` (K5's
    head width, the wider of K2's and K3's widths), as ``wide_plan``
    (``csrc/causal_attention_cluster.cuh``), ``hopfield_cluster::plan`` and
    ``Cfg`` (``csrc/cluster.cuh``) choose them: slices of 128 up to 1024,
    then 256 up to 2048, then 512; tiles of 32 rows at slices of 128, else
    16."""
    n = -(-dh // 128)
    chunks = 1 if n <= 8 else 2 if n <= 16 else 4
    return 128 * chunks, TILE if chunks == 1 else 16


def _wide_attention(q, k, v, g, scale, passes, cluster: bool = False):
    """K5's wide kernels' products on the plain forward and backward: ``q kᵀ``
    and ``g vᵀ`` over depth chunks, ``P v``, ``Pᵀ g``, ``dSᵀ q`` and ``dS k``
    over key or query tiles of 32, each in a fresh sum. With ``cluster``
    the products run in the cluster kernels' order: ``q kᵀ`` (the
    forward's scores, and the backward's, which rebuild P from the
    forward's lse) and ``g vᵀ`` through :func:`cluster_tf32`, the products
    over key or query tiles in the plan's tiles with the small parts
    truncated. ``(out, lse, dq, dk, dv)``."""
    qh, kh, vh, gh = (a.transpose(1, 2) for a in (q, k, v, g))
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    product, tiled, tile = chunked_tf32, chunked_tf32, TILE
    if cluster:
        slice_, tile = _cluster_plan(q.shape[-1])
        tiled = lambda x, y, passes, chunk: chunked_tf32(x, y, passes, chunk, trunc=True)  # noqa: E731
        product = lambda x, y, passes: cluster_tf32(x, y, passes, slice_=slice_)  # noqa: E731
    scores = product(qh, kh.transpose(-1, -2).contiguous(), passes) * scale
    lse = torch.logsumexp(torch.where(mask, scores, float("-inf")), dim=-1)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    out = tiled(p, vh, passes, chunk=tile)
    delta = (gh * out).sum(-1)
    ds = p * (product(gh, vh.transpose(-1, -2).contiguous(), passes) - delta[..., None])
    dq = tiled(ds, kh, passes, chunk=tile) * scale
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    if not cluster and q.shape[-1] > ac.BWD_WIDE_MAX:  # K5-dkv's own split, its keys resident: k qᵀ and v gᵀ
        st = product(kh, qh.transpose(-1, -2).contiguous(), passes) * scale
        pt = torch.where(mask.T, torch.exp(st - lse[..., None, :]), 0.0)
        dst = pt * (product(vh, gh.transpose(-1, -2).contiguous(), passes) - delta[..., None, :])
    dk = tiled(dst.contiguous(), qh, passes, chunk=tile) * scale
    dv = tiled(pt.contiguous(), gh, passes, chunk=tile)
    return [out.transpose(1, 2), lse] + [a.transpose(1, 2) for a in (dq, dk, dv)]


@pytest.mark.parametrize("passes,dh,cluster",
                         [(3, 512, False), (1, 512, False), (3, 384, True), (1, 384, True), (3, 512, True),
                          (1, 512, True), (3, 1280, True), (1, 1280, True), (3, 8320, False)],
                         ids=["3", "1", "3-cluster384", "1-cluster384", "3-cluster512", "1-cluster512",
                              "3-cluster1280", "1-cluster1280", "3-window8320"])
def test_wide_attention_scheme_at_512(passes, dh, cluster):
    """K5's wide kernels at one head of 512 (B 2, S 48) in the window
    kernel's order, at one head of 8320 in the window kernels' order past
    ``BWD_WIDE_MAX`` (the scores and ``g vᵀ`` split in chunks of 64,
    K5-dkv's from its own ``k qᵀ`` and ``v gᵀ``), and the cluster kernels'
    order (forward and backward) at 384, 512 and 1280 (slices of 256, tiles of 16): with three passes
    out and lse within ``ATTN_FWD_NORMWISE`` and dQ, dK, dV within
    ``ATTN_BWD_NORMWISE`` of the plain versions; one pass misses the
    forward's limit from float64 (and, in the cluster's order, the
    backward's)."""
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 48, 1, dh), dtype=np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(dh)
    got = _wide_attention(q, k, v, g, scale, passes, cluster=cluster)
    if passes == 1:
        q64, k64, v64, g64 = (a.double() for a in (q, k, v, g))
        exact = ac.causal_attention_fwd_reference(q64, k64, v64, scale)
        assert _normwise(got[:2], list(exact)) > ATTN_FWD_NORMWISE
        if cluster:
            exact_bwd = ac.causal_attention_bwd_reference(q64, k64, v64, *exact, g64, scale)
            assert _normwise(got[2:], list(exact_bwd)) > ATTN_BWD_NORMWISE
        return
    out, lse = ac.causal_attention_fwd_reference(q, k, v, scale)
    assert _normwise(got[:2], [out, lse]) <= ATTN_FWD_NORMWISE
    plain = ac.causal_attention_bwd_reference(q, k, v, out, lse, g, scale)
    assert _normwise(got[2:], list(plain)) <= ATTN_BWD_NORMWISE


@pytest.mark.parametrize("width", [8320, 16384])
def test_backward_takes_heads_past_the_widest_cluster(width):
    """Past ``BWD_WIDE_MAX`` (a cluster of 16 blocks of 512 columns) the
    backward wrappers take the width on their window kernels, as the
    forward does: a multiple of 128 gets as far as the device check (meta
    tensors: no kernel), past the widest cluster and at it alike, with no
    refusal of the width."""
    def args(dh):
        t = torch.empty(1, 4, 1, dh, device="meta")
        return (t, t, t, t, torch.empty(1, 1, 4, device="meta"), torch.empty(1, 1, 4, device="meta"), 1.0)

    for dh in (width, ac.BWD_WIDE_MAX):
        for fn in (ac.causal_attention_bwd_dkv, ac.causal_attention_bwd_dq):
            with pytest.raises(ValueError, match="no kernel for device meta"):
                fn(*args(dh))
        t = args(dh)[0]
        with pytest.raises(ValueError, match="no kernel for device meta"):
            ac.causal_attention_fwd(t, t, t, 1.0)
