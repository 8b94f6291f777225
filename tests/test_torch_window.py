"""The narrow-side lookups past 256: K1's and K3's orders, emulated on the CPU.

Where one side of a lookup is at most 128 and the other passes 256, or a
side passes 8192, K1 and K3 run their narrow-side kernels
(``hopvae_torch/csrc/hopfield_narrow.cuh``, ``hopfield_stream_bwd_dku.cu``).
Their products are three-pass TF32 ``mma.sync`` (``round_tf32``), the
depth in parts of 64 columns, each part's 8-deep steps in a fresh sum
(k-steps past the width dropped), the parts summed in the order that K2
and K3 use at the same widths (``hc.score_order``): their cluster's, a
group of ``2J`` parts a block's slice, the small parts truncated, or their
window kernels', each part its own group, rounded. K1 then runs the window kernels'
online softmax over pattern tiles of 32 (``P U`` a tile in a fresh sum,
the denominator compensated); where few token tiles would leave the card
idle it first splits the scores (``hc.narrow_split``): each group's
sums apart, then added in order, the same operations in the same order. K3 sums ``dK`` and ``dU`` over token tiles of 32, each tile in a
fresh sum, a chunk's tiles in f32 and the chunks in double, dK's chunks
apart from dU's.

Measured here (three passes; N 300, M 1024 at (384, 3) and (3, 384), N 37
at (1280, 3) with M 300 and at (8320, 3) with M 64): K1's out, m and l
at most 4.8e-7, 8.3e-7 and 2.9e-6 from the f32 plain version; the
attention K2 and K3 rebuild from K1's ``m`` and ``l`` in their own order
sums to 1 within 7.1e-8 to 1.06e-7 a row; one pass puts m or l at least
7.5e-4 from float64. K3 (dK, dU) within 7.4e-7 and 8.3e-7 normwise of the
plain version at (3, 384) and (8320, 3); one pass 1.8e-3 and 6.9e-4 from
float64.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hopvae_tpu.ops import hopfield_pallas as hp
from hopvae_torch.ops import hopfield_cuda as hc
from test_torch_hopfield import _jax, _np_params, _torch_layer
from test_torch_hopfield_tf32 import (BWD_NORMWISE, OUT_ATOL, STAT_RTOL, _float64_backward, _float64_forward,
                                      _forward_errors, _normwise, round_tf32)
from test_torch_wide import TILE, _lookup_case, chunked_tf32, trunc_tf32

PART = hc.PART
# (N, M, d_in, d_out, route) of K2 and K3 past a d_in of 256 with d_out at most 128, where they left the
# cluster: the whole window, or the scores split (each split's slabs within 64 MiB: one token or pattern tile's
# sums and a group take 1 to 38 MB), at N 4,096 and 16,384 (M 512) and 73,984 (M 4,096)
WIDE_IN_SPLITS = [(n, m, d_in, d_out, route) for d_in, d_out, route in ((384, 3, "whole"), (1280, 3, "scores"),
                                                                         (8192, 3, "scores"), (300, 64, "whole"))
                  for n, m in ((4096, 512), (16384, 512), (73984, 4096))]
# (d_in, d_out, N, M): phase 2's narrow-side shapes, at a size the CPU runs in a second
CASES = [(384, 3, 300, 1024), (3, 384, 300, 1024), (1280, 3, 37, 300), (8320, 3, 37, 64)]
IDS = ["384x3", "3x384", "1280x3", "8320x3"]


def part_tf32(a: torch.Tensor, b: torch.Tensor, passes: int, trunc: bool, steps: int | None = None) -> torch.Tensor:
    """One part of a product (``a``'s last axis at most 64 deep) as a
    narrow-side kernel sums it: ``steps`` 8-deep steps (by default those
    below the width) of one or three TF32 passes into one fresh f32 sum;
    ``trunc``: the small parts truncated."""
    small = trunc_tf32 if trunc else round_tf32
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    total = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, 8 * (steps if steps is not None else -(-a.shape[-1] // 8)), 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        if passes == 3:
            total = total + a_small[ka] @ b_big[kb]
            total = total + a_big[ka] @ b_small[kb]
        total = total + a_big[ka] @ b_big[kb]
    return total


def group_sums(a: torch.Tensor, b: torch.Tensor, passes: int, group: int, trunc: bool) -> list[torch.Tensor]:
    """``a @ b`` by groups: the parts of 64 of a group, each in a fresh sum,
    added in order (the split's first pass writes these)."""
    parts = [part_tf32(a[..., p0:p0 + PART], b[..., p0:p0 + PART, :], passes, trunc)
             for p0 in range(0, a.shape[-1], PART)]
    sums = []
    for g0 in range(0, len(parts), group):
        gs = parts[g0]
        for p in parts[g0 + 1:g0 + group]:
            gs = gs + p
        sums.append(gs)
    return sums


def ordered_tf32(a: torch.Tensor, b: torch.Tensor, passes: int, group: int, trunc: bool) -> torch.Tensor:
    """``a @ b`` in a narrow-side kernel's order: the groups' sums added in
    order (the split's second pass, or the one-pass walk in registers)."""
    sums = group_sums(a, b, passes, group, trunc)
    total = sums[0]
    for gs in sums[1:]:
        total = total + gs
    return total


def narrow_forward(x2, K, U, s, t, passes, order=None):
    """``(out, m, l)`` of K1's narrow-side kernel: the scores in ``order``
    (``hc.score_order`` by default), then the window kernels' walk over pattern tiles
    of 32."""
    group, trunc = order or hc.score_order(x2.shape[1], U.shape[1])
    beta = 1.0 / math.sqrt(x2.shape[1])
    q = hc._query(hc._state_ln(x2)[0], s, t)
    n = x2.shape[0]
    m, l, l_lo = torch.full((n, 1), -1e30), torch.zeros(n, 1), torch.zeros(n, 1)
    acc = torch.zeros(n, U.shape[1])
    for p0 in range(0, K.shape[0], TILE):
        sc = ordered_tf32(q, K[p0:p0 + TILE].T.contiguous(), passes, group, trunc) * beta
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


def backward_scores(q, K, d_out, passes):
    """``q Kᵀ`` as K2 and K3 sum it at ``(d_in, d_out)``: their cluster's
    order or their window kernels' (``hc.score_order`` names both)."""
    return ordered_tf32(q, K.T.contiguous(), passes, *hc.score_order(q.shape[1], d_out))


def narrow_dku(x2, K, U, s, t, g, m, l, delta, passes, chunks_k=3, chunks_u=2):
    """``(dK, dU)`` of K3's narrow-side kernel: the scores and ``g Uᵀ`` in
    the window kernels' order, then ``dSᵀ q`` and ``Aᵀ g`` over token tiles
    of 32, each tile in a fresh sum, a chunk's tiles added in f32 and the
    chunks in double, dK in ``chunks_k`` chunks and dU in ``chunks_u``."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    q = hc._query(hc._state_ln(x2)[0], s, t)
    a = torch.exp(ordered_tf32(q, K.T.contiguous(), passes, 1, False) * beta - m) / l
    dsc = a * (ordered_tf32(g, U.T.contiguous(), passes, 1, False) - delta) * beta

    def chunked(w, v, chunks):
        tiles = -(-w.shape[1] // TILE)
        per = -(-tiles // chunks)
        total = torch.zeros(w.shape[0], v.shape[1], dtype=torch.float64)
        for c0 in range(0, tiles, per):
            part = torch.zeros(w.shape[0], v.shape[1])
            for t0 in range(c0 * TILE, min(tiles, c0 + per) * TILE, TILE):
                part = part + part_tf32(w[:, t0:t0 + TILE].contiguous(), v[t0:t0 + TILE].contiguous(), passes, False,
                                        steps=TILE // 8)
            total = total + part.double()
        return total.float()

    return chunked(dsc.T.contiguous(), q, chunks_k), chunked(a.T.contiguous(), g, chunks_u)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d_in,d_out,n,m", CASES, ids=IDS)
def test_narrow_forward_scheme(d_in, d_out, n, m, passes):
    """K1's narrow-side kernel in its order (``hc.score_order``): with three
    passes out, m and l within ``OUT_ATOL`` and ``STAT_RTOL`` of the f32
    plain version, and no farther from float64 than twice the plain
    version's distance, or 5e-8, 5e-7 and 2e-6. One pass misses
    ``STAT_RTOL`` from float64."""
    x, k, u, s, t, *_ = _lookup_case(d_in, d_out, n=n, m_patterns=m)
    got = narrow_forward(x, k, u, s, t, passes)
    exact = _float64_forward(x, k, u, s, t)
    if passes == 1:
        assert max(_forward_errors(got, exact)[1:]) > STAT_RTOL
        return
    plain = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    out_err, m_err, l_err = _forward_errors(got, plain)
    assert out_err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL
    for mine, theirs, floor in zip(_forward_errors(got, exact), _forward_errors(plain, exact), (5e-8, 5e-7, 2e-6)):
        assert mine <= max(2 * theirs, floor)


@pytest.mark.parametrize("d_in,d_out,n,m", CASES, ids=IDS)
def test_narrow_forward_stats_rebuild_rows_summing_to_one(d_in, d_out, n, m):
    """The attention that K2 and K3 rebuild from the narrow-side K1's ``m``
    and ``l``, with the scores in the backward's own order, sums to 1
    within 1.5e-7 on every row (three passes): K1 sums its scores in that
    order, so only l's rounding and the exps remain."""
    x, k, u, s, t, *_ = _lookup_case(d_in, d_out, n=n, m_patterns=m)
    _, m_stat, l_stat = narrow_forward(x, k, u, s, t, 3)
    q = hc._query(hc._state_ln(x)[0], s, t)
    a = torch.exp(backward_scores(q, k, d_out, 3) * (1.0 / math.sqrt(d_in)) - m_stat) / l_stat
    assert float((a.double().sum(-1) - 1).abs().max()) <= 1.5e-7


@pytest.mark.parametrize("d_in,trunc", [(3, False), (44, False), (3, True), (100, True)])
def test_dropped_k_steps_leave_the_scores_equal(d_in, trunc):
    """A part's k-steps past the width add exactly 0: the scores with the
    part's 8 steps over zero-padded columns (the window kernels' chunk) equal, bit for
    bit, those of the steps below the width alone."""
    rng = np.random.default_rng(d_in)
    a = torch.from_numpy(rng.standard_normal((37, d_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((d_in, 32)).astype(np.float32))
    pad = -d_in % PART + d_in if d_in % PART else d_in
    a_pad = torch.nn.functional.pad(a, (0, pad - d_in))
    b_pad = torch.nn.functional.pad(b, (0, 0, 0, pad - d_in))
    for p0 in range(0, d_in, PART):
        trimmed = part_tf32(a[:, p0:p0 + PART], b[p0:p0 + PART], 3, trunc)
        padded = part_tf32(a_pad[:, p0:p0 + PART], b_pad[p0:p0 + PART], 3, trunc, steps=PART // 8)
        assert torch.equal(trimmed, padded)


@pytest.mark.parametrize("d_in,d_out", [(384, 3), (1280, 3), (8320, 3), (300, 64)])
def test_split_scores_keep_the_one_pass_bits(d_in, d_out):
    """The split's scores (each group's sums apart, then added in order)
    equal, bit for bit, the one-pass walk's (the groups added in registers
    as they close), in the order of the widths."""
    x, k, _u, s, t, *_ = _lookup_case(d_in, d_out, n=37, m_patterns=64)
    q = hc._query(hc._state_ln(x)[0], s, t)
    group, trunc = hc.score_order(d_in, d_out)
    sums = group_sums(q, k.T.contiguous(), 3, group, trunc)
    split = sums[0].clone()
    for gs in sums[1:]:
        split += gs
    walk = None
    for p, p0 in enumerate(range(0, d_in, PART)):  # a part at a time, a group closing into the running sum
        pp = part_tf32(q[:, p0:p0 + PART], k.T.contiguous()[p0:p0 + PART], 3, trunc)
        gs = pp if p % group == 0 else gs + pp
        if p % group == group - 1 or p0 + PART >= d_in:
            walk = gs if walk is None else walk + gs
    assert torch.equal(split, walk)


@pytest.mark.parametrize("side", ["dx", "dku"])
@pytest.mark.parametrize("d_in,d_out", [(384, 3), (1280, 3), (8192, 3), (300, 64)])
def test_split_rounds_keep_the_cluster_order_bits(d_in, d_out, side):
    """Where K2 and K3 left the cluster, their split scores (in K2's
    orientation ``q Kᵀ`` or K3's ``K qᵀ``) in the cluster's order, in rounds
    of every size of the order's groups, each round's groups apart and
    then added onto S in order (``split_slab``), equal bit for bit the
    walk's (a part at a time, each group closing into the running sum in
    registers): the scores K1's stats were made from, whatever the slabs
    and rounds."""
    x, k, _u, s, t, *_ = _lookup_case(d_in, d_out, n=37, m_patterns=64)
    q = hc._query(hc._state_ln(x)[0], s, t)
    a, b = (q, k) if side == "dx" else (k, q)
    group, trunc = hc.score_order(d_in, d_out)
    assert trunc and group == 2 * hc._cluster_chunks(d_in, d_out) and not hc.on_cluster(d_in, d_out)
    walk = ordered_tf32(a, b.T.contiguous(), 3, group, trunc)
    sums = group_sums(a, b.T.contiguous(), 3, group, trunc)
    for rnd in range(1, len(sums) + 1):
        split = None
        for g0 in range(0, len(sums), rnd):  # a round's groups apart, then added onto S in order
            total = sums[g0].clone() if split is None else split + sums[g0]
            for gs in sums[g0 + 1:g0 + rnd]:
                total += gs
            split = total
        assert torch.equal(split, walk), rnd


@pytest.mark.parametrize("d_in,d_out,order", [(384, 3, (2, True)), (1280, 3, (4, True)), (8320, 3, (1, False)),
                                              (3, 384, (1, False)), (300, 64, (2, True)), (3000, 3, (8, True)),
                                              (64, 300, (1, False))])
def test_score_order_is_the_backward_order(d_in, d_out, order):
    """``hc.score_order``: the cluster's slice (2J parts, truncated) where
    the order is the cluster's (``hc.cluster_order``, on the cluster or
    the narrow-side kernels alike), else one part a group, rounded."""
    assert hc.score_order(d_in, d_out) == order
    assert (order[0] > 1) == hc.cluster_order(d_in, d_out)


@pytest.mark.parametrize("n,m,d_in,d_out,split", [
    (4096, 512, 384, 3, "scores"),        # 64 token tiles on 132 SMs: split
    (73984, 4096, 384, 3, None),          # a full-width batch: 1,156 tiles, and 3.6 GB of groups' sums
    (4096, 512, 3, 384, None),            # one group: nothing to split
    (37, 300, 1280, 3, "scores"),
    (37, 64, 8320, 3, "scores"),
    (73984, 4096, 8320, 3, None),         # 1,156 tiles fill the card
    (8192, 512, 384, 3, "scores"),        # 128 tiles; the scratch at 64 MiB, the most it may take
    (16384, 512, 384, 3, "slabs"),        # 256 tiles, under two an SM, but 128 MiB of groups' sums
    (16384, 128, 384, 3, "scores"),
    (20000, 128, 384, 3, None),           # 313 tiles
    (4096, 512, 128, 300, "scores"),      # two parts, three windows: 192 blocks
    (4096, 512, 64, 300, None),
    (4096, 512, 300, 64, "scores"),
    (256, 2048, 8320, 3, "slabs"),        # 4 tiles; 275 MB of groups' sums
    (4096, 64, 8320, 3, "slabs"),         # 64 tiles; 137 MB
    (4096, 4096, 384, 3, "slabs"),        # 64 tiles; 268 MB
    (256, 262144, 8320, 3, "slabs"),      # one tile's S at 64 MiB, the most a slab may hold
    (256, 262145, 8320, 3, None),         # one tile's S past it: one pass
])
def test_forward_narrow_split(n, m, d_in, d_out, split):
    """K1's narrow-side split on 132 SMs depends on N and M as well as on
    the widths: the scores through device memory within ``SPLIT_BYTES``,
    past it the score pass in slabs, or one pass."""
    assert hc.narrow_split("fwd", n, m, d_in, d_out, sms=132) == split


@pytest.mark.parametrize("n,m,d_in,d_out,split", [
    (4096, 512, 3, 384, None), (37, 64, 8320, 3, "scores"), (73984, 4096, 8320, 3, "scores"),
    (4096, 512, 64, 300, None), (37, 64, 3, 8320, None), (256, 256, 8320, 8320, "scores+gu"),
    (37, 300, 8320, 300, "scores+gu"), (4096, 64, 8320, 3, "scores"), (131072, 64, 8320, 3, "scores"),
    (131073, 64, 8320, 3, None), (278784, 64, 8320, 3, None),
    *WIDE_IN_SPLITS,
])
def test_backward_narrow_split(n, m, d_in, d_out, split):
    """K3's narrow-side split: where d_in passes 128, every window would
    recompute them, so the scores, and ``U gᵀ`` for dK's windows, split in
    slabs of pattern tiles within ``SPLIT_BYTES``; only where one tile's
    sums across N and one part pass it (N past 131,072 with one product)
    do the windows compute them. Where all of d_in fits one block (384
    with d_out up to 8, 320 with d_out up to 64) the whole window runs,
    nothing split, at every N."""
    assert hc.narrow_split("dku", n, m, d_in, d_out, sms=132) == split


def test_narrow_split_refuses_the_other_routes():
    """The predicate names only the narrow-side kernels' widths."""
    for kernel in ("fwd", "dku"):
        for widths in ((64, 64), (512, 512)):
            with pytest.raises(ValueError, match="narrow-side"):
                hc.narrow_split(kernel, 64, 64, *widths, 132)


def test_narrow_split_constants_match_the_sources():
    """The constants ``hc.narrow_split`` copies equal those of the C++
    plans that it mirrors."""
    csrc = Path(hc.__file__).resolve().parents[1] / "csrc"
    narrow = (csrc / "hopfield_narrow.cuh").read_text()
    assert re.search(r"constexpr int PART = (\d+);", narrow)[1] == str(hc.PART)
    assert re.search(r"constexpr int TM = (\d+);", narrow)[1] == str(hc.TOKEN_TILE)
    assert re.search(r"constexpr int TN = (\d+);", narrow)[1] == str(hc.PATTERN_TILE)
    assert re.search(r"SPLIT_BYTES = (\d+)ll << (\d+);", narrow).groups() == ("64", "20")
    assert hc.SPLIT_BYTES == 64 << 20


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d_in,d_out,n,m", [(3, 384, 300, 1024), (8320, 3, 37, 64)], ids=["3x384", "8320x3"])
def test_narrow_dku_scheme(d_in, d_out, n, m, passes):
    """K3's narrow-side kernel (the window kernels' order, dK's and dU's
    chunks apart): with three passes dK and dU within ``BWD_NORMWISE`` of
    the f32 plain version and within twice its distance from float64 (or
    2e-6); one pass misses ``BWD_NORMWISE`` from float64."""
    args = _lookup_case(d_in, d_out, n=n, m_patterns=m, seed=4)
    got = narrow_dku(*args, passes=passes)
    exact = _float64_backward(args)[1:3]
    if passes == 1:
        assert _normwise(got, exact) > BWD_NORMWISE
        return
    plain = hc.stream_bwd_dku_reference(*args)
    for a, b in zip(got, plain):
        assert _normwise([a], [b]) <= BWD_NORMWISE
    assert _normwise(got, exact) <= max(2 * _normwise(plain, exact), 2e-6)


def test_narrow_forward_matches_pallas_at_1280x3():
    """The narrow-side K1's emulation against the Pallas forward in
    interpret mode at (1280, 3) (N 13, M 90): out within 1e-4 rtol and
    1e-5 atol, m and l within ``STAT_RTOL`` (tests/test_torch_hopfield.py's
    limits)."""
    rng = np.random.default_rng(19)
    p = _np_params(rng, 1280, 3, 90)
    x = rng.standard_normal((13, 1280)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in jax.jit(hp._attn_call_fwd, static_argnums=5)(
            jnp.asarray(x), *[a for i, a in enumerate(hp._fold_layer(_jax(p))) if i != 2],
            jax.lax.Precision.HIGHEST)]
    with torch.no_grad():
        k, u, _b, s, t = hc.fold_layer(_torch_layer(p, 1280, 3))
        got = [a.numpy() for a in narrow_forward(torch.from_numpy(x), k, u, s, t, 3)]
    for a, b, rtol, atol in zip(got, ref, (1e-4, STAT_RTOL, STAT_RTOL), (1e-5, 0, 0)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
