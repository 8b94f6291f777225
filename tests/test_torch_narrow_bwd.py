"""K2's narrow-side kernel and K5-fwd's split scores past 8192, emulated on the CPU.

Where d_in is at most 128 and d_out passes 256, or a side passes 8192, K2
(``hopvae_torch/csrc/hopfield_stream_bwd_dx.cu``) runs its narrow-side
kernel: dq's window is d_in padded to 8 (up to 128, else windows of 128),
the products' k-steps and copies stop at the widths, each part of 64
columns is a fresh three-pass TF32 sum (``round_tf32``) added in order,
and where ``hc.narrow_split("dx", ...)`` says so ``q Kᵀ`` or ``g Uᵀ`` is
split over the card first (each part apart, then added in order). The former window
kernel padded every depth to whole chunks of 64 and dq to windows of 128,
recomputing the scores in each window, in the same order; so the two give
the same bits, which this file shows by running both schemes with one
exact 8-deep step (``dot8``: the step's products summed in float64, then
rounded to f32, whatever the shapes). Past 8192 K5-fwd
(``csrc/causal_attention_fwd.cu``) likewise computes the causal scores
once, chunk by chunk in order, and every window replays its online
softmax from them.

Measured here (three passes): K2 at (3, 384), N 300, M 1024, at (8320,
3) and at (3, 8320), N 37, M 64, dx, ds and dt within 2.9e-6 normwise of
the f32 plain version (``BWD_NORMWISE`` is 5e-5) and 4.7e-7, 4.0e-7 and
2.5e-7 from float64 (the plain version 3.2e-6, 7.1e-7 and 6.2e-7); one
pass 5.2e-3, 7.6e-4 and 2.2e-3 from float64. K5-fwd at B 2, S 37, one
head of 8320: out within 6.0e-7 normwise of JAX's
``blocked_causal_attention``, lse within 1.7e-7 of the plain version.
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

from hopvae_tpu.ops import attention as jax_attention
from hopvae_tpu.ops import hopfield_pallas as hp
from hopvae_torch.ops import attention_cuda as ac
from hopvae_torch.ops import hopfield_cuda as hc
from test_torch_hopfield import ATOL, RTOL, _jax, _np_params, _torch_layer
from test_torch_hopfield_tf32 import BWD_NORMWISE, _float64_backward, _normwise, round_tf32
from test_torch_wide import _lookup_case
from test_torch_window import WIDE_IN_SPLITS

PART = hc.PART
TILE = hc.PATTERN_TILE  # K2's pattern tile; K5's key tile
SMS = 132  # an H100's SMs, for the plans
CSRC = Path(hc.__file__).resolve().parents[1] / "csrc"


def dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 8-deep step ``a (n, k) @ b (k, m)``, k at most 8: the products
    summed in float64 (exact for TF32 operands) and rounded to f32 once,
    the same for every element whatever the shapes."""
    return (a.double()[:, :, None] * b.double()[None, :, :]).sum(1).float()


def part_sum(a: torch.Tensor, b: torch.Tensor, steps: int, passes: int) -> torch.Tensor:
    """A fresh f32 sum over ``steps`` 8-deep steps of ``a (n, w) @ b (w,
    m)`` (zeros past w), each step one or three TF32 passes (small·big,
    big·small, big·big), as ``mma3`` runs them."""
    pad = 8 * steps - a.shape[1]
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    total = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, 8 * steps, 8):
        at = slice(k0, k0 + 8)
        if passes == 3:
            total = total + dot8(a_small[:, at], b_big[at])
            total = total + dot8(a_big[:, at], b_small[at])
        total = total + dot8(a_big[:, at], b_big[at])
    return total


def parts_in_order(a: torch.Tensor, b: torch.Tensor, passes: int, padded: bool) -> torch.Tensor:
    """``a @ b`` in the window order: the parts of 64 columns, each a fresh
    sum, added in order. ``padded``: every part runs its 8 steps over zero
    padding (the former window kernel), else the steps below the width."""
    parts = []
    for p0 in range(0, a.shape[1], PART):
        w = min(PART, a.shape[1] - p0)
        parts.append(part_sum(a[:, p0:p0 + w], b[p0:p0 + w], 8 if padded else -(-w // 8), passes))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def split_in_order(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """The same product split over the card: every part's sums written
    apart (the first pass), then added in order into one array (the
    second), as ``hopfield_narrow::split_scores`` runs it."""
    sums = torch.stack([part_sum(a[:, p0:p0 + PART], b[p0:p0 + PART], -(-min(PART, a.shape[1] - p0) // 8), passes)
                        for p0 in range(0, a.shape[1], PART)])
    total = sums[0].clone()
    for g in range(1, sums.shape[0]):
        total += sums[g]
    return total


def k2_scheme(x2, K, U, s, t, g, m, l, delta, passes: int, narrow: bool, per: int, product=None):
    """``(dx, ds, dt)`` of K2 at widths past 256 where d_in is at most 128
    or a side passes 8192: with ``narrow`` the narrow-side kernel (products
    split as ``hc.narrow_split("dx", ...)`` says, k-steps and dq's window
    at the widths), else the former window kernel (every product
    recomputed over whole chunks of 64, dq in windows of 128); ``product(a,
    b, passes)``, where given, computes ``q Kᵀ`` and ``g Uᵀ`` instead. All
    sum dq over pattern tiles of 32, a tile's ``dS K`` a fresh sum added to
    its split's f32 sum, the splits of ``per`` tiles (the card's plan) in
    float64; then the LayerNorm backward in float64."""
    n, d_in = x2.shape
    beta = 1.0 / math.sqrt(d_in)
    xhat, inv = hc._state_ln(x2)
    q = hc._query(xhat, s, t)
    split = hc.narrow_split("dx", n, K.shape[0], d_in, U.shape[1], SMS) or ""
    if product is not None:
        sc, dp = product(q, K.T, passes), product(g, U.T, passes)
    elif narrow:
        sc = split_in_order(q, K.T, passes) if "scores" in split else parts_in_order(q, K.T, passes, False)
        dp = split_in_order(g, U.T, passes) if "gu" in split else parts_in_order(g, U.T, passes, False)
    else:
        sc, dp = parts_in_order(q, K.T, passes, True), parts_in_order(g, U.T, passes, True)
    a = torch.exp(sc * beta - m) * (1.0 / l)
    dsa = a * (dp - delta) * beta
    width = next(w for w in (8, 16, 32, 64, 128) if d_in <= w) if narrow and d_in <= 128 else 128
    k_win = torch.nn.functional.pad(K, (0, -d_in % width))  # dq's windows, zeros past d_in
    tiles = -(-K.shape[0] // TILE)
    dq = torch.zeros(n, d_in, dtype=torch.float64)
    for t0 in range(0, tiles, per):
        acc = torch.zeros(n, k_win.shape[1])
        for it in range(t0, min(tiles, t0 + per)):
            rows = slice(it * TILE, (it + 1) * TILE)
            acc = acc + part_sum(dsa[:, rows], k_win[rows], TILE // 8, passes)
        dq = dq + acc[:, :d_in].double()
    dq = dq.float().double()
    dxhat = dq * s.double()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.float(), (dq * xhat).sum(0).float(), dq.sum(0).float()


# (d_in, d_out, N, M, the pattern tiles of a split on an H100's plan):
# dq's windows of 8 and 16, nothing split; one window of 128 with g Uᵀ
# split; 65 windows on the split scores, on both split products; g Uᵀ split
K2_CASES = [(3, 384, 300, 1024, 1), (16, 384, 300, 1024, 1), (100, 700, 37, 300, 1), (8320, 3, 37, 64, 1),
            (8320, 300, 37, 300, 3), (3, 8320, 37, 64, 1)]
K2_IDS = ["3x384", "16x384", "100x700", "8320x3", "8320x300", "3x8320"]


@pytest.mark.parametrize("d_in,d_out,n,m,per", K2_CASES, ids=K2_IDS)
def test_narrow_dx_keeps_the_window_bits(d_in, d_out, n, m, per):
    """K2's narrow-side scheme (its plan's split products, the steps and
    dq's window at the widths) gives dx, ds and dt equal, bit for bit, to
    the former window kernel's (whole chunks, windows of 128, the scores
    recomputed): only exact zeros and the order of the same sums differ."""
    args = _lookup_case(d_in, d_out, n=n, m_patterns=m, seed=4)
    narrow = k2_scheme(*args, passes=3, narrow=True, per=per)
    window = k2_scheme(*args, passes=3, narrow=False, per=per)
    for a, b in zip(narrow, window):
        assert torch.equal(a, b)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d_in,d_out,n,m,per", K2_CASES, ids=K2_IDS)
def test_narrow_dx_scheme(d_in, d_out, n, m, per, passes):
    """K2's narrow-side scheme: with three passes dx, ds and dt within
    ``BWD_NORMWISE`` of the f32 plain version, and no farther from float64
    than twice the plain version's distance (or 2e-6); one pass misses
    ``BWD_NORMWISE`` from float64."""
    args = _lookup_case(d_in, d_out, n=n, m_patterns=m, seed=4)
    got = k2_scheme(*args, passes=passes, narrow=True, per=per)
    full = _float64_backward(args)
    exact = (full[0], full[3], full[4])
    if passes == 1:
        assert _normwise(got, exact) > BWD_NORMWISE
        return
    plain = hc.stream_bwd_dx_reference(*args)
    for a, b in zip(got, plain):
        assert _normwise([a], [b]) <= BWD_NORMWISE
    assert _normwise(got, exact) <= max(2 * _normwise(plain, exact), 2e-6)


def test_narrow_dx_matches_pallas_at_3x300():
    """K2's narrow-side scheme against JAX's Pallas backward
    (``_attn_ln_stream_bwd``, in interpret mode) at (3, 300), N 13, M 90:
    dx, ds and dt within tests/test_torch_hopfield.py's lookup limits
    (rtol 1e-4, atol 1e-5), and no farther from Pallas, element for
    element, than twice the f32 plain version is. (Its gradient limits,
    atol 1e-6, hold the plain version; the three-pass products sit about
    2e-6 from f32 at values of 10, as far as the plain version sits from
    Pallas, which leaves elements near 0 no room.)"""
    rng = np.random.default_rng(20)
    p = _np_params(rng, 3, 300, 90)
    x = rng.standard_normal((13, 3)).astype(np.float32)
    g = rng.standard_normal((13, 300)).astype(np.float32)
    k, u, _b, s, t = [np.array(a) for a in hp._fold_layer(_jax(p))]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: hp._attn_ln_stream(*a, jax.lax.Precision.HIGHEST),
                         *map(jnp.asarray, (x, k, u, s, t)))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    with torch.no_grad():
        kt, ut, _bt, st, tt = hc.fold_layer(_torch_layer(p, 3, 300))
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        out, m_stat, l_stat = hc.stream_lookup_fwd_reference(xt, kt, ut, st, tt)
        args = (xt, kt, ut, st, tt, gt, m_stat, l_stat, (gt * out).sum(-1, keepdim=True))
        got = k2_scheme(*args, passes=3, narrow=True, per=1)
        plain = hc.stream_bwd_dx_reference(*args)
    for name, a, b, w in zip(("dx", "ds", "dt"), got, plain, (want[0], want[3], want[4])):
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
        assert np.abs(a.numpy() - w).max() <= 2 * np.abs(b.numpy() - w).max(), name


@pytest.mark.parametrize("n,m,d_in,d_out,split", [
    (4096, 512, 3, 384, None),             # 64 token tiles, 4 splits: 256 blocks fill the card
    (73984, 4096, 3, 384, None),           # 1,156 tiles; g Uᵀ's scratch would be 8.5 GB
    (37, 64, 8320, 3, "scores"),           # 65 windows read the scores once
    (4096, 64, 8320, 3, "scores"),         # the parts' sums take 137 MB: in 3 slabs of 22 token tiles
    (256, 2048, 8320, 3, "scores"),        # one token tile's parts take 68.7 MB: in rounds
    (256, 256, 8320, 8320, "scores+gu"),   # S and P in one slab, one after the other
    (37, 64, 3, 8320, "gu"),               # 130 parts of g Uᵀ on one block
    (37, 300, 8320, 300, "scores+gu"),
    (300, 1024, 3, 384, None),
    (37, 1024, 3, 384, "gu"),              # 32 blocks
    (37, 300, 13, 700, "gu"),              # 10 blocks
    (8192, 512, 64, 300, None),            # 256 blocks fill the card
    (37, 64, 100, 9000, "gu"),             # one part of q Kᵀ: nothing to split
    (20000, 4096, 9000, 3, "scores"),      # one token tile's parts pass 64 MiB: rounds
    (64, 131072, 8320, 3, "scores"),       # one token tile's sums and a part: 64 MiB, the most a unit may take
    (64, 131073, 8320, 3, None),           # past it the windows compute the scores
    (64, 87382, 8320, 8320, None),         # two products past 87,381 patterns
    *WIDE_IN_SPLITS,                       # past a d_in of 256 with d_out at most 128: off the cluster
])
def test_narrow_split_dx(n, m, d_in, d_out, split):
    """K2's narrow-side route on 132 SMs: which products split over the
    card, which depends on N and M as well as on the widths, and nowhere
    on the scratch but where one token tile's sums and one part pass 64
    MiB; the whole window wherever all of d_in fits a block."""
    assert hc.narrow_split("dx", n, m, d_in, d_out, SMS) == split


@pytest.mark.parametrize("blocks,tiles,concurrent,splits", [(64, 16, 264, (4, 4)), (1156, 128, 264, (2, 64)),
                                                            (65, 2, 264, (2, 1)), (64, 16, 528, (8, 2))])
def test_pattern_splits_follow_plan_for(blocks, tiles, concurrent, splits):
    """The mirror of ``plan_for``: at two blocks an SM (264 on 132 SMs) N
    4,096 (64 tiles) takes four splits of 4 pattern tiles; had the plan
    read the narrow kernel's own four blocks an SM, eight, and dq's sums
    would have moved."""
    assert hc._pattern_splits(blocks, tiles, concurrent) == splits


def test_narrow_split_dx_refuses_the_other_routes():
    """K2's route names only the narrow-side kernel's widths: up to 256 a
    built instance, d_in and d_out past 128 up to 8192 the cluster."""
    for widths in ((64, 64), (384, 200), (512, 512)):
        with pytest.raises(ValueError, match="narrow-side"):
            hc.narrow_split("dx", 64, 64, *widths, SMS)


def test_plan_constants_match_the_sources():
    """The constants that ``hc.narrow_split("dx", ...)`` copies equal
    those of the C++ plan that it mirrors."""
    narrow = (CSRC / "hopfield_narrow.cuh").read_text()
    dx = (CSRC / "hopfield_stream_bwd_dx.cu").read_text()
    assert re.search(r"constexpr int TN = (\d+);", narrow)[1] == str(hc.PATTERN_TILE)
    assert re.search(r"constexpr int TM = (\d+);", narrow)[1] == str(hc.TOKEN_TILE)
    assert re.search(r"constexpr int PLAN_PER_SM = (\d+);", dx)[1] == str(hc.PLAN_PER_SM)


def test_whole_window_constants_match_the_sources():
    """The whole window's widths that ``hc.whole_window`` copies equal
    ``whole_fits``'s in ``hopfield_narrow.cuh``, and its instances are the
    ones that ``with_whole`` builds."""
    narrow = (CSRC / "hopfield_narrow.cuh").read_text()
    fits = re.search(r"inline bool whole_fits\(.*?\n\}", narrow, re.S)[0]
    pairs = [tuple(map(int, p)) for p in re.findall(r"d_in <= (\d+) && d_out <= (\d+)", fits)]
    assert tuple(pairs) == hc.WHOLE
    assert [tuple(map(int, p)) for p in re.findall(r"dw = (\d+), wo = (\d+);", fits)] == list(hc.WHOLE)
    for (d_in, d_out), whole in (((384, 3), True), ((385, 3), False), ((384, 9), False), ((320, 64), True),
                                 ((321, 64), False), ((300, 65), False), ((257, 8), True), ((256, 3), False)):
        assert hc.whole_window(d_in, d_out) == whole


def _softmax_walk(scores_of_tile, v, s: int, scale: float, passes: int):
    """The window kernel's walk for one head: per key tile of 32 the tile's
    scores, the online softmax (masked past the diagonal), ``P v`` of the
    tile in a fresh sum; ``(out, lse)``."""
    m = torch.full((s, 1), -1e30)
    l = torch.zeros(s, 1)
    acc = torch.zeros(s, v.shape[1])
    rows = torch.arange(s)[:, None]
    for n0 in range(0, s, TILE):
        keys = torch.arange(n0, min(s, n0 + TILE))[None, :]
        sc = torch.where(keys > rows, torch.tensor(-1e30), scores_of_tile(n0) * scale)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + part_sum(p, v[n0:n0 + TILE], TILE // 8, passes)
        m = m_new
    return acc / l, (m + torch.log(l))[:, 0]


def k5_forward(q, k, v, scale: float, split: bool, passes: int = 3):
    """K5-fwd's window kernel past 8192 on ``(B, S, 1, dh)``: the scores of
    each key tile recomputed chunk by chunk (``split=False``), or the
    causal scores computed once, every chunk of 64 apart and then added in
    chunk order, and each tile read from them (``split=True``)."""
    outs, lses = [], []
    for bi in range(q.shape[0]):
        qh, kh, vh = q[bi, :, 0], k[bi, :, 0], v[bi, :, 0]
        s = qh.shape[0]
        if split:
            scores = split_in_order(qh, kh.T, passes)
            tile = lambda n0: scores[:, n0:n0 + TILE]  # noqa: E731
        else:
            tile = lambda n0: parts_in_order(qh, kh[n0:n0 + TILE].T, passes, True)  # noqa: E731
        out, lse = _softmax_walk(tile, vh, s, scale, passes)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs)[:, :, None], torch.stack(lses)[:, None]


def test_k5_forward_split_scores_keep_the_window_bits():
    """K5-fwd at B 2, S 37, one head of 8320: the split scores with the
    replayed online softmax give out and lse equal, bit for bit, to the
    window order's walk, and within 1e-5 normwise of JAX's
    ``blocked_causal_attention``."""
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((2, 37, 1, 8320), dtype=np.float32) for _ in range(3))
    scale = 1 / math.sqrt(8320)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = k5_forward(qt, kt, vt, scale, split=True)
    walk = k5_forward(qt, kt, vt, scale, split=False)
    for a, b in zip(got, walk):
        assert torch.equal(a, b)
    want = np.asarray(jax_attention.blocked_causal_attention(*map(jnp.asarray, (q, k, v)), scale=scale))
    assert _normwise([got[0]], [torch.from_numpy(want.copy())]) <= 1e-5
    _, lse = ac.causal_attention_fwd_reference(qt, kt, vt, scale)
    assert _normwise([got[1]], [lse]) <= 1e-5
