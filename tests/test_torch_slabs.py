"""K2's and K3's split products past 8192 in slabs and rounds, emulated on the CPU.

Past 8192 K2 (``hopvae_torch/csrc/hopfield_stream_bwd_dx.cu``) and K3
(``hopfield_stream_bwd_dku.cu``) compute their products once, split over
the card (``hopfield_narrow::slab_plan``): slab after slab of 64-row tiles
(token rows in K2, its ``q Kᵀ`` and ``g Uᵀ`` across the M patterns;
pattern rows in K3, its ``K qᵀ`` and ``U gᵀ`` across the N tokens, the
orientation of its own walk), each product's depth parts of 64 in rounds:
a round's parts apart, then added in part order onto the product's sums,
the first round from part 0's. The window walk adds the same parts in the
same order in registers. So the slabs and rounds give the walk's bits
whatever their sizes, which this file shows with one exact 8-deep step
(``dot8``: a step's products summed in float64 and rounded once, so that a
row's sums do not depend on how many rows a slab holds), down to dx, ds, dt
and dK, dU; it also holds the plain K2 and K3 against JAX's Pallas backward
at d_in 8320.

Measured here (three passes, N 37, M 64): the slabs' and rounds' S, P,
dx, ds, dt (K2) and Sᵀ, Pᵀ, dK, dU (K3) equal the walk's bit for bit at
(8320, 3) and (8320, 8320); K3's dK and dU within 8.2e-7 normwise of the
f32 plain version. The plain versions at (8320, 3) and (8320, 300), N 13,
M 40: within 0.34 of JAX's limits (rtol 1e-4, atol 1e-5) at worst.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hopvae_tpu.ops import hopfield_pallas as hp
from hopvae_torch.ops import hopfield_cuda as hc
from test_torch_hopfield import ATOL, RTOL, _jax, _np_params, _torch_layer
from test_torch_hopfield_tf32 import BWD_NORMWISE, _normwise
from test_torch_narrow_bwd import k2_scheme, part_sum
from test_torch_wide import _lookup_case

PART = hc.PART
TILE = hc.PATTERN_TILE  # K2's pattern tile; K3's token tile
WIDTHS = [(8320, 3), (8320, 8320)]
# (rows of a slab, parts of a round): uneven last slabs of the 37 token rows
# (K2) and 64 pattern rows (K3), uneven last rounds of the 130 parts; then
# one slab in one round
SLABS = [(8, 7), (24, 64), (64, 130)]


def walk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the window walk sums it: the parts of 64 columns, each a
    fresh three-pass sum over the steps below the width, added in order."""
    total = None
    for p0 in range(0, a.shape[1], PART):
        w = min(PART, a.shape[1] - p0)
        part = part_sum(a[:, p0:p0 + w], b[p0:p0 + w], -(-w // 8), 3)
        total = part if total is None else total + part
    return total


def slabbed(a: torch.Tensor, b: torch.Tensor, slab_rows: int, round_parts: int) -> torch.Tensor:
    """``a @ b`` as the split runs it: slab after slab of ``slab_rows`` rows
    of ``a``; for each, rounds of ``round_parts`` parts, each part's sums
    apart, then the round added in part order onto the slab's sums (the
    first round from part 0's)."""
    out = torch.empty(a.shape[0], b.shape[1])
    starts = range(0, a.shape[1], PART)
    for r0 in range(0, a.shape[0], slab_rows):
        rows = a[r0:r0 + slab_rows]
        sums = None
        for g0 in range(0, len(starts), round_parts):
            parts = [part_sum(rows[:, p0:p0 + PART], b[p0:p0 + PART], -(-min(PART, a.shape[1] - p0) // 8), 3)
                     for p0 in starts[g0:g0 + round_parts]]
            t = parts[0] if sums is None else sums + parts[0]
            for part in parts[1:]:
                t = t + part
            sums = t
        out[r0:r0 + rows.shape[0]] = sums
    return out


def k3_scheme(x2, K, U, s, t, g, m, l, delta, product, chunks_k: int = 2, chunks_u: int = 2):
    """``(Sᵀ, Pᵀ, dK, dU)`` of K3 past 8192 with its products ``K qᵀ`` and
    ``U gᵀ`` from ``product``: ``dSᵀ q`` and ``Aᵀ g`` over token tiles of
    32, each tile a fresh sum added to its chunk's f32 sum, the chunks in
    float64 (dK in ``chunks_k`` chunks, dU in ``chunks_u``)."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    q = hc._query(hc._state_ln(x2)[0], s, t)
    sct, dpt = product(K, q.T.contiguous()), product(U, g.T.contiguous())
    a = torch.exp(sct * beta - m.T) * (1.0 / l.T)
    dst = a * (dpt - delta.T) * beta

    def chunked(w, v, chunks):
        tiles = -(-w.shape[1] // TILE)
        per = -(-tiles // chunks)
        total = torch.zeros(w.shape[0], v.shape[1], dtype=torch.float64)
        for c0 in range(0, tiles, per):
            acc = torch.zeros(w.shape[0], v.shape[1])
            for t0 in range(c0 * TILE, min(tiles, c0 + per) * TILE, TILE):
                acc = acc + part_sum(w[:, t0:t0 + TILE], v[t0:t0 + TILE], TILE // 8, 3)
            total = total + acc.double()
        return total.float()

    return sct, dpt, chunked(dst, q, chunks_k), chunked(a, g, chunks_u)


@pytest.mark.parametrize("slab_rows,round_parts", SLABS)
@pytest.mark.parametrize("d_in,d_out", WIDTHS, ids=["8320x3", "8320x8320"])
def test_k2_slabs_and_rounds_keep_the_walk_bits(d_in, d_out, slab_rows, round_parts):
    """K2 at N 37, M 64: S = q Kᵀ and P = g Uᵀ in slabs of token rows and
    rounds of parts equal the walk's bit for bit, and so do dx, ds and dt
    (the window walk's dq tiles, in its splits of the pattern axis)."""
    x, k, u, s, t, g, m, l, delta = args = _lookup_case(d_in, d_out, n=37, m_patterns=64, seed=22)
    q = hc._query(hc._state_ln(x)[0], s, t)
    for a, b in ((q, k.T), (g, u.T)):
        assert torch.equal(slabbed(a, b, slab_rows, round_parts), walk(a, b))
    got = k2_scheme(*args, passes=3, narrow=True, per=1,
                    product=lambda a, b, _passes: slabbed(a, b, slab_rows, round_parts))
    want = k2_scheme(*args, passes=3, narrow=True, per=1, product=lambda a, b, _passes: walk(a, b))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("slab_rows,round_parts", SLABS)
@pytest.mark.parametrize("d_in,d_out", WIDTHS, ids=["8320x3", "8320x8320"])
def test_k3_slabs_and_rounds_keep_the_walk_bits(d_in, d_out, slab_rows, round_parts):
    """K3 at N 37, M 64: Sᵀ = K qᵀ and Pᵀ = U gᵀ in slabs of pattern rows
    and rounds of parts, and dK and dU from them, equal the walk's bit for
    bit; dK and dU lie within ``BWD_NORMWISE`` of the f32 plain version."""
    args = _lookup_case(d_in, d_out, n=37, m_patterns=64, seed=22)
    got = k3_scheme(*args, product=lambda a, b: slabbed(a, b, slab_rows, round_parts))
    want = k3_scheme(*args, product=walk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got[2:], hc.stream_bwd_dku_reference(*args)):
        assert _normwise([a], [b]) <= BWD_NORMWISE


@pytest.mark.parametrize("d_in,d_out", [(8320, 3), (8320, 300)])
def test_plain_backward_matches_pallas_at_8320(d_in, d_out):
    """The plain K2 (dx, ds, dt) and K3 (dK, dU) against JAX's Pallas
    backward (``_attn_ln_stream``'s VJP in interpret mode) at d_in 8320, N
    13, M 40, within tests/test_torch_hopfield.py's lookup limits (rtol
    1e-4, atol 1e-5)."""
    rng = np.random.default_rng(22)
    p = _np_params(rng, d_in, d_out, 40)
    x = rng.standard_normal((13, d_in)).astype(np.float32)
    g = rng.standard_normal((13, d_out)).astype(np.float32)
    k, u, _b, s, t = [np.array(a) for a in hp._fold_layer(_jax(p))]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: hp._attn_ln_stream(*a, jax.lax.Precision.HIGHEST),
                         *map(jnp.asarray, (x, k, u, s, t)))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    with torch.no_grad():
        kt, ut, _bt, st, tt = hc.fold_layer(_torch_layer(p, d_in, d_out))
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        out, m_stat, l_stat = hc.stream_lookup_fwd_reference(xt, kt, ut, st, tt)
        args = (xt, kt, ut, st, tt, gt, m_stat, l_stat, (gt * out).sum(-1, keepdim=True))
        dx, ds, dt = hc.stream_bwd_dx_reference(*args)
        dk, du = hc.stream_bwd_dku_reference(*args)
    for name, a, w in zip(("dx", "dK", "dU", "ds", "dt"), (dx, dk, du, ds, dt), want):
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
