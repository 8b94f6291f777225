"""K1's score pass in slabs past its split cap, emulated on the CPU.

Where K1's narrow-side kernel (``hopvae_torch/csrc/hopfield_narrow.cuh``)
would leave the card idle (fewer than two blocks of 64 token rows an SM,
more than one group of depth parts) and every group's sums pass 64 MiB,
it computes ``S = q Kᵀ`` once, slab after slab of token tiles
(``hc.narrow_split`` names the route ``"slabs"``): a score pass in which
each block owns its token tile and a run of pattern tiles of 32, streams
each tile's parts of 64 columns, sums each part in a fresh three-pass TF32
sum and adds the parts in the width's order (``hc.score_order``) in
registers, as the one-pass walk adds them, then writes its tiles of S;
then the forward's online softmax over the slab's S. This file runs both
schemes with one exact 8-deep step (``dot8``: a row's sums do not depend on
how many rows a slab holds) and the online softmax written out as the
kernel runs it (a quad of threads a row, each with its compensated partial
denominator, the quad summed at the end), and shows that the slabs keep
the walk's scores, out, m and l bit for bit at (8320, 3), (384, 3) and
(1280, 3); then the plain K1 against JAX's Pallas forward at (8320, 3).

Measured here: the slabs' S, out, m and l equal the walk's bit for bit at
the three widths (N 150, M 100: uneven slabs of the 3 token tiles and
uneven runs of the 4 pattern tiles), out, m and l within 6.6e-7, 9.6e-7
and 2.2e-6 (relative) of the f32 plain version at worst (at (384, 3),
whose small TF32 parts are truncated); the plain K1 at (8320, 3), N 13, M
40, within JAX's limits (rtol 1e-4 with atol 1e-5, STAT_RTOL 1e-5).
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import ast
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
from test_torch_hopfield import ATOL, RTOL, STAT_RTOL, _jax, _np_params, _torch_layer
from test_torch_hopfield_tf32 import OUT_ATOL, _forward_errors, round_tf32
from test_torch_narrow_bwd import dot8
from test_torch_wide import _lookup_case, trunc_tf32

PART = hc.PART
TM, TN = hc.TOKEN_TILE, hc.PATTERN_TILE
ROOT = Path(__file__).resolve().parents[1]
MASKED = -1e30
WIDTHS = [(8320, 3), (384, 3), (1280, 3)]
# (token tiles of each slab, pattern tiles of each run of a block) of N 150
# (3 token tiles, the last of 22 rows) and M 100 (4 pattern tiles, the last
# of 4): uneven slabs and runs, then one slab of every tile in runs of one
SLABS = [((2, 1), (3, 1)), ((1, 2), (1, 3)), ((3,), (1, 1, 1, 1))]


def part8(a: torch.Tensor, b: torch.Tensor, trunc: bool) -> torch.Tensor:
    """One part's product ``a (n, w) @ b (w, m)``, w at most 64, as
    ``part_product`` runs it: a fresh f32 sum of the 8-deep steps below
    the width, each in three TF32 passes (small·big, big·small, big·big);
    ``trunc``: the small parts truncated."""
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    small = trunc_tf32 if trunc else round_tf32
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    total = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        at = slice(k0, k0 + 8)
        total = total + dot8(a_small[:, at], b_big[at])
        total = total + dot8(a_big[:, at], b_small[at])
        total = total + dot8(a_big[:, at], b_big[at])
    return total


def tile_scores(q_rows: torch.Tensor, k_tile: torch.Tensor, group: int, trunc: bool) -> torch.Tensor:
    """The scores of some token rows and one pattern tile as the walk and
    the score pass add them in registers (``add_part``): each part a fresh
    sum, ``group`` parts added in order into a group's sum, the groups
    added in order."""
    kt = k_tile.T.contiguous()
    parts = -(-q_rows.shape[1] // PART)
    for p in range(parts):
        at = slice(p * PART, (p + 1) * PART)
        pp = part8(q_rows[:, at], kt[at], trunc)
        gs = pp if p % group == 0 else gs + pp
        if p % group == group - 1 or p == parts - 1:
            sc = gs if p < group else sc + gs
    return sc


class Window:
    """The forward's online softmax over pattern tiles for some token rows,
    as ``stream_fwd_narrow_kernel`` runs it on a tile's scores: a quad of
    four threads a row, thread ``tq`` owning columns ``8j + 2tq`` and ``8j
    + 2tq + 1`` of each tile with its own compensated partial denominator;
    ``P U`` a tile in a fresh sum of four 8-deep steps."""

    def __init__(self, rows: int, d_out: int, beta: float):
        self.beta = beta
        self.m = torch.full((rows, 1), MASKED)
        self.l, self.l_lo = torch.zeros(rows, 4), torch.zeros(rows, 4)
        self.acc = torch.zeros(rows, d_out)

    def tile(self, sc: torch.Tensor, u_tile: torch.Tensor, p_lo: int, m_patterns: int) -> None:
        cols = p_lo + torch.arange(TN)
        sc = torch.nn.functional.pad(sc, (0, TN - sc.shape[1]))
        val = torch.where(cols < m_patterns, sc * self.beta, torch.full_like(sc, MASKED))
        mx = torch.maximum(self.m, val.amax(-1, keepdim=True))
        alpha = torch.exp(self.m - mx)
        self.m = mx
        p = torch.exp(val - mx)
        owned = p.reshape(-1, 4, 4, 2)  # (rows, j, tq, e & 1)
        rsum = torch.zeros(p.shape[0], 4)
        for j in range(4):
            for e in range(2):
                rsum = rsum + owned[:, j, :, e]
        a = self.l * alpha
        b = self.l_lo * alpha + rsum
        total = a + b
        bb = total - a
        self.l_lo = (a - (total - bb)) + (b - bb)
        self.l = total
        u = torch.nn.functional.pad(u_tile, (0, 0, 0, TN - u_tile.shape[0]))
        self.acc = self.acc * alpha + part8(p, u, trunc=False)

    def finish(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        part = self.l + self.l_lo
        l = ((part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3]))[:, None]
        return self.acc / l, self.m, l


def walk(q: torch.Tensor, k: torch.Tensor, u: torch.Tensor) -> tuple:
    """``(S, out, m, l)`` of the one-pass walk: each block of 64 token
    rows, for each pattern tile, its parts summed in registers, then the
    softmax step on them."""
    group, trunc = hc.score_order(q.shape[1], u.shape[1])
    n, m_patterns = q.shape[0], k.shape[0]
    s_all, outs = torch.empty(n, m_patterns), []
    for r0 in range(0, n, TM):
        win = Window(min(TM, n - r0), u.shape[1], 1.0 / math.sqrt(q.shape[1]))
        for p_lo in range(0, m_patterns, TN):
            sc = tile_scores(q[r0:r0 + TM], k[p_lo:p_lo + TN], group, trunc)
            s_all[r0:r0 + TM, p_lo:p_lo + TN] = sc
            win.tile(sc, u[p_lo:p_lo + TN], p_lo, m_patterns)
        outs.append(win.finish())
    return (s_all, *(torch.cat(a) for a in zip(*outs)))


def slabbed(q: torch.Tensor, k: torch.Tensor, u: torch.Tensor, slabs: tuple, runs: tuple) -> tuple:
    """``(S, out, m, l)`` of the score pass in slabs: for each slab of
    ``slabs[i]`` token tiles, every block (a token tile and a run of
    ``runs[j]`` pattern tiles) writes its tiles of the slab's S, then the
    forward's blocks read the slab's rows of S tile by tile."""
    group, trunc = hc.score_order(q.shape[1], u.shape[1])
    n, m_patterns = q.shape[0], k.shape[0]
    assert sum(slabs) == -(-n // TM) and sum(runs) == -(-m_patterns // TN)
    s_all, outs, r0 = torch.empty(n, m_patterns), [], 0
    for tiles in slabs:
        rows = min(tiles * TM, n - r0)
        q_slab, s_slab = q[r0:r0 + rows], torch.full((rows, m_patterns), float("nan"))
        for b0 in range(0, rows, TM):  # the score pass's blocks, in any order
            t0 = 0
            for run in runs:
                for t in range(t0, t0 + run):
                    p_lo = t * TN
                    s_slab[b0:b0 + TM, p_lo:p_lo + TN] = tile_scores(q_slab[b0:b0 + TM], k[p_lo:p_lo + TN], group,
                                                                     trunc)
                t0 += run
        for b0 in range(0, rows, TM):  # the forward's blocks on the slab's S
            win = Window(min(TM, rows - b0), u.shape[1], 1.0 / math.sqrt(q.shape[1]))
            for p_lo in range(0, m_patterns, TN):
                win.tile(s_slab[b0:b0 + TM, p_lo:p_lo + TN], u[p_lo:p_lo + TN], p_lo, m_patterns)
            outs.append(win.finish())
        s_all[r0:r0 + rows] = s_slab
        r0 += rows
    return (s_all, *(torch.cat(a) for a in zip(*outs)))


@pytest.mark.parametrize("slabs,runs", SLABS, ids=["2+1,3+1", "1+2,1+3", "3,1+1+1+1"])
@pytest.mark.parametrize("d_in,d_out", WIDTHS, ids=["8320x3", "384x3", "1280x3"])
def test_score_pass_keeps_the_walk_bits(d_in, d_out, slabs, runs):
    """N 150, M 100: the tiles of S that the score pass's blocks write,
    slab after slab, equal the walk's scores bit for bit in each width's
    order (the window kernels' at 8320, the cluster's groups of 2 and 4
    parts, truncated, at 384 and 1280), and so do out, m and l from the
    online softmax over the slabs' S; out lies within ``OUT_ATOL`` and m
    and l within ``STAT_RTOL`` of the f32 plain version (chip_smoke.py's
    limits for K1)."""
    x, k, u, s, t, *_ = _lookup_case(d_in, d_out, n=150, m_patterns=100, seed=23)
    q = hc._query(hc._state_ln(x)[0], s, t)
    want = walk(q, k, u)
    got = slabbed(q, k, u, slabs, runs)
    for name, a, b in zip(("S", "out", "m", "l"), got, want):
        assert torch.equal(a, b), name
    out_err, m_err, l_err = _forward_errors(got[1:], hc.stream_lookup_fwd_reference(x, k, u, s, t))
    assert out_err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL


def test_forward_route_codes_match_the_sources():
    """K1's route codes in ``hopfield_narrow.cuh`` name, in
    ``chip_smoke.py``'s ``PLAN_ROUTES``, the routes that ``SPLITS`` gives
    ``hc.narrow_split``'s names (the slabs' ``"slabs"`` among them)."""
    narrow = (ROOT / "hopvae_torch" / "csrc" / "hopfield_narrow.cuh").read_text()
    codes = dict(pair.split(" = ") for pair in re.search(r"enum FwdRoute \{ (.*?) \};", narrow)[1].split(", "))
    assert codes == {"WALK": "2", "SPLIT": "3", "SLABS": "6"}
    found = {}
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            if node.targets[0].id in ("PLAN_ROUTES", "SPLITS"):
                found[node.targets[0].id] = ast.literal_eval(node.value)
    routes, splits = found["PLAN_ROUTES"], found["SPLITS"]
    assert routes[int(codes["SLABS"])] == splits["slabs"]
    assert routes[int(codes["SPLIT"])] == splits["scores"] and routes[int(codes["WALK"])] == splits[None]


def test_plain_forward_matches_pallas_at_8320x3():
    """The plain K1 (``stream_lookup_fwd_reference``) against JAX's
    ``_attn_call_fwd`` in interpret mode at (8320, 3), N 13, M 40: out
    within rtol 1e-4 and atol 1e-5, m and l within ``STAT_RTOL``
    (tests/test_torch_hopfield.py's limits)."""
    rng = np.random.default_rng(23)
    p = _np_params(rng, 8320, 3, 40)
    x = rng.standard_normal((13, 8320)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in jax.jit(hp._attn_call_fwd, static_argnums=5)(
            jnp.asarray(x), *[a for i, a in enumerate(hp._fold_layer(_jax(p))) if i != 2],
            jax.lax.Precision.HIGHEST)]
    with torch.no_grad():
        k, u, _b, s, t = hc.fold_layer(_torch_layer(p, 8320, 3))
        got = [a.numpy() for a in hc.stream_lookup_fwd_reference(torch.from_numpy(x), k, u, s, t)]
    for name, a, b, rtol, atol in zip(("out", "m", "l"), got, ref, (RTOL, STAT_RTOL, STAT_RTOL), (ATOL, 0, 0)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
