"""The precision scheme of K1, K2, K3 and K4, emulated on the CPU.

K2 and K3 (``hopvae_torch/csrc/hopfield_stream_bwd_dx.cu`` and
``hopfield_stream_bwd_dku.cu``) run every product on the tensor cores as
TF32 ``mma.sync`` in three passes, as K5's kernels do
(``tests/test_torch_attention_tf32.py``): each f32 operand x splits into
``big = tf32(x)`` and ``small = tf32(x - big)``, rounded as
``cvt.rna.tf32.f32`` rounds, and each 8-deep step of a product adds
``small_a big_b``, then ``big_a small_b``, then ``big_a big_b`` to an f32
sum. This file builds that product from the rounding alone and puts it in
place of every product of the plain backward (``ops/hopfield_cuda.py``):
``q Kᵀ``, ``g Uᵀ`` and ``dS K`` (K2); ``Aᵀ g`` and ``dSᵀ q`` (K3). The row
stats ``m`` and ``l`` come from the f32 plain forward, as the kernels get
them from K1, whose scores are f32 FMA sums.

At M = 4096 patterns and 300 tokens, over the bottleneck's three widths
(measured here, normwise ``max|a - b| / max|b|``, the worst of dx, dK,
dU, ds and dt against a float64 backward): three passes 6.0e-7 to 1.4e-6
(the f32 plain version: 9.6e-7 to 1.2e-6), within 1.5e-6 of the plain
version, far inside ``BWD_NORMWISE`` (5e-5, ``chip_smoke.py``); one pass
7.7e-4 to 6.9e-3, 15 to 137 times that limit. A rebuilt from three-pass
scores against K1's ``m`` and ``l`` sums to 1 within 1.5e-7 on every row.
The long products sum each 32-deep tile apart, as the kernels do: one
chain over 4096 patterns put ds at d_in = 3 at 7.3e-6 from float64.

K1 (``csrc/hopfield_stream_fwd.cu``, the walk in
``hopfield_stream_fwd.cuh``) and K4, which runs K1's walk three times, run
``q Kᵀ`` and ``P U`` the same way: the scores in 8-deep steps over d_in,
an online softmax over pattern tiles of 64, each tile's ``P U`` in 8-deep
steps into a fresh sum that is added to the rescaled running output, and
the denominator carried as a compensated sum. At M = 4096 and 300 tokens
(measured here, against the f32 plain version and a float64 forward;
``out`` max abs, ``m`` relative floored at 1, ``l`` relative), three
passes: out 4.8e-8 to 1.9e-7, m 2.6e-7 to 9.4e-7, l 9.5e-7 to 3.3e-6 from
the plain version, as near float64 as the plain version is, at the
bottleneck's three widths and at 256 -> 256; inside K1's ``OUT_ATOL``
(1e-4) and ``STAT_RTOL`` (1e-5, ``chip_smoke.py``). One pass: m 2.5e-4 to
5.9e-4 and l 9.3e-4 to 1.7e-3 from float64, 25 to 170 times
``STAT_RTOL``. K2's attention rebuilt from three-pass scores against
three-pass K1's ``m`` and ``l`` sums to 1 within 9.1e-8 to 1.3e-7 on
every row (1.4e-7 to 1.6e-7 against the plain f32 stats; a plain running
denominator, not compensated, gave 3.6e-7 to 4.4e-7). Three-pass K4 at M =
4096, d 64, di 3 on 1,024 tokens flips no ``zq`` bin of the plain
version's.
"""

import math

import numpy as np
import pytest
import torch

from hopvae_torch.ops import hopfield_cuda as hc

BWD_NORMWISE = 5e-5  # chip_smoke.py: K2 and K3 against their plain versions
WIDTHS = [(64, 64), (64, 3), (3, 64)]
N_TOKENS, N_PATTERNS = 300, 4096
NAMES = ("dx", "dK", "dU", "ds", "dt")
TILE = 32  # the streamed tile of K2 (patterns) and K3 (tokens)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: add 0x1000 to the int32 view,
    then clear the low 13 bits (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int, tile: int | None = None) -> torch.Tensor:
    """``a @ b`` in 8-deep steps over the last axis of a, f32 sums: three
    TF32 passes (small·big, big·small, big·big, in that order) or one.
    ``tile``: the kernels' long products (over the patterns or the tokens)
    sum each tile of that depth in a fresh sum, added to the running one
    after the tile."""
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    depth = a.shape[1]
    for t0 in range(0, depth, tile or depth):
        out = torch.zeros_like(total)
        for k0 in range(t0, min(t0 + (tile or depth), depth), 8):
            k = slice(k0, k0 + 8)
            if passes == 3:
                out = out + a_small[:, k] @ b_big[k]
                out = out + a_big[:, k] @ b_small[k]
            out = out + a_big[:, k] @ b_big[k]
        total = total + out
    return total


def attention_tf32(x2, K, U, s, t, g, m, l, delta, passes):
    """``(A, dS, q, x̂, inv)`` of the plain backward with ``q Kᵀ`` and
    ``g Uᵀ`` taken by :func:`matmul_tf32`."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    xhat, inv = hc._state_ln(x2)
    q = hc._query(xhat, s, t)
    a = torch.exp(matmul_tf32(q, K.T, passes) * beta - m) / l
    ds = a * (matmul_tf32(g, U.T, passes) - delta) * beta
    return a, ds, q, xhat, inv


def backward_tf32(x2, K, U, s, t, g, m, l, delta, passes):
    """``(dx, dK, dU, ds, dt)``: the plain backward with every product taken
    by :func:`matmul_tf32`; the LayerNorm backward in float64, as in K2."""
    a, dsc, q, xhat, inv = attention_tf32(x2, K, U, s, t, g, m, l, delta, passes)
    dq = matmul_tf32(dsc, K, passes, tile=TILE).double()
    dxhat = dq * s.double()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dk = matmul_tf32(dsc.T.contiguous(), q, passes, tile=TILE)
    du = matmul_tf32(a.T.contiguous(), g, passes, tile=TILE)
    return dx.float(), dk, du, (dq * xhat).sum(0).float(), dq.sum(0).float()


def _case(d_in, d_out, seed=5):
    """Seeded inputs, the row stats and ``delta`` from the f32 plain
    forward. At d_in = 3 the tokens are the quantized grid ``zq / 511``
    that the third lookup reads."""
    rng = np.random.default_rng(seed + d_in + d_out)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if d_in == 3:
        x = torch.from_numpy((rng.integers(0, 512, (N_TOKENS, 3)) / 511).astype(np.float32))
    else:
        x = f(N_TOKENS, d_in)
    k, u, g = f(N_PATTERNS, d_in), f(N_PATTERNS, d_out), f(N_TOKENS, d_out)
    s, t = 1 + 0.2 * f(d_in), 0.2 * f(d_in)
    out, m, l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    return (x, k, u, s, t, g, m, l, (g * out).sum(-1, keepdim=True))


FWD_WIDTHS = WIDTHS + [(256, 256)]
FWD_TILE = 64  # K1's pattern tile at widths up to 64
OUT_ATOL, STAT_RTOL = 1e-4, 1e-5  # chip_smoke.py: K1 against its plain version
FUSED_ZQ_SHARE = 1e-4  # chip_smoke.py: the share of K4's zq bins that may differ


def forward_tf32(x2, K, U, s, t, passes, tile=FWD_TILE):
    """``(out, m, l)`` of K1's walk: the scores by :func:`matmul_tf32`, an
    online softmax over pattern tiles of ``tile``, each tile's ``P U`` by
    :func:`matmul_tf32` (8-deep steps, one fresh sum a tile) added to the
    rescaled running output, and the denominator as a compensated sum
    (TwoSum of the rescaled sum and the tile's, the error term rescaled
    with it)."""
    beta = 1.0 / math.sqrt(x2.shape[1])
    xhat, _ = hc._state_ln(x2)
    q = hc._query(xhat, s, t)
    n = x2.shape[0]
    m = torch.full((n, 1), -1e30)
    l, l_lo = torch.zeros(n, 1), torch.zeros(n, 1)
    acc = torch.zeros(n, U.shape[1])
    for p0 in range(0, K.shape[0], tile):
        sc = matmul_tf32(q, K[p0:p0 + tile].T.contiguous(), passes) * beta
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        a, b = l * alpha, l_lo * alpha + p.sum(-1, keepdim=True)
        total = a + b
        bb = total - a
        l, l_lo = total, (a - (total - bb)) + (b - bb)
        acc = acc * alpha + matmul_tf32(p, U[p0:p0 + tile].contiguous(), passes)
        m = m_new
    l = l + l_lo
    return acc / l, m, l


def _float64_forward(x, k, u, s, t):
    """``(out, m, l)`` of the lookup in float64 throughout."""
    x, k, u, s, t = (a.double() for a in (x, k, u, s, t))
    cent = x - x.mean(-1, keepdim=True)
    q = cent * torch.rsqrt((cent * cent).mean(-1, keepdim=True) + 1e-5) * s + t
    sc = q @ k.T / math.sqrt(x.shape[1])
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    return p @ u / p.sum(-1, keepdim=True), m, p.sum(-1, keepdim=True)


def _forward_errors(got, want) -> tuple[float, float, float]:
    """``out`` max abs, ``m`` relative (floored at 1: it enters only as
    ``exp(sc - m)``) and ``l`` relative, as ``chip_smoke.py`` measures K1."""
    (o, m, l), (wo, wm, wl) = [[a.double() for a in x] for x in (got, want)]
    return (float((o - wo).abs().max()), float(((m - wm).abs() / wm.abs().clamp_min(1.0)).max()),
            float(((l - wl).abs() / wl).max()))


def _normwise(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max()) for a, b in zip(got, want))


def _float64_backward(args):
    """``(dx, dK, dU, ds, dt)`` of the lookup in float64 throughout."""
    x, k, u, s, t, g = (a.double() for a in args[:6])
    beta = 1.0 / math.sqrt(x.shape[1])
    cent = x - x.mean(-1, keepdim=True)
    inv = torch.rsqrt((cent * cent).mean(-1, keepdim=True) + 1e-5)
    xhat = cent * inv
    q = xhat * s + t
    a = torch.softmax(q @ k.T * beta, dim=-1)
    dsc = a * (g @ u.T - (g * (a @ u)).sum(-1, keepdim=True)) * beta
    dq = dsc @ k
    dxhat = dq * s
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dsc.T @ q, a.T @ g, (dq * xhat).sum(0), dq.sum(0)


@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_three_pass_backward_matches_the_plain_version(d_in, d_out):
    """Three TF32 passes in every product: each of dx, dK, dU, ds and dt
    within ``BWD_NORMWISE`` of the f32 plain version, and no farther from a
    float64 backward than twice the plain version's distance, or 2e-6 (it
    lands where f32 does)."""
    args = _case(d_in, d_out)
    got = backward_tf32(*args, passes=3)
    plain = hc.stream_lookup_bwd_reference(*args)
    for name, a, b in zip(NAMES, got, plain):
        assert a.shape == b.shape, name
        assert _normwise([a], [b]) <= BWD_NORMWISE, name
    exact = _float64_backward(args)
    assert _normwise(got, exact) <= max(2 * _normwise(plain, exact), 2e-6)


@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_one_pass_backward_misses_the_tolerance(d_in, d_out):
    """The guard: with one TF32 pass (big·big alone) in every product, some
    gradient lies more than ``BWD_NORMWISE`` from a float64 backward at
    every width, so K2 and K3 need the three passes."""
    args = _case(d_in, d_out)
    assert _normwise(backward_tf32(*args, passes=1), _float64_backward(args)) > BWD_NORMWISE


@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_three_pass_attention_against_k1_stats_sums_to_one(d_in, d_out):
    """A rebuilt from three-pass scores against the f32 forward's ``m`` and
    ``l`` (K1's FMA sums in the kernels) sums to 1 within 1e-5 on every
    row: the two score sums differ by far less than that moves A."""
    args = _case(d_in, d_out)
    a, *_ = attention_tf32(*args, passes=3)
    assert float((a.double().sum(-1) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("d_in,d_out", FWD_WIDTHS)
def test_three_pass_forward_matches_the_plain_version(d_in, d_out):
    """K1's walk with three TF32 passes: out, m and l within ``OUT_ATOL``
    and ``STAT_RTOL`` of the f32 plain version, and no farther from a
    float64 forward than twice the plain version's distance, or 5e-8 (out),
    5e-7 (m) and 2e-6 (l; the plain version's own lies 4e-7 to 3e-6 from
    float64): it lands where f32 does."""
    x, k, u, s, t, *_ = _case(d_in, d_out)
    got = forward_tf32(x, k, u, s, t, passes=3)
    plain = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    assert [a.shape for a in got] == [a.shape for a in plain]
    out_err, m_err, l_err = _forward_errors(got, plain)
    assert out_err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL
    exact = _float64_forward(x, k, u, s, t)
    for mine, theirs, floor in zip(_forward_errors(got, exact), _forward_errors(plain, exact), (5e-8, 5e-7, 2e-6)):
        assert mine <= max(2 * theirs, floor)


@pytest.mark.parametrize("d_in,d_out", FWD_WIDTHS)
def test_one_pass_forward_misses_the_tolerance(d_in, d_out):
    """The guard: with one TF32 pass in both products, K1's row stats lie
    more than ``STAT_RTOL`` from a float64 forward at every width, so K1
    needs the three passes (K2 and K3 rebuild the attention from them)."""
    x, k, u, s, t, *_ = _case(d_in, d_out)
    _, m_err, l_err = _forward_errors(forward_tf32(x, k, u, s, t, passes=1), _float64_forward(x, k, u, s, t))
    assert max(m_err, l_err) > STAT_RTOL


@pytest.mark.parametrize("d_in,d_out", FWD_WIDTHS)
def test_backward_from_three_pass_forward_stats_sums_to_one(d_in, d_out):
    """The backward's attention rebuilt from three-pass scores against the
    ``m`` and ``l`` of three-pass K1 (not the f32 plain forward's) sums to
    1 within 1.5e-7 on every row: as close as against the plain stats."""
    x, k, u, s, t, g, *_ = _case(d_in, d_out)
    out, m, l = forward_tf32(x, k, u, s, t, passes=3)
    a, *_ = attention_tf32(x, k, u, s, t, g, m, l, (g * out).sum(-1, keepdim=True), passes=3)
    assert float((a.double().sum(-1) - 1).abs().max()) <= 1.5e-7


def test_fused_bottleneck_emulation_flips_few_bins():
    """K4 as three three-pass K1 walks with the sigmoid and the round
    between them, at M 4096, d 64, di 3 on 1,024 tokens, against its plain
    version: at most ``FUSED_ZQ_SHARE`` of the zq bins differ, and e, and r
    where zq agrees, within 1e-5 (phase 12's limits)."""
    from hopvae_torch.ops.hopfield import HopfieldLookup

    gen = torch.Generator().manual_seed(8)
    layers = []
    for d_in, d_out in ((64, 64), (64, 3), (3, 64)):
        layer = HopfieldLookup(d_in, d_out, N_PATTERNS, device="cpu")
        layer.reset_parameters(generator=gen)
        layers.append(layer)
    x = torch.randn(1024, 64, generator=gen)
    levels = 511
    with torch.no_grad():
        (k1, u1, b1, s1, t1), (k2, u2, b2, s2, t2), (k3, u3, b3, s3, t3) = (hc.fold_layer(a) for a in layers)
        e = forward_tf32(x, k1, u1, s1, t1, passes=3)[0] + b1
        logits = forward_tf32(e, k2, u2, s2, t2, passes=3)[0] + b2
        zq = torch.round(torch.sigmoid(logits) * levels)
        r = forward_tf32(zq / levels, k3, u3, s3, t3, passes=3)[0] + b3
        e_w, zq_w, r_w = hc.bottleneck_fused_fwd_reference(*layers, x, levels + 1)
    same = (zq == zq_w).all(-1)
    assert float((zq != zq_w).float().mean()) <= FUSED_ZQ_SHARE
    assert float((e - e_w).abs().max()) <= 1e-5 and float((r - r_w)[same].abs().max()) <= 1e-5
