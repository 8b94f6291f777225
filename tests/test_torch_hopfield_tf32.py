"""The precision scheme of K2 and K3, emulated on the CPU.

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
