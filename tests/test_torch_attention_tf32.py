"""The precision scheme of K5's kernels, emulated on the CPU.

K5-fwd, K5-dkv and K5-dq (``hopvae_torch/csrc/causal_attention_fwd.cu``
and ``causal_attention_bwd.cu``) run every product on the tensor cores as
TF32 ``mma.sync`` in three passes: each f32
operand x splits into ``big = tf32(x)`` and ``small = tf32(x - big)``,
rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, 10
mantissa bits), and each 8-deep step of a product adds ``small_a big_b``,
then ``big_a small_b``, then ``big_a big_b`` to an f32 sum. This file
builds that product from the rounding alone (the emulation lives here, on
no path of the package) and puts it in place of every product of K5's
plain forward and backward (``ops/attention_cuda.py``): ``q kᵀ`` and ``P v``;
``q kᵀ``, ``g vᵀ``, ``Pᵀ g``, ``dSᵀ q`` and ``dS k``.

Measured here (B 2, 2 heads, normwise ``max|a - b| / max|b|``, the worst of
dQ, dK and dV against a float64 backward, over ``SHAPES``): three passes
2.6e-7 to 1.2e-6 (the f32 plain version: 1.4e-7 to 8.5e-7); one pass
6.0e-4 to 9.7e-4, 12 to 19 times the 5e-5 (``ATTN_BWD_NORMWISE`` of ``chip_smoke.py``) the
card holds the kernels to. Three passes hold JAX's
``flash_causal_attention`` gradients at the tolerances of
``tests/test_torch_attention.py`` (rtol 1e-4, atol 1e-5); one pass is why
the kernels do not take it.

The forward, over ``SHAPES`` (measured here, normwise against a float64
forward): three passes 1.6e-7 to 3.5e-7, and ``lse`` within 9.6e-7 of the
f32 plain version's; one pass 3.6e-4 to 5.6e-4, with ``lse`` off by up to
1.3e-3, 36 to 56 times the 1e-5 (``ATTN_FWD_NORMWISE``) the card holds
K5-fwd to.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.ops import attention as jax_attention
from hopvae_torch.ops import attention_cuda as ac

ATTN_FWD_NORMWISE = 1e-5  # chip_smoke.py: K5-fwd against its plain version
ATTN_BWD_NORMWISE = 5e-5  # chip_smoke.py: K5's backward against its plain version
SHAPES = [(s, dh) for s in (5, 37, 48) for dh in (8, 32, 256)]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: add 0x1000 to the int32 view,
    then clear the low 13 bits (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` over the last axis of a in 8-deep steps, f32 sums, as the
    kernels' ``mma.sync`` m16n8k8 runs it: three passes (small·big,
    big·small, big·big, in that order) or one (big·big)."""
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        if passes == 3:
            out = out + a_small[ka] @ b_big[kb]
            out = out + a_big[ka] @ b_small[kb]
        out = out + a_big[ka] @ b_big[kb]
    return out


def forward_tf32(q, k, v, scale, passes):
    """K5's plain forward with both products taken by :func:`matmul_tf32`:
    ``(out (B, S, heads, dh), lse (B, heads, S))``."""
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    scores = matmul_tf32(qh, kh.transpose(-1, -2), passes) * scale
    lse = torch.logsumexp(torch.where(mask, scores, float("-inf")), dim=-1)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    return matmul_tf32(p, vh, passes).transpose(1, 2), lse


def backward_tf32(q, k, v, g, lse, delta, scale, passes):
    """K5's plain backward with every product taken by :func:`matmul_tf32`:
    ``(dQ, dK, dV)`` over ``(B, S, heads, dh)``."""
    qh, kh, vh, gh = (a.transpose(1, 2) for a in (q, k, v, g))
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    scores = matmul_tf32(qh, kh.transpose(-1, -2), passes)
    p = torch.where(mask, torch.exp(scores * scale - lse[..., None]), 0.0)
    ds = p * (matmul_tf32(gh, vh.transpose(-1, -2), passes) - delta[..., None])
    dv = matmul_tf32(p.transpose(-1, -2), gh, passes)
    dk = matmul_tf32(ds.transpose(-1, -2), qh, passes) * scale
    dq = matmul_tf32(ds, kh, passes) * scale
    return tuple(a.transpose(1, 2) for a in (dq, dk, dv))


def _case(s, dh, seed=7):
    """Seeded numpy inputs (B 2, 2 heads) and ``(scale, lse, delta)`` from
    the plain f32 forward, as the kernels get them from K5-fwd."""
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((2, s, 2, dh), dtype=np.float32) for _ in range(4))
    qt, kt, vt, wt = (torch.from_numpy(a) for a in (q, k, v, w))
    scale = 1 / math.sqrt(dh)
    out, lse = ac.causal_attention_fwd_reference(qt, kt, vt, scale)
    return (q, k, v, w), (qt, kt, vt, wt), scale, out, lse, ac.attention_delta(out, wt)


def _normwise(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max() / b.double().abs().max()) for a, b in zip(got, want))


def _float64_grads(qt, kt, vt, wt, scale):
    q64, k64, v64, w64 = (a.double() for a in (qt, kt, vt, wt))
    out, lse = ac.causal_attention_fwd_reference(q64, k64, v64, scale)
    return ac.causal_attention_bwd_reference(q64, k64, v64, out, lse, w64, scale)


def test_round_tf32_is_round_to_nearest_ties_away():
    """10 mantissa bits kept; halfway cases go away from zero, both signs;
    values already in TF32 stay."""
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2**-23, -(1 + ulp / 2), 1 + 1.5 * ulp, 3.0, -0.0, 1e-30],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, -0.0, float(np.float32(1e-30))],
                        dtype=torch.float32)
    got = round_tf32(x)
    assert torch.equal(got[:6], want[:6])
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    assert abs(float(got[6]) / 1e-30 - 1) < 2**-11


@pytest.mark.parametrize("s,dh", SHAPES)
def test_three_pass_backward_matches_jax_and_the_plain_version(s, dh):
    """Three TF32 passes in every product: the gradients of ``sum(out * w)``
    within rtol 1e-4, atol 1e-5 of JAX's ``flash_causal_attention`` (blocked
    off the TPU), and within ``ATTN_BWD_NORMWISE`` of the f32 plain version;
    no farther from a float64 backward than twice the f32 plain version's
    distance, or 2e-6 (it lands where f32 does)."""
    (q, k, v, w), (qt, kt, vt, wt), scale, _out, lse, delta = _case(s, dh)
    jflash = jax_attention.flash_causal_attention
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jflash(q, k, v) * w), (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = backward_tf32(qt, kt, vt, wt, lse, delta, scale, passes=3)
    for n, a, g in zip("qkv", got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=f"d{n}")
    plain = ac.causal_attention_bwd_reference(qt, kt, vt, _out, lse, wt, scale)
    assert _normwise(got, plain) <= ATTN_BWD_NORMWISE
    exact = _float64_grads(qt, kt, vt, wt, scale)
    assert _normwise(got, exact) <= max(2 * _normwise(plain, exact), 2e-6)


@pytest.mark.parametrize("s,dh", SHAPES)
def test_one_pass_backward_misses_the_tolerance(s, dh):
    """The guard: one TF32 pass (big·big alone) moves dQ, dK or dV by more
    than ``ATTN_BWD_NORMWISE`` from a float64 backward at every shape, so
    the kernels need the three passes."""
    _, (qt, kt, vt, wt), scale, _out, lse, delta = _case(s, dh)
    one = backward_tf32(qt, kt, vt, wt, lse, delta, scale, passes=1)
    assert _normwise(one, _float64_grads(qt, kt, vt, wt, scale)) > ATTN_BWD_NORMWISE


@pytest.mark.parametrize("s,dh", SHAPES)
def test_three_pass_forward_matches_jax_and_the_plain_version(s, dh):
    """Both products in three TF32 passes: ``out`` within rtol 1e-5, atol
    2e-6 of JAX's ``flash_causal_attention`` (blocked off the TPU), within
    ``ATTN_FWD_NORMWISE`` of the f32 plain version, and no farther from a
    float64 forward than twice the plain version's distance, or 2e-6 (it
    lands where f32 does); ``lse`` within 1e-5 of the plain version's.

    The atol is 2e-6, not the 1e-6 of ``tests/test_torch_attention.py``: at
    S 48, dh 256 one of 49,152 values lies 1.18e-6 from JAX's (1.03e-6 past
    rtol 1e-5), where JAX's own forward lies 1.42e-6 from float64 and the
    emulation 1.07e-6. The gap is JAX's f32 rounding, not the scheme's."""
    (q, k, v, _w), (qt, kt, vt, _wt), scale, out, lse, _delta = _case(s, dh)
    want = np.asarray(jax_attention.flash_causal_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got_out, got_lse = forward_tf32(qt, kt, vt, scale, passes=3)
    np.testing.assert_allclose(got_out.numpy(), want, rtol=1e-5, atol=2e-6)
    assert _normwise([got_out], [out]) <= ATTN_FWD_NORMWISE
    assert float((got_lse - lse).abs().max()) <= 1e-5
    exact, _ = ac.causal_attention_fwd_reference(qt.double(), kt.double(), vt.double(), scale)
    assert _normwise([got_out], [exact]) <= max(2 * _normwise([out], [exact]), 2e-6)


@pytest.mark.parametrize("s,dh", SHAPES)
def test_one_pass_forward_misses_the_tolerance(s, dh):
    """The guard: with one TF32 pass in each product, ``out`` lies more than
    ``ATTN_FWD_NORMWISE`` from a float64 forward at every shape, so K5-fwd
    needs the three passes too."""
    _, (qt, kt, vt, _wt), scale, _out, _lse, _delta = _case(s, dh)
    one, _ = forward_tf32(qt, kt, vt, scale, passes=1)
    exact, _ = ac.causal_attention_fwd_reference(qt.double(), kt.double(), vt.double(), scale)
    assert _normwise([one], [exact]) > ATTN_FWD_NORMWISE
