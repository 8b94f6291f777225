"""The port's causal attention against the JAX package's, on the CPU.

The port's dense, blocked and flash backends (``hopvae_torch.ops.attention``;
flash takes the blocked path on CPU tensors, as JAX's does off the TPU)
against JAX's three, values and gradients, at the shapes of
``tests/test_transformer_prior.py``; the plain versions of the K5 kernels
(``ops/attention_cuda.py``) against torch autograd of the dense backend;
``FlashCausalAttention`` on CPU tensors; head widths of 48 (zero-padded
to 64 on the kernels' route) and 256 (the 32-row tiles) against JAX's
flash backend; the wrappers' checks. Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.ops import attention as jax_attention
from hopvae_torch.ops import attention as A
from hopvae_torch.ops import attention_cuda as ac

# (S, q_block, kv_block) of tests/test_transformer_prior.py: S a multiple
# of no block, of one, below one, and blocks of 2 and 3
SHAPES = [(37, 16, 8), (48, 16, 16), (16, 64, 64), (5, 2, 3)]
BACKENDS = ("dense", "blocked", "flash")


def _inputs(s, seed=0, h=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((2, s, h, dh), dtype=np.float32) for _ in range(4))
    return q, k, v, w


def _jax_fn(name, qb, kb):
    if name == "blocked":
        return lambda q, k, v: jax_attention.blocked_causal_attention(q, k, v, q_block=qb, kv_block=kb)
    return getattr(jax_attention, f"{name}_causal_attention")


def _torch_fn(name, qb, kb):
    if name == "blocked":
        return lambda q, k, v: A.blocked_causal_attention(q, k, v, q_block=qb, kv_block=kb)
    return getattr(A, f"{name}_causal_attention")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s,qb,kb", SHAPES)
def test_backend_matches_jax(backend, s, qb, kb):
    """Values within 1e-5 and the gradients of ``sum(out * w)`` within
    rtol 2e-4, atol 2e-5: the tolerances of the JAX package's own
    blocked-against-dense test."""
    q, k, v, w = _inputs(s)
    jfn, tfn = _jax_fn(backend, qb, kb), _torch_fn(backend, qb, kb)
    want = jfn(*(jnp.asarray(a) for a in (q, k, v)))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * w), (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = tfn(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for name, leaf, g in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("s", [5, 37, 48])
def test_plain_kernel_versions_match_autograd_of_dense(s):
    """K5's plain versions: the forward's ``out`` and ``lse``, and the
    backward rebuilt from ``lse``, against the dense backend and its
    autograd gradients."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(s, seed=1))
    scale = 1 / math.sqrt(q.shape[-1])
    out, lse = ac.causal_attention_fwd_reference(q, k, v, scale)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    torch.testing.assert_close(lse, torch.logsumexp(sc.masked_fill(~mask, -torch.inf), -1), rtol=1e-6, atol=1e-6)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    dense = A.dense_causal_attention(*leaves)
    torch.testing.assert_close(out, dense.detach(), rtol=1e-5, atol=1e-6)
    dense.backward(g)
    grads = ac.causal_attention_bwd_reference(q, k, v, out, lse, g, scale)
    for name, got, leaf in zip("qkv", grads, leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-4, atol=1e-5, msg=name)


def test_flash_autograd_function_on_cpu_takes_the_plain_versions():
    """``FlashCausalAttention`` on CPU tensors, with q, k, v strided views
    of one projection as the prior gives them: the plain versions, forward
    and backward, equal the dense backend's values and gradients."""
    rng = np.random.default_rng(2)
    b, s, h, dh = 2, 21, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * dh), dtype=np.float32)).requires_grad_()
    views = [qkv[..., i * h * dh : (i + 1) * h * dh].reshape(b, s, h, dh) for i in range(3)]
    assert not views[0].is_contiguous()
    g = torch.from_numpy(rng.standard_normal((b, s, h, dh), dtype=np.float32))
    out = ac.FlashCausalAttention.apply(*views, 1 / math.sqrt(dh))
    (grad,) = torch.autograd.grad(out, qkv, g)
    ref = A.dense_causal_attention(*views)
    (ref_grad,) = torch.autograd.grad(ref, qkv, g)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4, atol=1e-5)


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        ac.causal_attention_fwd(q.double(), q, q, 0.3)
    with pytest.raises(ValueError, match="does not match"):
        ac.causal_attention_fwd(q, torch.zeros(1, 5, 2, 8), q, 0.3)
    with pytest.raises(ValueError, match="head width"):
        ac.causal_attention_fwd(q, q.transpose(-1, -2).contiguous().transpose(-1, -2), q, 0.3)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="lse"):
        ac.causal_attention_bwd_dq(q, q, q, q, lse[:, :, :3], lse, 0.3)
    # no CPU fallback past the wrapper: another device launches or raises
    meta = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ac.causal_attention_fwd(meta, meta, meta, 0.3)
    wide = torch.zeros(1, 4, 1, 256, device="meta")  # built since the 32-row tiles
    with pytest.raises(ValueError, match="no kernel"):
        ac.causal_attention_fwd(wide, wide, wide, 0.0625)
    for width in (384, 512, 1024):  # past 256 the wide kernels take every multiple of 128
        wider = torch.zeros(1, 4, 1, width, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            ac.causal_attention_fwd(wider, wider, wider, 0.05)
        with pytest.raises(ValueError, match="no kernel"):
            A.flash_causal_attention(wider, wider, wider)
    for width in (48, 320):  # the wrappers take the kernels' widths; the route pads
        odd = torch.zeros(1, 4, 1, width, device="meta")
        with pytest.raises(ValueError, match="zero-pads"):
            ac.causal_attention_fwd(odd, odd, odd, 0.1)
    assert ac.causal_attention_fwd.launches == ac.causal_attention_bwd_dq.launches == 0


@pytest.mark.parametrize("dh", [48, 256, 384])
def test_wide_and_padded_heads_match_jax(dh, monkeypatch):
    """A head width the kernels reach through the zero padding (48 → 64),
    the widest of their built instances (256, 32-row tiles) and one of the
    wide kernels (384, a cluster of three blocks): the port's flash
    backend (CPU: blocked), the kernels' route ``kernel_causal_attention``
    (the padding, then ``FlashCausalAttention`` on the plain versions) and
    the plain versions themselves, against JAX's ``flash_causal_attention``
    (blocked off the TPU). Values within rtol 1e-5, atol 1e-6; the
    gradients of ``sum(out * w)`` within rtol 1e-4, atol 1e-5."""
    q, k, v, w = _inputs(37, seed=5, h=2, dh=dh)
    jflash = jax_attention.flash_causal_attention
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v))))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jflash(q, k, v) * w), (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    scale = 1 / math.sqrt(dh)
    widths = []
    fwd = ac.causal_attention_fwd
    monkeypatch.setattr(ac, "causal_attention_fwd", lambda q, *rest: widths.append(q.shape[-1]) or fwd(q, *rest))
    routes = {"flash": A.flash_causal_attention, "kernel route": lambda *a: A.kernel_causal_attention(*a, scale)}
    for name, fn in routes.items():
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        got = fn(*leaves)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
        (got * torch.from_numpy(w)).sum().backward()
        for leaf, g, n in zip(leaves, jgrads, "qkv"):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=f"{name} d{n}")
    assert widths == [ac.kernel_width(dh)] == [{48: 64, 256: 256, 384: 384}[dh]]  # the route padded; flash took blocked
    qt, kt, vt, wt = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = ac.causal_attention_fwd_reference(qt, kt, vt, scale)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    for n, got, g in zip("qkv", ac.causal_attention_bwd_reference(qt, kt, vt, out, lse, wt, scale), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=f"plain d{n}")
