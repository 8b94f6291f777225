"""The port's Hopfield lookups and bottleneck against the JAX package.

The plain versions of the streaming kernels are held against the Pallas
forward ``_attn_call_fwd`` and the Pallas VJP of ``_attn_ln_stream``,
run in interpret mode (as tests/test_pallas.py runs them on the CPU); the
eager lookups and bottleneck against ``hopfield_lookup`` /
``hopfield_bottleneck_xla``, and the streaming bottleneck's gradients
against ``jax.grad``. Inputs and parameters come from numpy with a seed;
tolerances are those of tests/test_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hopvae_tpu.ops import hopfield_pallas as hp
from hopvae_tpu.ops import bottleneck as jax_bottleneck
from hopvae_tpu.ops.bottleneck import hopfield_bottleneck_xla
from hopvae_tpu.ops.hopfield import hopfield_lookup as jax_hopfield_lookup
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.ops.bottleneck import hopfield_bottleneck, streaming_bottleneck
from hopvae_torch.ops.hopfield import HopfieldLookup, hopfield_lookup
from hopvae_torch.utils.checkpoint import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
STAT_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6  # test_pallas_gradients_match_reference
SHAPES = [(40, 300, 64, 64), (37, 600, 64, 3), (16, 256, 3, 64)]  # ragged in N and M


def _np_params(rng, d_in, d_out, m):
    """One lookup's JAX pytree, every leaf random (LayerNorms included)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ln = lambda: {"scale": 1 + 0.2 * f(d_in), "bias": 0.2 * f(d_in)}
    return {
        "lookup_weights": f(m, d_in),
        "in_proj": {"kernel": f(d_in, d_in) / np.sqrt(d_in), "bias": 0.1 * f(d_in)},
        "out_proj": {"kernel": f(d_in, d_out) / np.sqrt(d_in), "bias": 0.1 * f(d_out)},
        "norm_stored": ln(), "norm_state": ln(), "norm_proj": ln(),
    }


def _torch_layer(p, d_in, d_out):
    layer = HopfieldLookup(d_in, d_out, p["lookup_weights"].shape[0], device="cpu")
    layer.load_state_dict(params_from_jax(p))
    return layer


def _jax(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.mark.parametrize("n,m,d_in,d_out", SHAPES)
def test_stream_reference_matches_pallas_forward(n, m, d_in, d_out):
    rng = np.random.default_rng(n + m)
    p = _np_params(rng, d_in, d_out, m)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    k, u, _b, s, t = hp._fold_layer(_jax(p))
    with pltpu.force_tpu_interpret_mode():
        ref = hp._attn_call_fwd(jnp.asarray(x), k, u, s, t, jax.lax.Precision.HIGHEST)
    with torch.no_grad():
        folded = hc.fold_layer(_torch_layer(p, d_in, d_out))
        for ours, theirs in zip(folded, hp._fold_layer(_jax(p))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)
        tk, tu, _tb, ts, tt = folded
        out, m_stat, l_stat = hc.stream_lookup_fwd_reference(torch.from_numpy(x), tk, tu, ts, tt)
    assert out.shape == (n, d_out) and m_stat.shape == (n, 1) and l_stat.shape == (n, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m_stat.numpy(), np.asarray(ref[1]), rtol=STAT_RTOL)
    np.testing.assert_allclose(l_stat.numpy(), np.asarray(ref[2]), rtol=STAT_RTOL)


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (64, 3), (3, 64)])
def test_lookups_match_jax(d_in, d_out):
    """Eager lookup and the folded streaming lookup (plain version) both
    equal the JAX eager lookup, on a batched (B, S, d_in) input."""
    rng = np.random.default_rng(d_in * 100 + d_out)
    p = _np_params(rng, d_in, d_out, 200)
    x = rng.standard_normal((2, 25, d_in)).astype(np.float32)
    ref = np.asarray(jax_hopfield_lookup(_jax(p), jnp.asarray(x)))
    layer = _torch_layer(p, d_in, d_out)
    with torch.no_grad():
        eager = hopfield_lookup(layer, torch.from_numpy(x))
        streamed = hc.hopfield_lookup_stream(layer, torch.from_numpy(x), impl="torch")
    np.testing.assert_allclose(eager.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(streamed.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,s", [(512, 64), (300, 37)])
def test_bottleneck_matches_jax(m, s):
    rng = np.random.default_rng(m + s)
    params = {
        "hopfield": _np_params(rng, 64, 64, m),
        "embedding_to_index": _np_params(rng, 64, 3, m),
        "index_to_embedding": _np_params(rng, 3, 64, m),
    }
    x = rng.standard_normal((3, s, 64)).astype(np.float32)
    ref = hopfield_bottleneck_xla(_jax(params), jnp.asarray(x), 512)
    layers = {
        "hopfield": _torch_layer(params["hopfield"], 64, 64),
        "embedding_to_index": _torch_layer(params["embedding_to_index"], 64, 3),
        "index_to_embedding": _torch_layer(params["index_to_embedding"], 3, 64),
    }
    with torch.no_grad():
        e, zq, r = hopfield_bottleneck(layers, torch.from_numpy(x), 512, impl="torch")
    np.testing.assert_allclose(e.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    # the quantized grid: a bin may flip where the logit sits on a .5 edge
    dz = np.abs(zq.numpy() - np.asarray(ref[1]))
    assert np.mean(dz == 0) >= 0.999 and dz.max() <= 1
    if dz.max() == 0:
        np.testing.assert_allclose(r.numpy(), np.asarray(ref[2]), rtol=RTOL, atol=ATOL)


def test_stream_lookup_fwd_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(0)
    x, k, u = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((5, 64), (70, 64), (70, 3)))
    s, t = torch.ones(64), torch.zeros(64)
    before = hc.stream_lookup_fwd.launches
    got = hc.stream_lookup_fwd(x, k, u, s, t)
    want = hc.stream_lookup_fwd_reference(x, k, u, s, t)
    assert hc.stream_lookup_fwd.launches == before  # no kernel launched
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stream_lookup_fwd_checks_its_inputs():
    x, k, u = torch.zeros(5, 64), torch.zeros(70, 64), torch.zeros(70, 3)
    s, t = torch.ones(64), torch.zeros(64)
    with pytest.raises(TypeError, match="float32"):
        hc.stream_lookup_fwd(x.double(), k, u, s, t)
    with pytest.raises(ValueError, match="contiguous"):
        hc.stream_lookup_fwd(torch.zeros(64, 5).T, k, u, s, t)
    with pytest.raises(ValueError, match="shapes disagree"):
        hc.stream_lookup_fwd(x, torch.zeros(70, 32), u, s, t)
    with pytest.raises(ValueError, match="not in"):
        hc.stream_lookup_fwd(torch.zeros(5, 32), torch.zeros(70, 32), u, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="at least one row"):
        hc.stream_lookup_fwd(torch.zeros(0, 64), k, u, s, t)


def test_cuda_impl_on_cpu_tensors_raises():
    layer = HopfieldLookup(64, 3, 50, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hc.hopfield_lookup_stream(layer, torch.zeros(2, 4, 64), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        hc.hopfield_lookup_stream(layer, torch.zeros(2, 4, 64), impl="pallas")


def _layers(params):
    return {
        "hopfield": _torch_layer(params["hopfield"], 64, 64),
        "embedding_to_index": _torch_layer(params["embedding_to_index"], 64, 3),
        "index_to_embedding": _torch_layer(params["index_to_embedding"], 3, 64),
    }


@pytest.mark.parametrize("n,m,d_in,d_out", SHAPES)
def test_stream_backward_matches_pallas_vjp(n, m, d_in, d_out):
    """All five cotangents of the plain backward, and of the autograd
    function on CPU tensors, against ``jax.vjp`` of ``_attn_ln_stream``,
    whose backward is the two Pallas kernels in interpret mode."""
    rng = np.random.default_rng(7 * n + m)
    p = _np_params(rng, d_in, d_out, m)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    g = rng.standard_normal((n, d_out)).astype(np.float32)
    folded = [np.array(a) for a in hp._fold_layer(_jax(p))]  # writable copies
    k, u, _b, s, t = folded
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(
            lambda *a: hp._attn_ln_stream(*a, jax.lax.Precision.HIGHEST), *map(jnp.asarray, (x, k, u, s, t))
        )
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]

    xt, kt, ut, st, tt, gt = map(torch.from_numpy, (x, k, u, s, t, g))
    out, m_stat, l_stat = hc.stream_lookup_fwd_reference(xt, kt, ut, st, tt)
    delta = (gt * out).sum(-1, keepdim=True)
    plain = hc.stream_lookup_bwd_reference(xt, kt, ut, st, tt, gt, m_stat, l_stat, delta)

    leaves = [a.clone().requires_grad_() for a in (xt, kt, ut, st, tt)]
    got_out = hc.stream_lookup(*leaves)
    got_out.backward(gt)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    for name, a, b, w in zip(("dx", "dK", "dU", "ds", "dt"), plain, leaves, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        torch.testing.assert_close(b.grad, a, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("m,s", [(128, 16), (600, 40)])
def test_streaming_bottleneck_gradients_match_jax(m, s):
    """The port's streaming bottleneck (autograd function on CPU tensors,
    table fold by autograd) against ``jax.grad`` of the loss of
    tests/test_pallas.py::test_pallas_gradients_match_reference, for the
    input and every parameter of the three lookups."""
    rng = np.random.default_rng(m + s)
    params = {
        "hopfield": _np_params(rng, 64, 64, m),
        "embedding_to_index": _np_params(rng, 64, 3, m),
        "index_to_embedding": _np_params(rng, 3, 64, m),
    }
    x = rng.standard_normal((2, s, 64)).astype(np.float32)

    def loss(p, xx):
        e, zq, r = jax_bottleneck.hopfield_bottleneck_xla(p, xx, 512)
        return jnp.mean((r - e) ** 2) + jnp.mean(e) + 1e-4 * jnp.mean(zq)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(_jax(params), jnp.asarray(x))
    want = params_from_jax(g_params)

    layers = _layers(params)
    xt = torch.from_numpy(x).requires_grad_()
    e, zq, r = streaming_bottleneck(layers, xt, 512, impl="torch")
    (torch.mean((r - e) ** 2) + torch.mean(e) + 1e-4 * torch.mean(zq)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for lname, layer in layers.items():
        for pname, param in layer.named_parameters():
            np.testing.assert_allclose(
                param.grad.numpy(), want[f"{lname}.{pname}"].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f"{lname}.{pname}",
            )


def test_stream_backward_on_cpu_takes_the_plain_versions():
    rng = np.random.default_rng(1)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, k, u, g = f(9, 64), f(70, 64), f(70, 3), f(9, 3)
    s, t = 1 + 0.1 * f(64), 0.1 * f(64)
    out, m, l = hc.stream_lookup_fwd(x, k, u, s, t)
    delta = (g * out).sum(-1, keepdim=True)
    before = (hc.stream_bwd_dx.launches, hc.stream_bwd_dku.launches)
    got = (*hc.stream_bwd_dx(x, k, u, s, t, g, m, l, delta), *hc.stream_bwd_dku(x, k, u, s, t, g, m, l, delta))
    assert (hc.stream_bwd_dx.launches, hc.stream_bwd_dku.launches) == before  # no kernel launched
    dx, dk, du, ds, dt = hc.stream_lookup_bwd_reference(x, k, u, s, t, g, m, l, delta)
    for a, b in zip(got, (dx, ds, dt, dk, du)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stream_backward_checks_its_inputs():
    x, k, u = torch.zeros(5, 64), torch.zeros(70, 64), torch.zeros(70, 3)
    s, t, g, stat = torch.ones(64), torch.zeros(64), torch.zeros(5, 3), torch.ones(5, 1)
    with pytest.raises(ValueError, match="backward shapes"):
        hc.stream_bwd_dx(x, k, u, s, t, torch.zeros(5, 64), stat, stat, stat)
    with pytest.raises(ValueError, match="backward shapes"):
        hc.stream_bwd_dku(x, k, u, s, t, g, stat, torch.ones(5), stat)
    with pytest.raises(TypeError, match="float32"):
        hc.stream_bwd_dku(x, k, u, s, t, g.double(), stat, stat, stat)
    with pytest.raises(ValueError, match="CPU tensors"):
        hc.hopfield_lookup_stream(HopfieldLookup(64, 3, 50, device="meta"), torch.zeros(2, 4, 64, device="meta"),
                                  impl="torch")
