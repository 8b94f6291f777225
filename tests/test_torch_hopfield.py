"""The port's Hopfield lookups and bottleneck against the JAX package.

The plain versions of the streaming kernels are held against the Pallas
forward ``_attn_call_fwd`` and the Pallas VJP of ``_attn_ln_stream``,
run in interpret mode (as tests/test_pallas.py runs them on the CPU); the
eager lookups and bottleneck against ``hopfield_lookup`` /
``hopfield_bottleneck_xla``, and the streaming bottleneck's gradients
against ``jax.grad``. Inputs and parameters come from numpy with a seed;
tolerances are those of tests/test_pallas.py.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

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
# other widths, which the kernels take zero-padded to a built instance;
# the plain versions take them, as the Pallas kernels do
SHAPES += [(24, 200, 32, 32), (19, 150, 64, 4), (21, 130, 128, 128), (23, 140, 5, 128), (18, 170, 128, 5)]
# widths past 128, which the kernels take at their 256 instances
SHAPES += [(17, 140, 256, 256), (19, 150, 200, 3), (16, 130, 3, 200)]
# widths past 256, which the kernels take on their wide variants
SHAPES += [(15, 130, 384, 3), (14, 120, 3, 384), (13, 110, 300, 520)]


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


def _f64_forward(x, k, u, s, t):
    """The streaming forward ``(out, m, l)`` in float64 numpy from the same
    folded tables: the arbiter named in a failure's message."""
    k, u, s, t = (np.asarray(a, np.float64) for a in (k, u, s, t))
    xc = x - x.mean(-1, keepdims=True)
    q = xc / np.sqrt((xc**2).mean(-1, keepdims=True) + 1e-5) * s + t
    sc = q @ k.T / np.sqrt(x.shape[1])
    m = sc.max(-1, keepdims=True)
    p = np.exp(sc - m)
    return p @ u / p.sum(-1, keepdims=True), m, p.sum(-1, keepdims=True)


# one compiled program for the Pallas forward, evaluated twice in each test
_pallas_fwd = jax.jit(hp._attn_call_fwd, static_argnums=5)


@pytest.mark.parametrize("n,m,d_in,d_out", SHAPES)
def test_stream_reference_matches_pallas_forward(n, m, d_in, d_out):
    """The plain version of K1 against the Pallas forward in interpret
    mode. The reference runs as one jitted program, twice, and must repeat
    itself bit for bit; a mismatch names both sides' distance to a float64
    forward of the same tables, so it says which side moved."""
    rng = np.random.default_rng(n + m)
    p = _np_params(rng, d_in, d_out, m)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    k, u, _b, s, t = hp._fold_layer(_jax(p))
    with pltpu.force_tpu_interpret_mode():
        ref, again = ([np.asarray(a) for a in _pallas_fwd(jnp.asarray(x), k, u, s, t, jax.lax.Precision.HIGHEST)]
                      for _ in range(2))
    for a, b in zip(ref, again):
        np.testing.assert_array_equal(a, b, err_msg="the interpret-mode reference did not repeat itself")
    with torch.no_grad():
        folded = hc.fold_layer(_torch_layer(p, d_in, d_out))
        for ours, theirs in zip(folded, hp._fold_layer(_jax(p))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)
        tk, tu, _tb, ts, tt = folded
        got = [a.numpy() for a in hc.stream_lookup_fwd_reference(torch.from_numpy(x), tk, tu, ts, tt)]
    assert [a.shape for a in got] == [(n, d_out), (n, 1), (n, 1)]
    exact = _f64_forward(x, k, u, s, t)
    for name, a, b, e, rtol, atol in zip(("out", "m", "l"), got, ref, exact, (RTOL, STAT_RTOL, STAT_RTOL),
                                         (ATOL, 0, 0)):
        arbiter = f"{name}: max |port - f64| {np.abs(a - e).max():.3g}, max |pallas - f64| {np.abs(b - e).max():.3g}"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=arbiter)


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
    # on the CPU the plain version takes a width the kernels are not built for
    out, m, l = hc.stream_lookup_fwd(torch.zeros(5, 32), torch.zeros(70, 32), u, torch.ones(32), torch.zeros(32))
    assert (out.shape, m.shape, l.shape) == ((5, 3), (5, 1), (5, 1))
    with pytest.raises(ValueError, match="at least one row"):
        hc.stream_lookup_fwd(torch.zeros(0, 64), k, u, s, t)


def _meta_arrays(n, m, d_in, d_out):
    """A lookup's forward inputs and the backward's ``(g, m, l, delta)``
    as meta tensors."""
    a = [torch.zeros(*shape, device="meta") for shape in ((n, d_in), (m, d_in), (m, d_out), (d_in,), (d_in,))]
    return a, [torch.zeros(*shape, device="meta") for shape in ((n, d_out), (n, 1), (n, 1), (n, 1))]


def _launch_counts():
    return hc.stream_lookup_fwd.launches, hc.stream_bwd_dx.launches, hc.stream_bwd_dku.launches


@pytest.mark.parametrize("device", ["meta", "cuda"])
def test_card_path_at_an_unbuilt_width_names_the_roadmap(device, monkeypatch):
    """Past ``BUILT_WIDTH`` (256) the card path takes the wide variants
    (the ROADMAP item that this test once named is done): no width raises.
    On meta tensors the forward and both backward wrappers reach the
    device check; on CUDA-typed tensors (meta tensors that report
    ``device.type == "cuda"``, so no card is needed), with the launcher
    recording instead of launching, K1 calls its ``_wide`` entry with a
    scratch and K2 and K3 their entries with theirs."""
    class CudaTyped:  # a meta tensor whose device says cuda
        def __init__(self, t):
            self.t = t

        def __getattr__(self, name):
            return getattr(self.t, name)

        @property
        def device(self):
            return torch.device("cuda")

    assert hc.kernel_route(300, 32) == "wide"
    fwd, rest = _meta_arrays(5, 70, 300, 32)
    calls = (lambda: hc.stream_lookup_fwd(*fwd), lambda: hc.stream_bwd_dx(*fwd, *rest),
             lambda: hc.stream_bwd_dku(*fwd, *rest))
    if device == "meta":
        before = _launch_counts()
        for call in calls:
            with pytest.raises(ValueError, match="no kernel"):
                call()
        assert _launch_counts() == before
        return
    fwd[:], rest[:] = [CudaTyped(a) for a in fwd], [CudaTyped(a) for a in rest]
    entries, scratch = [], []
    monkeypatch.setattr(hc, "_bind", lambda stem, name, n_ptrs, n_ints: (name, n_ptrs, n_ints))
    monkeypatch.setattr(hc, "_workspace_floats", lambda stem, name, *sizes: scratch.append((name, sizes)) or 1)
    monkeypatch.setattr(hc, "launch", lambda stem, fn, device, *args: entries.append((fn, len(args))))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *shape, device=None, **kw: empty(*shape, device="meta", **kw))
    before = _launch_counts()
    for call in calls:
        call()
    assert [b - a for a, b in zip(before, _launch_counts())] == [1, 1, 1]
    assert entries == [(("hopfield_stream_fwd_wide", 9, 4), 13), (("hopfield_stream_bwd_dx", 13, 4), 17),
                       (("hopfield_stream_bwd_dku", 12, 4), 16)]
    assert [name for name, _ in scratch] == ["hopfield_stream_fwd_workspace", "hopfield_stream_bwd_dx_workspace",
                                            "hopfield_stream_bwd_dku_workspace"]
    assert {sizes for _, sizes in scratch} == {(5, 70, 300, 32)}


@pytest.mark.parametrize("d_in,d_out,wide", [
    (1, 1, False), (3, 64, False), (5, 128, False), (128, 5, False), (33, 7, False), (128, 128, False),
    (129, 64, False), (64, 129, False), (200, 200, False), (256, 3, False), (256, 256, False),
    (257, 64, True), (64, 257, True), (300, 300, True),
])
def test_the_card_takes_every_width_up_to_128(d_in, d_out, wide):
    """The dispatch rule, on meta tensors: ``kernel_takes`` holds for every
    width of at least 1; up to ``BUILT_WIDTH`` (256) on both sides the
    route is a built instance, past it the wide variants. K1, K2 and K3
    reach the device check either way (a meta tensor has no kernel), and
    nothing is launched."""
    assert hc.kernel_takes(d_in, d_out)
    assert hc.kernel_route(d_in, d_out) == ("wide" if wide else "instance")
    fwd, rest = _meta_arrays(5, 70, d_in, d_out)
    before = _launch_counts()
    for call in (lambda: hc.stream_lookup_fwd(*fwd), lambda: hc.stream_bwd_dx(*fwd, *rest),
                 lambda: hc.stream_bwd_dku(*fwd, *rest)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    assert _launch_counts() == before


def test_cuda_impl_on_cpu_tensors_raises():
    layer = HopfieldLookup(64, 3, 50, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hc.hopfield_lookup_stream(layer, torch.zeros(2, 4, 64), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        hc.hopfield_lookup_stream(layer, torch.zeros(2, 4, 64), impl="pallas")


def _layers(params, d=64, di=3):
    return {
        "hopfield": _torch_layer(params["hopfield"], d, d),
        "embedding_to_index": _torch_layer(params["embedding_to_index"], d, di),
        "index_to_embedding": _torch_layer(params["index_to_embedding"], di, d),
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


# ------------------------------------------------------------ K4


def _bottleneck_params(rng, m, d=64, di=3):
    return {
        "hopfield": _np_params(rng, d, d, m),
        "embedding_to_index": _np_params(rng, d, di, m),
        "index_to_embedding": _np_params(rng, di, d, m),
    }


# the index width di of the fused cases, by their token width d
FUSED_INDEX_DIM = {64: 3, 32: 4, 256: 3}


@pytest.mark.parametrize("m,shape", [(256, (2, 40, 64)), (300, (37, 64)), (256, (2, 40, 32)), (300, (37, 256))])
def test_fused_reference_matches_pallas_singleshot(m, shape):
    """K4's plain version against the TPU's single-shot fused kernel
    ``_bottleneck_fwd_pallas`` in interpret mode, as
    tests/test_pallas.py::test_singleshot_kernel_matches_reference runs it:
    at its shapes (M 256, x (2, 40, 64)), at ragged N and M (37 tokens,
    M 300), and at the bottleneck widths (d, di) = (32, 4) and (256, 3),
    which K4 takes zero-padded. ``e`` and ``r`` within rtol 1e-4, atol
    1e-5; ``zq`` equal."""
    d = shape[-1]
    di = FUSED_INDEX_DIM[d]
    rng = np.random.default_rng(m + shape[0])
    params = _bottleneck_params(rng, m, d, di)
    x = rng.standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in hp._bottleneck_fwd_pallas(_jax(params), jnp.asarray(x), 512)]
    with torch.no_grad():
        got = hc.bottleneck_fused_fwd_reference(*_layers(params, d, di).values(), torch.from_numpy(x), 512)
    for name, a, w in zip(("e", "zq", "r"), got, want):
        assert a.shape == w.shape, name
        if name == "zq":
            np.testing.assert_array_equal(a.numpy(), w)
        else:
            np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_fused_reference_matches_the_streaming_bottleneck():
    """K4's plain version and the port's streaming bottleneck on its plain
    path compute the same ``(e, zq, r)``, bit for bit: the same lookups and
    shifts, and the straight-through round's forward value is the round."""
    rng = np.random.default_rng(11)
    params = _bottleneck_params(rng, 600)
    x = torch.from_numpy(rng.standard_normal((3, 41, 64)).astype(np.float32))
    layers = _layers(params)
    with torch.no_grad():
        got = hc.bottleneck_fused_fwd_reference(*layers.values(), x, 512)
        want = streaming_bottleneck(layers, x, 512, impl="torch")
    for name, a, w in zip(("e", "zq", "r"), got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0, msg=name)


def test_fused_wrapper_routes_and_checks():
    """K4's wrapper takes the plain version on CPU tensors (no launch),
    raises "no kernel" on a meta tensor and "forward-only" with autograd
    on, and checks the lookups' widths, x and the level count: lookups that
    chain as (d, d), (d, di), (di, d) reach the device check at any d, di
    (past 256 too, where the wide walk runs the stages), and a chain that
    breaks raises ``ValueError``."""
    rng = np.random.default_rng(12)
    layers = list(_layers(_bottleneck_params(rng, 70)).values())
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    hc.bottleneck_fused_fwd.launches = 0
    with torch.no_grad():
        got = hc.bottleneck_fused_fwd(*layers, x, 512)
        want = hc.bottleneck_fused_fwd_reference(*layers, x, 512)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    meta = [HopfieldLookup(d_in, d_out, 70, device="meta") for d_in, d_out in hc.SUPPORTED]
    xm = torch.zeros(5, 64, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        hc.bottleneck_fused_fwd(*meta, xm, 512)
    with pytest.raises(RuntimeError, match="forward-only"):
        hc.bottleneck_fused_fwd(*meta, xm, 512)
    with pytest.raises(ValueError, match="d_in, d_out"):
        hc.bottleneck_fused_fwd(meta[0], meta[0], meta[2], xm, 512)
    for d, di in ((32, 4), (256, 3), (3, 256), (200, 130)):
        chained = [HopfieldLookup(a, b, 70, device="meta") for a, b in ((d, d), (d, di), (di, d))]
        with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
            hc.bottleneck_fused_fwd(*chained, torch.zeros(5, d, device="meta"), 512)
    for widths in (((32, 32), (32, 4), (5, 32)), ((32, 32), (32, 4), (4, 64)), ((32, 64), (64, 4), (4, 32))):
        broken = [HopfieldLookup(a, b, 70, device="meta") for a, b in widths]
        with pytest.raises(ValueError, match="must chain"):
            hc.bottleneck_fused_fwd(*broken, torch.zeros(5, widths[0][0], device="meta"), 512)
    for d, di in ((300, 3), (64, 257), (384, 3), (64, 300)):
        wide = [HopfieldLookup(a, b, 70, device="meta") for a, b in ((d, d), (d, di), (di, d))]
        with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
            hc.bottleneck_fused_fwd(*wide, torch.zeros(5, d, device="meta"), 512)
    with pytest.raises(ValueError, match=r"\(\.\.\., 64\)"):
        hc.bottleneck_fused_fwd(*meta, torch.zeros(5, 32, device="meta"), 512)
    with pytest.raises(ValueError, match="float32"):
        hc.bottleneck_fused_fwd(*layers, x.double(), 512)
    with pytest.raises(ValueError, match="num_levels"):
        hc.bottleneck_fused_fwd(*layers, x, 1)
    assert hc.bottleneck_fused_fwd.launches == 0
