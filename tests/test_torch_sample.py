"""The port's ``interpolate`` and ``sample``, through model, engine and
CLI, against the JAX package on the CPU (``impl="xla"``, f32).

- ``HopVAE.interpolate`` on the trained MNIST backbone under the Normal
  prior (``mnist_28`` with ``PixelCNN-MNIST-28.msgpack``), and on
  ``pixelcnn_mnist_28 --set prior=Transformer`` with
  ``Transformer-MNIST-28.msgpack`` (the prior's teacher-forced argmax):
  the interpolation grids equal bin for bin (no pre-round level of these
  batches lies within 1e-3 of a level from a rounding edge), the images
  within the backbone tests' tolerance; a shape mismatch returns ``x``.
- ``HopVAE.decode_grid``, the part of ``sample`` after its prior, against
  JAX's ``_lookup(index_to_embedding)`` and ``_tokens_to_image`` on the
  same grid (JAX's threefry and torch's Philox draw different grids); the
  Normal prior's draws.
- ``SERVING_GOLDENS``, which ``chip_smoke.py`` holds the card to,
  recomputed with JAX.
- ``InferenceEngine.sample`` and ``interpolate``: padding, the
  unequal-batch error, the ops it warms up; the CLI's three modes writing
  PNG grids; the PNG writer against JAX's (PIL) pixel for pixel.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization
from PIL import Image

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE, _lookup
from hopvae_tpu.utils.metrics import save_image_grid as jax_save_image_grid
from hopvae_torch import HopVAE, load_config
from hopvae_torch.data import (GOLDENS, PRIOR_GOLDENS, SERVING_GOLDENS, golden_grid, golden_input, image_stats,
                               interp_grid)
from hopvae_torch.serving import OPS, InferenceEngine, main, state_from_checkpoint
from hopvae_torch.utils.metrics import save_image_grid
from test_torch_model import _pair

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
MNIST_CKPT = CKPTS / GOLDENS["mnist_digits"]["checkpoint"]


def _jax_grid(jm, params, x, y):
    """JAX's interpolation grid: the steps of ``HopVAE.interpolate`` up to
    the prior's reconstruct, and the pre-round levels."""
    z = (jm._encode_to_tokens(params, jnp.asarray(x)) + jm._encode_to_tokens(params, jnp.asarray(y))) / 2
    zi = _lookup(params["embedding_to_index"], _lookup(params["hopfield"], z, "xla"), "xla")
    levels = (1.0 - jax.nn.relu(1.0 - jax.nn.relu(zi))) * (jm.num_levels - 1)
    r = jm.representation_dim
    grid = jnp.round(levels).reshape(x.shape[0], r, r, jm.index_dim)
    return np.asarray(jm.prior.reconstruct(params["prior"], grid)), np.asarray(levels)


def _edge_distance(levels) -> float:
    return float(np.min(np.abs(levels - np.floor(levels) - 0.5)))


@pytest.fixture(scope="module")
def mnist_normal():
    """``mnist_28`` (prior="None") with the trained backbone, both packages."""
    jm, params, tm = _pair("mnist_28", GOLDENS["mnist_digits"]["checkpoint"])
    return jm, {**params, "prior": {}}, tm


def _transformer_pair(config_name, checkpoint):
    """The JAX model and parameters with the Transformer prior from the
    checkpoint read by flax, and the port's model from its reader."""
    jcfg, tcfg = jax_load_config(config_name), load_config(config_name)
    jcfg.prior = tcfg.prior = "Transformer"
    jm = JaxHopVAE(jcfg)
    raw = serialization.msgpack_restore((CKPTS / checkpoint).read_bytes())
    params = serialization.from_state_dict(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))), raw)
    tm = HopVAE(tcfg, impl="torch", device="cpu")
    tm.load_state_dict(state_from_checkpoint(str(CKPTS / checkpoint)))
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


@pytest.mark.parametrize("prior", ["None", "Transformer"])
def test_interpolate_matches_jax(prior, mnist_normal):
    """Eight digits with the next eight: the grid after the prior's
    reconstruct equal bin for bin (the pre-round levels lie at least 1e-3
    of a level from a rounding edge), the images within rtol 1e-3, atol
    1e-4 (tests/test_torch_model.py's backbone tolerance)."""
    jm, params, tm = mnist_normal if prior == "None" else _transformer_pair(
        "pixelcnn_mnist_28", "Transformer-MNIST-28.msgpack")
    x = golden_input("mnist_digits")
    xa, xb = x[:8], x[8:16]
    want = np.asarray(jax.jit(jm.interpolate)(params, jnp.asarray(xa), jnp.asarray(xb)))
    want_grid, levels = _jax_grid(jm, params, xa, xb)
    assert _edge_distance(levels) > 1e-3
    with torch.no_grad():
        grid = tm.interpolation_grid(torch.from_numpy(xa), torch.from_numpy(xb))
        got = tm.interpolate(torch.from_numpy(xa), torch.from_numpy(xb))
    np.testing.assert_array_equal(grid.numpy(), want_grid)
    assert got.shape == (8, 28, 28, 1) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_interpolate_shape_mismatch_returns_x(mnist_normal):
    """Batches of other shapes: ``x`` itself, in both packages."""
    jm, params, tm = mnist_normal
    x = golden_input("mnist_digits")
    xa, xb = x[:3], x[3:5]
    np.testing.assert_array_equal(np.asarray(jm.interpolate(params, jnp.asarray(xa), jnp.asarray(xb))), xa)
    xt = torch.from_numpy(xa)
    assert tm.interpolate(xt, torch.from_numpy(xb)) is xt


def test_decode_grid_matches_jax(mnist_normal):
    """The part of ``sample`` after its prior, on one seeded grid: the
    index→embedding lookup of ``int(grid) / (L-1)`` and the decoder, within
    rtol 1e-3, atol 1e-4 of JAX."""
    jm, params, tm = mnist_normal
    r, c = jm.representation_dim, jm.index_dim
    grid = np.random.default_rng(4).integers(0, jm.num_levels, (3, r, r, c)).astype(np.float32)
    tokens = jnp.asarray(grid).astype(jnp.int32).astype(jnp.float32).reshape(3, r * r, c) / (jm.num_levels - 1)
    want = np.asarray(jm._tokens_to_image(params, _lookup(params["index_to_embedding"], tokens, "xla")))
    with torch.no_grad():
        got = tm.decode_grid(torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_normal_sample_draws_levels(mnist_normal):
    """The Normal prior's grid: float32 integers in [0, L-1] of shape (n,
    r, r, C), the same for the same seed; ``HopVAE.sample`` decodes it."""
    _, _, tm = mnist_normal
    grid = tm.prior.sample(64, generator=torch.Generator().manual_seed(1))
    r = tm.representation_dim
    assert grid.dtype == torch.float32 and grid.shape == (64, r, r, 3)
    assert torch.equal(grid, grid.round()) and grid.min() >= 0 and grid.max() <= tm.num_levels - 1
    assert len(grid.unique()) > 100  # the draws spread over the levels
    assert torch.equal(grid, tm.prior.sample(64, generator=torch.Generator().manual_seed(1)))
    images = tm.sample(2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tm.decode_grid(tm.prior.sample(2, generator=torch.Generator().manual_seed(1)))
    assert images.shape == (2, 28, 28, 1) and torch.isfinite(images).all()
    torch.testing.assert_close(images, want, rtol=0, atol=0)


def test_serving_goldens_match_jax():
    """``SERVING_GOLDENS``, recomputed with the JAX package (f32,
    ``impl="xla"``) on ffhq_64_scaled with the Transformer prior: the
    interpolation grid and each image's stats within 1e-5 (float64 means
    of the same images), and the port on the CPU within 1e-5 of them, its
    grid bin for bin."""
    jm, params, tm = _transformer_pair(PRIOR_GOLDENS["config"], PRIOR_GOLDENS["checkpoint"])
    x = golden_input("ffhq64_synthetic4")
    y = x[::-1].copy()
    want_grid, levels = _jax_grid(jm, params, x, y)
    np.testing.assert_array_equal(want_grid, interp_grid())
    assert _edge_distance(levels) > 4e-5
    interp = np.asarray(jax.jit(jm.interpolate)(params, jnp.asarray(x), jnp.asarray(y)))
    g = golden_grid()
    r, c = jm.representation_dim, jm.index_dim
    tokens = jnp.asarray(g).astype(jnp.int32).astype(jnp.float32).reshape(len(g), r * r, c) / (jm.num_levels - 1)
    decoded = np.asarray(jm._tokens_to_image(params, _lookup(params["index_to_embedding"], tokens, "xla")))
    spec = SERVING_GOLDENS
    np.testing.assert_allclose(image_stats(interp), spec["interpolate"]["stats"], rtol=1e-5)
    np.testing.assert_allclose(image_stats(decoded), spec["decode"]["stats"], rtol=1e-5)
    with torch.no_grad():
        grid = tm.interpolation_grid(torch.from_numpy(x), torch.from_numpy(y))
        got = tm.interpolate(torch.from_numpy(x), torch.from_numpy(y))
        dec = tm.decode_grid(torch.from_numpy(g))
    np.testing.assert_array_equal(grid.numpy(), interp_grid())
    np.testing.assert_allclose(image_stats(got.numpy()), spec["interpolate"]["stats"], rtol=1e-5)
    np.testing.assert_allclose(image_stats(dec.numpy()), spec["decode"]["stats"], rtol=1e-5)


# ------------------------------------------------------------ engine and CLI


@pytest.fixture(scope="module")
def mnist_state():
    return state_from_checkpoint(str(MNIST_CKPT))


def _engine(state, max_batch=4, **kw):
    cfg = load_config("mnist_28")
    kw = {"impl": "torch", "compute_dtype": None, "device": "cpu", **kw}
    return InferenceEngine(cfg, state, max_batch=max_batch, **kw)


def test_engine_interpolates_with_padding(mnist_state):
    """Three pairs through an engine of four: the same images as the model
    on the unpadded batch; unequal batches raise; an engine warms up only
    its ops."""
    eng = _engine(mnist_state, ops=("interpolate",))
    x = golden_input("mnist_digits")
    got = eng.interpolate(x[:3], x[3:6])
    with torch.no_grad():
        want = eng.model.interpolate(torch.from_numpy(x[:3]), torch.from_numpy(x[3:6])).numpy()
    assert got.shape == (3, 28, 28, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="equal batch sizes"):
        eng.interpolate(x[:3], x[3:5])
    with pytest.raises(ValueError, match="max_batch"):
        eng.interpolate(x[:5], x[5:10])
    with pytest.raises(RuntimeError, match="reconstruct"):
        eng.reconstruct(x[:1])


def test_engine_samples_from_a_seed(mnist_state):
    """``n_sample`` images a call, the same for the same seed and others
    for another; under a PixelCNN config (the anchor's prior) the engine
    warms up and serves ``sample`` and ``interpolate`` too, and an engine
    serves all four ops by default, as JAX's does; an unknown op raises."""
    eng = _engine(mnist_state, n_sample=5, ops=("sample",))
    a, b, c = eng.sample(3), eng.sample(3), eng.sample(4)
    assert a.shape == (5, 28, 28, 1) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert OPS == ("reconstruct", "encode", "sample", "interpolate")
    eng = InferenceEngine(load_config("pixelcnn_mnist_28"), mnist_state, max_batch=2, impl="torch",
                          compute_dtype=None, device="cpu", n_sample=3)
    assert eng.ops == OPS
    x = golden_input("mnist_digits")
    drawn, between = eng.sample(5), eng.interpolate(x[:2], x[2:4])
    assert drawn.shape == (3, 28, 28, 1) and between.shape == (2, 28, 28, 1)
    assert np.isfinite(drawn).all() and np.isfinite(between).all()
    with pytest.raises(ValueError, match="unknown ops"):
        _engine(mnist_state, ops=("decode",))


def _npy_inputs(tmp_path, n):
    x = golden_input("mnist_digits")[:n]
    paths = []
    for i, a in enumerate(x):
        np.save(tmp_path / f"x{i}.npy", a)
        paths.append(str(tmp_path / f"x{i}.npy"))
    return x, paths


@pytest.mark.parametrize("mode", ["reconstruct", "sample", "interpolate"])
def test_cli_modes_write_png_grids(mode, tmp_path, capsys):
    """``--mode reconstruct|sample|interpolate`` on the CPU: each writes
    its PNG grid (read back with PIL: 8 images a row) and the images as
    ``.npy``; interpolate pairs the first half of the inputs with the second
    in chunks of ``--max-batch``, and refuses an odd count."""
    x, paths = _npy_inputs(tmp_path, 6)
    out = tmp_path / "served"
    common = ["--config", "mnist_28", "--checkpoint", str(MNIST_CKPT), "--out", str(out), "--impl", "torch",
              "--compute-dtype", "float32", "--device", "cpu", "--max-batch", "2"]
    if mode == "sample":
        main([*common, "--mode", "sample", "--n-sample", "10", "--seed", "3"])
        n = 10
    else:
        main([*common, "--mode", mode, *paths])
        n = 6 if mode == "reconstruct" else 3
    stem = {"reconstruct": "reconstructions", "sample": "samples", "interpolate": "interpolations"}[mode]
    y = np.load(out / f"{stem}.npy")
    png = np.asarray(Image.open(out / f"{stem}.png"))
    assert y.shape == (n, 28, 28, 1) and np.isfinite(y).all()
    assert png.shape == (28 * ((n + 7) // 8), 28 * min(n, 8)) and png.dtype == np.uint8
    assert f"{stem}.png" in capsys.readouterr().out
    if mode == "interpolate":
        eng = _engine(state_from_checkpoint(str(MNIST_CKPT)), max_batch=3, ops=("interpolate",))
        np.testing.assert_allclose(y, eng.interpolate(x[:3], x[3:]), rtol=1e-5, atol=1e-5)
        with pytest.raises(SystemExit):
            main([*common, "--mode", "interpolate", *paths[:5]])


@pytest.mark.parametrize("shape", [(11, 7, 5, 1), (3, 9, 6, 3), (16, 4, 4, 3)])
def test_png_grid_matches_jax_writer(shape, tmp_path):
    """The port's PNG writer (zlib and struct, no PIL) against the JAX
    package's ``save_image_grid`` (PIL) on the same images: read back with
    PIL, pixel for pixel, grayscale and RGB, a ragged last row."""
    images = np.random.default_rng(shape[0]).random(shape, dtype=np.float32)
    images[0, 0, 0] = 1.0  # the top of the range
    save_image_grid(str(tmp_path / "port.png"), images)
    jax_save_image_grid(str(tmp_path / "jax.png"), images)
    ours, theirs = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert ours.mode == theirs.mode and ours.size == theirs.size
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
