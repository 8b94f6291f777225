"""The port's PixelCNN prior against the JAX package's, on the CPU (f32).

Tiny priors (``pixelcnn_mnist_28`` at r 4 and 5, 24 features, 2 residual
blocks, as ``tests/test_pixelcnn*.py`` size them) with JAX's own
initialization carried over the bridge, and the trained anchor
``PixelCNN-MNIST-28.msgpack`` (r 8, 96 features, 4 blocks):

- the masks and ``forward`` against JAX's, and causality;
- the sampler's teacher-forced step (``step_logits``) against ``forward``;
- the draws: JAX's key chain of Gumbel noise computed exactly (``key, sub
  = split(key)`` for each channel of each pixel, ``gumbel(sub, (n, L))``,
  the draw of ``jax.random.categorical``) into the port's
  ``sample(_gumbel=...)``, which must give ``PixelCNNPrior.sample(params,
  key, n)``'s grid draw for draw. The same noise through
  :func:`jax_colchain_draws`, a copy of JAX's ``_sample_scan_colchain``
  with ``argmax(logits + noise)`` as its draw, must give that grid too:
  it is the copy that recomputes the card's goldens
  (``tests/test_torch_pixelcnn_goldens.py``);
- ``sample``'s own noise from a ``torch.Generator``;
- three prior-phase steps through the port's ``Trainer`` against JAX's
  ``_step_core(True)``;
- ``interpolate`` under the anchor against JAX's, the engine's ``sample``
  and ``interpolate``, the serving CLI, and ``evaluate``'s PNG grids.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.models.priors.pixelcnn import PixelCNNPrior as JaxPixelCNNPrior
from hopvae_tpu.models.priors.pixelcnn import _group_mask as jax_group_mask
from hopvae_tpu.parallel import mesh as mesh_lib
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.train import make_optimizer as jax_make_optimizer
from hopvae_torch import HopVAE, load_config
from hopvae_torch import train as ttrain
from hopvae_torch.data import ArrayDataset, golden_input
from hopvae_torch.models.priors.pixelcnn import PixelCNNPrior, _group_mask
from hopvae_torch.serving import InferenceEngine, main, state_from_checkpoint
from hopvae_torch.utils.checkpoint import params_from_jax

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
ANCHOR = CKPTS / "PixelCNN-MNIST-28.msgpack"
TINY = {"prior_num_filters": 24, "prior_num_res_blocks": 2}
SMALL = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 64, "batch_size": 8}


def _tiny_pair(r: int = 5, seed: int = 0, **over):
    """(JAX prior, its parameters from JAX's init, the port's prior on them)."""
    jcfg, tcfg = jax_load_config("pixelcnn_mnist_28"), load_config("pixelcnn_mnist_28")
    for k, v in {"representation_dim": r, **TINY, **over}.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jprior = JaxPixelCNNPrior(jcfg)
    params = jax.device_get(jprior.init(jax.random.PRNGKey(seed)))
    prior = PixelCNNPrior(tcfg)
    prior.load_state_dict({k.removeprefix("prior."): v for k, v in params_from_jax({"prior": params}).items()})
    return jprior, jax.tree_util.tree_map(jnp.asarray, params), prior


@pytest.fixture(scope="module")
def anchor():
    """The anchor's prior: JAX's from the checkpoint read by flax, the
    port's from the port's reader."""
    jcfg = jax_load_config("pixelcnn_mnist_28")
    jprior = JaxPixelCNNPrior(jcfg)
    params = serialization.msgpack_restore(ANCHOR.read_bytes())["prior"]
    params = {**params, "res": [params["res"][str(i)] for i in range(len(params["res"]))]}
    prior = PixelCNNPrior(load_config("pixelcnn_mnist_28"))
    state = state_from_checkpoint(str(ANCHOR))
    prior.load_state_dict({k.removeprefix("prior."): v for k, v in state.items() if k.startswith("prior.")})
    return jprior, jax.tree_util.tree_map(jnp.asarray, params), prior


def _pair_of(name, anchor):
    return anchor if name == "anchor" else _tiny_pair(**{"tiny r5": {}, "tiny r4": {"r": 4}}[name])


def _grid(prior, b=3, seed=3):
    r, c = prior.representation_dim, prior.index_dim
    return np.random.default_rng(seed).integers(0, prior.num_levels, (b, r, r, c)).astype(np.float32)


def jax_keychain_noise(key, r: int, c: int, n: int, levels: int) -> np.ndarray:
    """The Gumbel noise ``(r², C, n, L)`` of JAX's sampler for ``key``: for
    each pixel and each channel ``key, sub = split(key)``, then
    ``gumbel(sub, (n, L))``, which ``jax.random.categorical(sub, logits)``
    adds to the logits before its argmax."""

    def body(key, _):
        draws = []
        for _ch in range(c):
            key, sub = jax.random.split(key)
            draws.append(jax.random.gumbel(sub, (n, levels), jnp.float32))
        return key, jnp.stack(draws)

    _, noise = jax.jit(lambda k: jax.lax.scan(body, k, None, length=r * r))(key)
    return np.asarray(noise)


def jax_colchain_draws(p, params, noise) -> tuple[np.ndarray, np.ndarray]:
    """A copy of JAX's ``_sample_scan_colchain`` whose draw is ``argmax(logits
    + noise[pixel, channel])``: the grid ``(n, r, r, C)``, and the smallest
    top-two margin of ``logits + noise`` along each of the n rows."""
    r, c, f = p.representation_dim, p.index_dim, p.features
    lvl_scale = p.num_levels - 1
    n = noise.shape[2]
    relu = jax.nn.relu

    def run(params, noise):
        cm, taps = p._center_mats(params), p._col_taps(params)
        grid_pad0 = jnp.zeros((n, r + 3, r + 6, c), jnp.float32)
        hb0 = tuple(jnp.zeros((n, 2, r + 2, f), jnp.float32) for _ in range(p.n_res))
        row_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 4, 7, 1), 1)
        col_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 4, 7, 1), 2)

        def body(carry, xs):
            grid_pad, hbufs = carry
            step, g = xs
            i, j = step // r, step % r
            pp = i & 1
            win = jax.lax.dynamic_slice(grid_pad, (0, i, j, 0), (n, 4, 7, c))
            valid = (row_iota >= 3 - i) & (col_iota >= 3 - j) & (col_iota < r + 3 - j)
            xw = jnp.where(valid, win / lvl_scale * 2.0 - 1.0, 0.0)
            partials = [xw.reshape(n, -1) @ taps["in"] + taps["in_b"]]
            for b in range(p.n_res):
                above = relu(jax.lax.dynamic_slice(hbufs[b], (0, 1 - pp, j, 0), (n, 1, 3, f))[:, 0])
                left = relu(jax.lax.dynamic_slice(hbufs[b], (0, pp, j, 0), (n, 1, 1, f))[:, 0, 0])
                partials.append(above.reshape(n, -1) @ taps["res"][b]["above"] + left @ taps["res"][b]["left"]
                                + taps["res"][b]["bias"])
            x_ij = jax.lax.dynamic_slice(grid_pad, (0, i + 3, j + 3, 0), (n, 1, 1, c)).reshape(n, c)
            x_ij = x_ij / lvl_scale * 2.0 - 1.0
            lvls, margins = [], []
            for ch in range(c):
                y = p._center_chain(params, cm, partials, x_ij)[:, ch] + g[ch]
                lvl = jnp.argmax(y, axis=-1).astype(jnp.float32)
                top2 = jax.lax.top_k(y, 2)[0]
                margins.append(top2[:, 0] - top2[:, 1])
                lvls.append(lvl)
                x_ij = x_ij.at[:, ch].set(lvl / lvl_scale * 2.0 - 1.0)
            grid_pad = jax.lax.dynamic_update_slice(
                grid_pad, jnp.stack(lvls, -1).reshape(n, 1, 1, c), (0, i + 3, j + 3, 0))
            _, hs = p._center_chain_h(params, cm, partials, x_ij)
            hbufs = tuple(jax.lax.dynamic_update_slice(hb, h[:, None, None], (0, pp, j + 1, 0))
                          for hb, h in zip(hbufs, hs[: p.n_res]))
            return (grid_pad, hbufs), jnp.stack(margins)

        (grid_pad, _), margins = jax.lax.scan(body, (grid_pad0, hb0), (jnp.arange(r * r), noise))
        return grid_pad[:, 3:, 3 : r + 3], margins

    grid, margins = jax.jit(run)(params, jnp.asarray(noise))
    return np.asarray(grid), np.asarray(margins).min(axis=(0, 1))


@pytest.mark.parametrize("name", ["tiny r5", "tiny r4", "anchor"])
def test_masks_and_forward_match_jax(name, anchor):
    """Each conv's mask buffer is JAX's ``_group_mask`` (OIHW) and stays out
    of the parameters and the state_dict; ``forward`` within rtol 1e-5 and
    an atol of 1e-5 of the largest logit of JAX's, on random levels: f32
    sums in another order, whose error scales with the logits (measured:
    6e-8 on the tiny priors' logits of order 0.4, 6.3e-4 on the anchor's of
    order 200, 3e-6 of the largest)."""
    jprior, params, prior = _pair_of(name, anchor)
    c, f = prior.index_dim, prior.features
    for shape, kind, conv in [((7, 7, c, f), "A", prior.conv_in), ((1, 1, f, c * prior.num_levels), "B", prior.conv_out2),
                              ((3, 3, f, f), "B", prior.res[0].conv_a)]:
        want = jax_group_mask(*shape, c, mask_type=kind)
        np.testing.assert_array_equal(_group_mask(*shape, c, mask_type=kind), want)
        np.testing.assert_array_equal(conv.mask.numpy(), want.transpose(3, 2, 0, 1))
    assert not any("mask" in k for k in prior.state_dict())
    assert len(list(prior.parameters())) == 2 * (2 + 2 * prior.n_res + 1)
    g = _grid(prior)
    want = np.asarray(jax.jit(jprior.forward)(params, jnp.asarray(g)))
    with torch.no_grad():
        got = prior(torch.from_numpy(g)).numpy()
    assert got.shape == (3, prior.representation_dim, prior.representation_dim, c, prior.num_levels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(prior.reconstruct(torch.from_numpy(g)).numpy(),
                                  np.asarray(jprior.reconstruct(params, jnp.asarray(g))))


def test_causality():
    """``tests/test_pixelcnn.py::test_causality`` on the port: the logit at
    flat position t does not depend on the inputs at positions ≥ t (raster
    over pixels, channel order within a pixel), and the next one does."""
    _, _, prior = _tiny_pair(r=4, prior_num_filters=96, prior_num_res_blocks=4)
    r, c, lvl = 4, prior.index_dim, prior.num_levels
    base = np.random.default_rng(0).integers(0, lvl, (1, r, r, c)).astype(np.float32)
    with torch.no_grad():
        logits0 = prior(torch.from_numpy(base)).numpy()
    n_pos = r * r * c
    for t in [0, 1, c, n_pos // 2, n_pos - 1]:
        i, j, ch = t // (r * c), (t // c) % r, t % c
        perturbed = base.copy().reshape(-1)
        perturbed[t:] = (perturbed[t:] + 17) % lvl
        with torch.no_grad():
            logits1 = prior(torch.from_numpy(perturbed.reshape(base.shape))).numpy()
        np.testing.assert_allclose(logits1[0, i, j, ch], logits0[0, i, j, ch], rtol=1e-5, atol=1e-5,
                                   err_msg=f"position {t} ({i},{j},{ch}) leaked future inputs")
        if t + 1 < n_pos:
            i3, j3, c3 = (t + 1) // (r * c), ((t + 1) // c) % r, (t + 1) % c
            assert not np.allclose(logits1[0, i3, j3, c3], logits0[0, i3, j3, c3])


@pytest.mark.parametrize("name", ["tiny r5", "tiny r4", "anchor"])
def test_step_logits_match_forward(name, anchor):
    """The sampler's own step, teacher-forced on a grid, gives ``forward``'s
    logits at every pixel and channel (JAX's ``test_center_chain_equals_
    forward_logits`` gate, rtol 1e-4, atol 1e-5, the atol taken relative
    to the largest logit as in ``test_masks_and_forward_match_jax``), and
    ``eager`` is the same path on the CPU."""
    _, _, prior = _pair_of(name, anchor)
    g = torch.from_numpy(_grid(prior, b=2))
    with torch.no_grad():
        want = prior(g).numpy()
    got = prior.step_logits(g).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(prior.step_logits(g, eager=True).numpy(), got)


@pytest.mark.parametrize("name,n,seed", [("tiny r5", 3, 7), ("tiny r4", 2, 11), ("anchor", 2, 5)])
def test_draws_match_jax_sampler(name, n, seed, anchor):
    """JAX's production sampler, ``PixelCNNPrior.sample(params, key, n)``,
    against the port's ``sample(_gumbel=...)`` on JAX's key chain of noise
    and against the test-side copy of the sampler on the same noise: draw
    for draw, over many levels."""
    jprior, params, prior = _pair_of(name, anchor)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jprior.sample(params, key, n))
    r, c = prior.representation_dim, prior.index_dim
    noise = jax_keychain_noise(key, r, c, n, prior.num_levels)
    got = prior.sample(n, _gumbel=noise)
    assert got.dtype == torch.float32 and got.shape == (n, r, r, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(jax_colchain_draws(jprior, params, noise)[0], want)
    assert len(np.unique(want)) > 10


def test_sample_draws_from_a_generator():
    """``sample``'s own noise: the same seed draws the same grid, another
    seed another; integer levels in [0, L-1]; ``_gumbel`` of another shape
    and a device that is not the prior's raise."""
    _, _, prior = _tiny_pair()
    a = prior.sample(3, generator=torch.Generator().manual_seed(1))
    b = prior.sample(3, generator=torch.Generator().manual_seed(1))
    c = prior.sample(3, generator=torch.Generator().manual_seed(2))
    assert a.shape == (3, 5, 5, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= prior.num_levels - 1 and torch.equal(a, a.round())
    with pytest.raises(ValueError, match="_gumbel must be"):
        prior.sample(3, _gumbel=np.zeros((25, 3, 2, prior.num_levels), np.float32))
    with pytest.raises(ValueError, match="parameters are on cpu"):
        prior.sample(1, device="meta")


def test_prior_phase_steps_match_jax():
    """Three prior-only steps of a narrow MNIST backbone with a tiny
    PixelCNN prior through the port's ``Trainer``, the learning rate
    decaying every step, against JAX's ``_step_core(True)``: the loss and
    its parts within 1e-3 relative (measured: under 1e-6), the prior's
    parameters within 10% of one step of lr, the masked-out weights
    untouched, and the backbone bit-identical in both packages."""
    jcfg, tcfg = jax_load_config("mnist_28"), load_config("mnist_28")
    for k, v in {**SMALL, **TINY, "prior": "PixelCNN"}.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    params = jax.jit(JaxHopVAE(jcfg).init)(jax.random.PRNGKey(0))
    digits = golden_input("mnist_digits")
    batches = [digits[8 * i : 8 * i + 8] for i in range(3)]
    tr = JaxTrainer(JaxHopVAE(jcfg), jcfg, mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    tr._tx = {True: jax_make_optimizer(jcfg, 1, prior_only=True, params=params)}
    step = jax.jit(tr._step_core(True))
    jparams, opt_state, jmetrics = params, tr._tx[True].init(params), []
    for x in batches:
        jparams, opt_state, m = step(jparams, opt_state, jnp.asarray(x))
        jmetrics.append(jax.device_get(m))

    start = params_from_jax(params)
    model = HopVAE(tcfg, impl="torch", device="cpu")
    model.load_state_dict(start)
    trainer = ttrain.Trainer(model, tcfg)
    trainer.build_optimizer(1, fit_prior=True)
    metrics = [trainer.train_step(torch.from_numpy(x)) for x in batches]
    for ours, theirs in zip(metrics, jmetrics):
        for k in ("loss", "recon_error", "aux"):
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-3, err_msg=k)
    want, lr = params_from_jax(jparams), tcfg.learning_rate
    for name, p in model.state_dict().items():
        if name.startswith("prior."):
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=0.1 * lr, err_msg=name)
        else:
            torch.testing.assert_close(p, start[name], rtol=0, atol=0, msg=name)
            torch.testing.assert_close(want[name], start[name], rtol=0, atol=0, msg=name)
    hidden = model.prior.conv_in.mask == 0
    torch.testing.assert_close(model.prior.conv_in.weight[hidden], start["prior.conv_in.weight"][hidden], rtol=0, atol=0)


def test_interpolate_matches_jax_under_the_anchor():
    """``interpolate`` with the anchor's PixelCNN prior (its teacher-forced
    argmax on the interpolation grid): the grid equal bin for bin, the
    images within the backbone tests' tolerance (rtol 1e-3, atol 1e-4)."""
    jcfg = jax_load_config("pixelcnn_mnist_28")
    jm = JaxHopVAE(jcfg)
    raw = serialization.msgpack_restore(ANCHOR.read_bytes())
    params = serialization.from_state_dict(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))), raw)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tm = HopVAE(load_config("pixelcnn_mnist_28"), impl="torch", device="cpu")
    tm.load_state_dict(state_from_checkpoint(str(ANCHOR)))
    x = golden_input("mnist_digits")
    xa, xb = x[:8], x[8:16]
    want = np.asarray(jax.jit(jm.interpolate)(params, jnp.asarray(xa), jnp.asarray(xb)))
    with torch.no_grad():
        got = tm.interpolate(torch.from_numpy(xa), torch.from_numpy(xb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_engine_and_cli_serve_the_anchor(tmp_path, capsys):
    """``InferenceEngine`` under ``pixelcnn_mnist_28`` with the anchor, all
    four ops by default: ``sample`` equals ``HopVAE.sample`` with a
    generator of that seed, ``interpolate`` the model's on the unpadded
    pair; the CLI's ``--mode sample`` and ``--mode interpolate`` write
    their PNG grids."""
    cfg = load_config("pixelcnn_mnist_28")
    eng = InferenceEngine(cfg, state_from_checkpoint(str(ANCHOR)), max_batch=3, impl="torch", compute_dtype=None,
                          device="cpu", n_sample=4)
    got = eng.sample(9)
    with torch.no_grad():
        want = eng.model.sample(4, generator=torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_array_equal(got, want)
    x = golden_input("mnist_digits")
    with torch.no_grad():
        pair = eng.model.interpolate(torch.from_numpy(x[:2]), torch.from_numpy(x[2:4])).numpy()
    np.testing.assert_allclose(eng.interpolate(x[:2], x[2:4]), pair, rtol=1e-5, atol=1e-5)
    paths = []
    for i, a in enumerate(x[:4]):
        np.save(tmp_path / f"x{i}.npy", a)
        paths.append(str(tmp_path / f"x{i}.npy"))
    common = ["--config", "pixelcnn_mnist_28", "--checkpoint", str(ANCHOR), "--impl", "torch", "--compute-dtype",
              "float32", "--device", "cpu"]
    main([*common, "--mode", "sample", "--n-sample", "3", "--out", str(tmp_path / "s")])
    main([*common, "--mode", "interpolate", "--out", str(tmp_path / "i"), *paths])
    samples, pairs = np.load(tmp_path / "s" / "samples.npy"), np.load(tmp_path / "i" / "interpolations.npy")
    assert samples.shape == (3, 28, 28, 1) and pairs.shape == (2, 28, 28, 1)
    assert np.asarray(Image.open(tmp_path / "s" / "samples.png")).shape == (28, 84)
    np.testing.assert_allclose(pairs, pair, rtol=1e-5, atol=1e-5)
    assert "interpolations.png" in capsys.readouterr().out


def test_evaluate_writes_the_grids(tmp_path, capsys):
    """``evaluate`` with an ``out_dir`` writes JAX's set of grids, at most 16
    images each, 8 a row: samples, the last batch's inputs and
    reconstructions, the interpolation of the first two batches and the two
    batches; ``fit`` writes them at its eval epochs, and so does the CLI's
    ``--eval-only``."""
    cfg = load_config("mnist_28")
    for k, v in {**SMALL, **TINY, "prior": "PixelCNN", "batch_size": 6}.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    trainer = ttrain.Trainer(HopVAE(cfg, impl="torch", device="cpu"), cfg)
    ds = ArrayDataset(golden_input("mnist_digits")[:16], np.zeros(16, np.int64))
    err = trainer.evaluate(ds, epoch=3, out_dir=str(tmp_path))
    assert err == pytest.approx(trainer.evaluate(ds))
    rows = {"samples": 2, "inputs": 1, "reconstructions": 1, "interpolations": 1, "test_Y": 1, "test_Z": 1}
    cols = {"samples": 8, "inputs": 4, "reconstructions": 4, "interpolations": 6, "test_Y": 6, "test_Z": 6}
    for name in rows:
        png = np.asarray(Image.open(tmp_path / f"epoch0003_{name}.png"))
        assert png.shape == (28 * rows[name], 28 * cols[name]) and png.dtype == np.uint8, name
    trainer.fit(ds, ds, epochs=1, out_dir=str(tmp_path / "fit"), save_every=0)
    assert sorted(p.name for p in (tmp_path / "fit").glob("*.png")) == sorted(f"epoch0000_{k}.png" for k in rows)
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--eval-only", "--set",
                 "prior=PixelCNN", "--set", "prior_num_filters=12", "--set", "prior_num_res_blocks=1",
                 "--set", "batch_size=256", "--out", str(tmp_path / "cli")])
    assert "Test Reconstruction Error" in capsys.readouterr().out
    assert len(list((tmp_path / "cli").glob("epoch0000_*.png"))) == 6
