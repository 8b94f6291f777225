"""``PIXELCNN_GOLDENS`` and ``PIXELCNN_TRAIN_GOLDEN``, which ``chip_smoke.py``
holds the card to, recomputed with the JAX package on the CPU (f32,
``impl="xla"``), and the port on the CPU against them: the anchor
``PixelCNN-MNIST-28.msgpack`` on the 64 golden digits, and the noise of
``pixelcnn_noise()`` through the copy of JAX's sampler in
``tests/test_torch_pixelcnn.py`` (held there to JAX's own ``sample``)."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.models.hopvae import bottleneck_params
from hopvae_tpu.ops.bottleneck import hopfield_bottleneck
from hopvae_tpu.parallel import mesh as mesh_lib
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.train import make_optimizer as jax_make_optimizer
from hopvae_tpu.utils.checkpoint import load_reference_checkpoint
from hopvae_torch import HopVAE, load_config
from hopvae_torch import train as ttrain
from hopvae_torch.data import (PIXELCNN_GOLDENS, PIXELCNN_TRAIN_GOLDEN, golden_input, gumbel_noise, pixelcnn_grid,
                               pixelcnn_noise, pixelcnn_sample_grid)
from hopvae_torch.serving import state_from_checkpoint
from test_torch_pixelcnn import jax_colchain_draws

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
LOG2E = float(np.log2(np.e))


@pytest.fixture(scope="module")
def anchor():
    """JAX's model and parameters from the anchor, and the port's."""
    spec = PIXELCNN_GOLDENS
    jm = JaxHopVAE(jax_load_config(spec["config"]))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    load_reference_checkpoint(jm, params, str(CKPTS / spec["checkpoint"])))
    tm = HopVAE(load_config(spec["config"]), impl="torch", device="cpu")
    tm.load_state_dict(state_from_checkpoint(str(CKPTS / spec["checkpoint"])))
    return jm, params, tm


def _bits(logits, grid) -> float:
    logp = torch.log_softmax(torch.from_numpy(np.array(logits, np.float32)), -1)
    return float(-torch.gather(logp, -1, torch.from_numpy(np.array(grid)).long()[..., None]).mean()) * LOG2E


def test_bits_and_loss_match_jax(anchor):
    """JAX's quantized grid of the digits equals the committed one, and its
    prior bits on it and ``forward(fit_prior=True)``'s loss equal the golden
    within 1e-6; the port on the CPU: its grid equal, its bits within 1e-5
    (measured: 1e-7) and its loss within 1e-5 relative."""
    jm, params, tm = anchor
    spec = PIXELCNN_GOLDENS
    x = golden_input(spec["input"])
    _, zq, _ = hopfield_bottleneck(bottleneck_params(params), jm._encode_to_tokens(params, jnp.asarray(x)),
                                   jm.num_levels, impl="xla")
    grid = np.asarray(zq).reshape(pixelcnn_grid().shape)
    np.testing.assert_array_equal(grid, pixelcnn_grid())
    logits = jax.jit(jm.prior.forward)(params["prior"], jnp.asarray(grid))
    assert abs(_bits(logits, grid) / spec["bits"] - 1) < 1e-6
    _, loss = jax.jit(lambda p, x: jm.forward(p, x, fit_prior=True))(params, jnp.asarray(x))
    assert abs(float(loss) / spec["loss"] - 1) < 1e-6
    g = torch.from_numpy(pixelcnn_grid())
    with torch.no_grad():
        _, tzq, _ = tm.backbone(torch.from_numpy(x))
        _, tloss = tm(torch.from_numpy(x), fit_prior=True)
        bits = float(tm.prior_bits(g.reshape(len(g), -1, g.shape[-1])))
    np.testing.assert_array_equal(tzq.reshape(g.shape).numpy(), grid)
    assert abs(bits - spec["bits"]) < 1e-5
    assert abs(float(tloss) / spec["loss"] - 1) < 1e-5


def test_draws_golden_matches_jax(anchor):
    """The noise recipe; JAX's draws with it equal the committed grid, and
    its smallest margins ``min_margin`` (each above the card's near-tie
    floor); the port's draws on the CPU equal the grid draw for draw."""
    jm, params, tm = anchor
    spec = PIXELCNN_GOLDENS
    noise = pixelcnn_noise()
    assert noise.shape == (64, 3, 4, 512) and noise.dtype == np.float32 and np.isfinite(noise).all()
    np.testing.assert_array_equal(noise.reshape(spec["noise"]["shape"]),
                                  gumbel_noise(spec["noise"]["shape"], spec["noise"]["seed"]))
    grid, margins = jax_colchain_draws(jm.prior, params["prior"], noise)
    np.testing.assert_array_equal(grid, pixelcnn_sample_grid())
    np.testing.assert_allclose(margins, spec["min_margin"], rtol=1e-3)
    assert margins.min() > spec["near_tie"]
    np.testing.assert_array_equal(tm.prior.sample(4, _gumbel=noise).numpy(), pixelcnn_sample_grid())


def test_train_golden_pins_the_jax_steps(anchor):
    """The JAX numbers of ``PIXELCNN_TRAIN_GOLDEN``: the prior's step-0
    gradient norm (``watch_gradients``) and the loss after each of three
    prior-only Adam steps at a constant lr of 1e-3."""
    jm, params, _ = anchor
    gold = PIXELCNN_TRAIN_GOLDEN
    jcfg = jax_load_config(gold["config"])
    jcfg.gamma, jcfg.learning_rate = 1.0, gold["learning_rate"]
    tr = JaxTrainer(JaxHopVAE(jcfg), jcfg, mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    tr.watch_gradients = True
    tr._tx = {True: jax_make_optimizer(jcfg, 1, prior_only=True, params=params)}
    step = jax.jit(tr._step_core(True))
    opt_state, x, losses = tr._tx[True].init(params), jnp.asarray(golden_input(gold["input"])), []
    for k in range(len(gold["losses"])):
        params, opt_state, m = step(params, opt_state, x)
        losses.append(float(m["loss"]))
        if k == 0:
            np.testing.assert_allclose(float(m["grad_norm/prior"]), gold["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(losses, gold["losses"], rtol=1e-5)


def test_port_holds_the_train_golden():
    """The port's CPU path against the pinned JAX numbers, with the
    tolerances ``chip_smoke.py`` applies on the card (the step-0 loss
    tighter than the later ones, ``PIXELCNN_TRAIN_GOLDEN`` says why), and
    the backbone left bit-identical."""
    gold = PIXELCNN_TRAIN_GOLDEN
    losses, norm, model = ttrain.prior_train_golden(str(CKPTS), device="cpu", impl="torch", gold=gold)
    assert abs(losses[0] / gold["losses"][0] - 1) < gold["loss0_rtol"]
    np.testing.assert_allclose(losses, gold["losses"], rtol=gold["losses_rtol"])
    np.testing.assert_allclose(norm, gold["grad_norm"], rtol=gold["grad_norm_rtol"])
    stored = state_from_checkpoint(str(CKPTS / gold["checkpoint"]))
    for name, p in model.state_dict().items():
        if not name.startswith("prior."):
            torch.testing.assert_close(p, stored[name], rtol=0, atol=0, msg=name)
