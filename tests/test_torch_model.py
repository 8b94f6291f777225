"""The port's HopVAE forward against the JAX package's (``impl="xla"``, f32).

Stage by stage and end to end: at a small width with fresh JAX
parameters carried over the bridge, and with the trained MNIST backbone.
Both packages are held to the goldens in ``hopvae_torch.data.GOLDENS``,
which ``chip_smoke.py`` checks on the card. Tolerances are those of
tests/test_checkpoint_parity.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.ops.hopfield import hopfield_lookup as jax_lookup
from hopvae_torch import HopVAE, load_config
from hopvae_torch.data import GOLDENS, golden_input
from hopvae_torch.ops.conv import conv2d, conv_transpose2d
from hopvae_torch.ops.hopfield import hopfield_lookup
from hopvae_torch.utils.checkpoint import load_msgpack, params_from_jax

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
SMALL = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 64}


def _jax_tree(node):
    """A flax state dict → the pytree the JAX model takes (lists of layers)."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_jax_tree(node[str(i)]) for i in range(len(node))]
        return {k: _jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node)


def _pair(config_name, checkpoint=None, overrides=None):
    """(JAX model, JAX params, port model) on the same weights: a fresh JAX
    init carried over the bridge, or a checkpoint read by flax on the JAX
    side and by the port's own reader on the other."""
    jcfg, tcfg = jax_load_config(config_name), load_config(config_name)
    for k, v in (overrides or {}).items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jm = JaxHopVAE(jcfg)
    if checkpoint is None:
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))  # eager init is ~3x slower
        state = params_from_jax(params)
    else:
        raw = serialization.msgpack_restore((CKPTS / checkpoint).read_bytes())
        raw.pop("prior")
        params = _jax_tree(raw)
        state = params_from_jax(load_msgpack(str(CKPTS / checkpoint)))
    tm = HopVAE(tcfg, impl="torch", device="cpu")
    tm.load_state_dict(state)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


@pytest.fixture(scope="module")
def mnist():
    spec = GOLDENS["mnist_digits"]
    return _pair(spec["config"], spec["checkpoint"])


def _stagewise(jm, params, tm, x):
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    with torch.no_grad():
        z = tm._encode_to_tokens(xt)
        zj = jm._encode_to_tokens(params, xj)
        np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-3, atol=1e-4)

        e = hopfield_lookup(tm.hopfield, z)
        ej = jax_lookup(params["hopfield"], zj)
        np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=1e-3, atol=1e-4)

        i = torch.sigmoid(hopfield_lookup(tm.embedding_to_index, e))
        ij = jax.nn.sigmoid(jax_lookup(params["embedding_to_index"], ej))
        np.testing.assert_allclose(i.numpy(), np.asarray(ij), rtol=1e-3, atol=1e-5)
        levels = tm.num_levels - 1
        assert np.mean(np.round(i.numpy() * levels) == np.round(np.asarray(ij) * levels)) > 0.999

        recon, aux = tm(xt)
    recon_j, aux_j = jax.jit(jm.forward)(params, xj)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-3, atol=1e-6)
    assert recon.shape == x.shape and recon.dtype == torch.float32


def test_small_width_fresh_init_matches_jax():
    jm, params, tm = _pair("mnist_28", overrides=SMALL)
    x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(np.float32)
    _stagewise(jm, params, tm, x)


def test_trained_mnist_backbone_matches_jax(mnist):
    _stagewise(*mnist, golden_input("mnist_digits")[:8])


def test_mnist_golden(mnist):
    spec = GOLDENS["mnist_digits"]
    jm, params, tm = mnist
    x = golden_input("mnist_digits")
    recon_j, aux_j = jax.jit(jm.forward)(params, jnp.asarray(x))
    assert abs(float(jnp.mean((recon_j - x) ** 2)) / spec["recon_mse"] - 1) < 1e-4
    assert abs(float(aux_j) / spec["aux"] - 1) < 1e-4
    with torch.no_grad():
        recon, aux = tm(torch.from_numpy(x))
    assert abs(float(((recon - torch.from_numpy(x)) ** 2).mean()) / spec["recon_mse"] - 1) < 1e-3
    assert abs(float(aux) / spec["aux"] - 1) < 1e-2


def test_bf16_conv_stacks_stay_close(mnist):
    """compute_dtype=bf16 runs both conv stacks in bf16 from the f32
    parameters and returns f32; held to the JAX package's own bound on its
    bf16 path (tests/test_resume_and_dtype.py) and to the golden."""
    _, _, tm = mnist
    bf = HopVAE(tm.config, impl="torch", compute_dtype=torch.bfloat16, device="cpu")
    bf.load_state_dict(tm.state_dict())
    x = torch.from_numpy(golden_input("mnist_digits"))
    with torch.no_grad():
        r32, _ = tm(x)
        r16, aux16 = bf(x)
        z16 = bf._encode_to_tokens(x)
    assert r16.dtype == z16.dtype == aux16.dtype == torch.float32
    assert float(((r16 - r32) ** 2).mean()) < 1e-3
    assert abs(float(((r16 - x) ** 2).mean()) / GOLDENS["mnist_digits"]["recon_mse"] - 1) < 1e-2


@pytest.mark.parametrize("op", [conv2d, conv_transpose2d])
def test_bf16_biased_conv_rounds_once(op):
    """A conv with bf16 operands and a bias sums and adds the bias in f32,
    then rounds to bf16 once; f32 inputs stay f32."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, w, b = f(2, 8, 9, 9).to(torch.bfloat16), f(8, 8, 4, 4) / 8, f(8)
    got = op(x, w, b, stride=2, padding=1)
    fn = torch.nn.functional.conv2d if op is conv2d else torch.nn.functional.conv_transpose2d
    exact = fn(x.double(), w.to(torch.bfloat16).double(), b.to(torch.bfloat16).double(), stride=2, padding=1)
    assert got.dtype == torch.bfloat16
    # f32 sums may differ from the double ones near a rounding tie
    assert (got == exact.to(torch.bfloat16)).float().mean() > 0.99
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), rtol=2 ** -8, atol=1e-6)
    assert op(x.float(), w, b, stride=2, padding=1).dtype == torch.float32


@pytest.mark.parametrize("op,dtype", [(conv2d, torch.float32), (conv_transpose2d, torch.float32),
                                      (conv2d, torch.bfloat16), (conv_transpose2d, torch.bfloat16)])
def test_conv_backward_equals_autograd(op, dtype):
    """Under autograd a conv runs inside the wrapper that keeps cuDNN
    deterministic in the backward too; its value and gradients are those
    of the same conv differentiated directly."""
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x0, w0, b0 = f(2, 8, 9, 9).to(dtype), f(8, 8, 4, 4) / 8, f(8)

    def run(fn):
        x, w, b = (a.clone().requires_grad_() for a in (x0, w0, b0))
        y = fn(x, w, b)
        g = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
        y.backward(torch.from_numpy(g).to(y.dtype))
        return y.detach(), x.grad, w.grad, b.grad

    torch_fn = torch.nn.functional.conv2d if op is conv2d else torch.nn.functional.conv_transpose2d
    if dtype == torch.float32:
        plain = lambda x, w, b: torch_fn(x, w, b, stride=2, padding=1)
    else:
        plain = lambda x, w, b: torch_fn(x.float(), w.to(x.dtype).float(), b.to(x.dtype).float(),
                                         stride=2, padding=1).to(x.dtype)
    want = run(plain)
    for a, b in zip(run(lambda x, w, b: op(x, w, b, stride=2, padding=1)), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():  # no gradient wanted: called directly, same numbers
        torch.testing.assert_close(op(x0, w0, b0, stride=2, padding=1), want[0], rtol=0, atol=0)


def test_ffhq64_scaled_pinned_batch():
    """The JAX forward of ffhq_64_scaled (M = 4096, r = 17) on the fixed
    batch that chip_smoke.py checks on the card, and the port against it."""
    spec = GOLDENS["ffhq64_synthetic4"]
    jm, params, tm = _pair(spec["config"], spec["checkpoint"])
    x = golden_input("ffhq64_synthetic4")
    recon_j, aux_j = jax.jit(jm.forward)(params, jnp.asarray(x))
    assert abs(float(jnp.mean((recon_j - x) ** 2)) / spec["recon_mse"] - 1) < 1e-4
    assert abs(float(aux_j) / spec["aux"] - 1) < 1e-4
    with torch.no_grad():
        recon, aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=1e-3, atol=1e-4)
    assert abs(float(((recon - torch.from_numpy(x)) ** 2).mean()) / spec["recon_mse"] - 1) < 1e-3
    assert abs(float(aux) / spec["aux"] - 1) < 1e-2


def test_input_shape_check_and_unported_methods():
    cfg = load_config("mnist_28")
    for k, v in SMALL.items():
        setattr(cfg, k, v)
    tm = HopVAE(cfg, impl="torch", device="cpu")
    with pytest.raises(ValueError, match="looks NCHW"):
        tm(torch.zeros(2, 1, 28, 28))
    with pytest.raises(ValueError, match="expected NHWC"):
        tm(torch.zeros(2, 32, 32, 1))
    # sample and interpolate are ported (prior="None" here): a sample's
    # images, and x unchanged where the two batches' shapes differ
    x = torch.zeros(2, 28, 28, 1)
    assert tm.sample(2, generator=torch.Generator().manual_seed(0)).shape == (2, 28, 28, 1)
    assert tm.interpolate(x, torch.zeros(3, 28, 28, 1)) is x
    assert {"post_vq_conv.weight", "post_vq_conv.bias"} <= tm.state_dict().keys()
    # fit_prior: the uniform prior of prior="None" scores about log2(L) bits,
    # and so does a fresh PixelCNN prior, whose sample and interpolate
    # return images (tests/test_torch_pixelcnn.py holds them against JAX)
    _, aux = tm(torch.zeros(1, 28, 28, 1), fit_prior=True)
    assert abs(aux.item() - np.log2(cfg.num_levels)) < 0.5
    cfg.prior, cfg.prior_num_filters, cfg.prior_num_res_blocks = "PixelCNN", 12, 1
    pixelcnn = HopVAE(cfg, impl="torch", device="cpu")
    _, aux = pixelcnn(torch.zeros(1, 28, 28, 1), fit_prior=True)
    assert abs(aux.item() - np.log2(cfg.num_levels)) < 0.5
    drawn = pixelcnn.sample(2, generator=torch.Generator().manual_seed(0))
    between = pixelcnn.interpolate(x, x)
    assert drawn.shape == between.shape == (2, 28, 28, 1) and torch.isfinite(drawn).all()
