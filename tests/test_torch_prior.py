"""The port's Transformer prior against the JAX package's, on the CPU.

Tiny priors (d 32, 2 or 4 heads, 2 layers, r 4, C 3, L 16, with
``prior_kv_heads`` below the head count too) with JAX's fresh parameters
carried over the bridge: logits and the gradients of the NLL against
``jax.grad``, causality, and the config rules. Then the full
``ffhq_64_scaled`` prior of ``Transformer-FFHQ-64.msgpack``: the committed
grid and ``PRIOR_GOLDENS`` against both packages, and
``HopVAE.forward(fit_prior=True)`` against JAX on the golden batch.
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
from hopvae_tpu.models.priors.transformer import TransformerPrior as JaxTransformerPrior
from hopvae_tpu.ops.bottleneck import bottleneck_params, hopfield_bottleneck as jax_bottleneck
from hopvae_tpu.ops.hopfield import hopfield_lookup
from hopvae_torch import HopVAE, load_config
from hopvae_torch.data import PRIOR_GOLDENS, golden_grid, golden_input
from hopvae_torch.models.priors import NormalPrior, PixelCNNPrior, TransformerPrior, get_prior
from hopvae_torch.serving import state_from_checkpoint
from hopvae_torch.utils.checkpoint import params_from_jax

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
LOG2E = float(np.log2(np.e))


def _tiny_configs(**over):
    """(JAX config, port config) of a tiny Transformer prior."""
    base = {"representation_dim": 4, "index_dim": 3, "num_levels": 16, "prior": "Transformer",
            "prior_d_model": 32, "prior_heads": 2, "prior_layers": 2, **over}
    jcfg, tcfg = jax_load_config("pixelcnn_mnist_28"), load_config("pixelcnn_mnist_28")
    for k, v in base.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    return jcfg, tcfg


def _prior_state(jax_params) -> dict:
    """A JAX prior pytree → the port prior's state_dict, over the bridge."""
    sd = params_from_jax({"prior": jax.device_get(jax_params)})
    return {k.removeprefix("prior."): v for k, v in sd.items()}


def _pair(**over):
    jcfg, tcfg = _tiny_configs(**over)
    jprior = JaxTransformerPrior(jcfg)
    params = jprior.init(jax.random.PRNGKey(0))
    prior = TransformerPrior(tcfg)
    prior.load_state_dict(_prior_state(params))
    return jprior, params, prior, tcfg


def _grid(cfg, b=2, seed=3):
    r, c = cfg.representation_dim, cfg.index_dim
    return np.random.default_rng(seed).integers(0, cfg.num_levels, (b, r, r, c)).astype(np.float32)


def _nll_bits(logits, grid):
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, grid.long()[..., None]).mean() * LOG2E


def _jax_nll_bits(logits, grid):
    logp = jax.nn.log_softmax(logits, -1)
    return -jnp.mean(jnp.take_along_axis(logp, grid.astype(jnp.int32)[..., None], -1)) * LOG2E


# (heads, kv_heads, attn): every backend, plain attention and GQA down to one KV head
CASES = [(2, 2, "auto"), (4, 4, "flash"), (4, 2, "blocked"), (4, 1, "dense"), (2, 1, "flash")]


@pytest.mark.filterwarnings("ignore:prior_kv_heads")
@pytest.mark.parametrize("heads,kv_heads,attn", CASES)
def test_tiny_prior_matches_jax(heads, kv_heads, attn):
    """Logits within rtol 1e-4, atol 1e-5 (the JAX package's flash-against-
    dense tolerance) and every parameter's NLL gradient within rtol 5e-4,
    atol 1e-6."""
    over = {"prior_heads": heads, "prior_kv_heads": kv_heads, "prior_attn": attn,
            "prior_q_block": 16, "prior_kv_block": 8}
    jprior, params, prior, cfg = _pair(**over)
    assert prior.blocks[0].attn == jprior.attn
    g = _grid(cfg)
    want = jax.jit(jprior.forward)(params, jnp.asarray(g))
    jgrads = jax.grad(lambda p: _jax_nll_bits(jprior.forward(p, jnp.asarray(g)), jnp.asarray(g)))(params)
    got = prior(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _nll_bits(got, torch.from_numpy(g)).backward()
    want_grads = _prior_state(jgrads)
    named = dict(prior.named_parameters())
    assert named.keys() == want_grads.keys()
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-4, atol=1e-6, err_msg=name)


def test_one_wide_head_prior_matches_jax():
    """The recipe of ``--set prior_d_model=256 --set prior_heads=1`` at a
    tiny size: one head of 256, one layer, S = 14·14·3 = 588 ≥ 512, so
    ``auto`` picks flash on both sides (the K5 kernels at head width 256 on
    the card; the blocked path on the CPU). Logits and every parameter's
    NLL gradient at the tolerances of ``test_tiny_prior_matches_jax``."""
    jprior, params, prior, cfg = _pair(representation_dim=14, prior_d_model=256, prior_heads=1, prior_layers=1)
    assert prior.blocks[0].attn == jprior.attn == "flash" and prior.seq == 588
    g = _grid(cfg)
    want = jax.jit(jprior.forward)(params, jnp.asarray(g))
    jgrads = jax.jit(jax.grad(lambda p: _jax_nll_bits(jprior.forward(p, jnp.asarray(g)), jnp.asarray(g))))(params)
    got = prior(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _nll_bits(got, torch.from_numpy(g)).backward()
    want_grads = _prior_state(jgrads)
    for name, p in prior.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-4, atol=1e-6, err_msg=name)


def test_causality():
    """Logits at position p depend on no grid value at or after p."""
    _, _, prior, cfg = _pair()
    g1 = _grid(cfg, b=1, seed=0)
    with torch.no_grad():
        base = prior(torch.from_numpy(g1)).reshape(-1, cfg.num_levels)
        for p in (0, 5, base.shape[0] - 1):
            g2 = g1.copy().reshape(-1)
            g2[p:] = (g2[p:] + 7) % cfg.num_levels
            pert = prior(torch.from_numpy(g2.reshape(g1.shape))).reshape(-1, cfg.num_levels)
            torch.testing.assert_close(pert[: p + 1], base[: p + 1], rtol=1e-5, atol=1e-6)
            if p + 1 < base.shape[0]:
                assert not torch.allclose(pert[p + 1 :], base[p + 1 :], rtol=1e-5, atol=1e-6)


def test_config_rules_match_jax():
    """auto selection (dh 192 → blocked, 256 → flash), the GQA and cache
    dtype checks, and the factory."""
    def both(**over):
        jcfg, tcfg = _tiny_configs(**over)
        return JaxTransformerPrior(jcfg).attn, TransformerPrior(tcfg, device="meta").blocks[0].attn

    assert both() == ("dense", "dense")  # S = 48
    assert both(representation_dim=17, prior_d_model=128, prior_heads=4) == ("flash", "flash")
    assert both(representation_dim=17, prior_d_model=768, prior_heads=4) == ("blocked", "blocked")
    assert both(representation_dim=17, prior_d_model=768, prior_heads=3) == ("flash", "flash")
    for bad in ({"prior_kv_heads": 3, "prior_heads": 4}, {"prior_attn": "bogus"}, {"prior_cache_dtype": "fp8"}):
        jcfg, tcfg = _tiny_configs(**bad)
        with pytest.raises(ValueError):
            JaxTransformerPrior(jcfg)
        with pytest.raises(ValueError):
            TransformerPrior(tcfg, device="meta")
    _, tcfg = _tiny_configs(representation_dim=17)
    assert TransformerPrior(tcfg, device="meta").cache_dtype == "int8"  # the auto rule at S >= 512
    assert isinstance(get_prior(tcfg, device="meta"), TransformerPrior)
    tcfg.prior = "None"
    assert isinstance(get_prior(tcfg), NormalPrior)
    tcfg.prior = "PixelCNN"
    assert isinstance(get_prior(tcfg, device="meta"), PixelCNNPrior)
    tcfg.prior = "Glow"
    with pytest.raises(ValueError, match="unknown prior"):
        get_prior(tcfg)
    # the KV-cached decode runs (tests/test_torch_decode.py holds it against JAX)
    prior = TransformerPrior(_tiny_configs()[1])
    g = torch.from_numpy(_grid(prior))
    with torch.no_grad():
        torch.testing.assert_close(prior.decode_logits(g), prior(g), rtol=2e-5, atol=2e-5)
    drawn = prior.sample(2, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 4, 4, 3) and drawn.min() >= 0 and drawn.max() <= 15


def test_reconstruct_and_interpolate_match_jax():
    jprior, params, prior, cfg = _pair()
    g, h = _grid(cfg), _grid(cfg, seed=4)
    want = jprior.reconstruct(params, jnp.asarray(g))
    with torch.no_grad():
        got = prior.reconstruct(torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(prior.interpolate(torch.from_numpy(g), torch.from_numpy(h)),
                               torch.from_numpy((g + h) / 2))


# ------------------------------------------------------------ full width


@pytest.fixture(scope="module")
def ffhq():
    """The JAX model and parameters of ffhq_64_scaled with the Transformer
    prior, from the checkpoint read by flax, and the port's model from the
    port's reader."""
    spec = PRIOR_GOLDENS
    jcfg, tcfg = jax_load_config(spec["config"]), load_config(spec["config"])
    jcfg.prior = tcfg.prior = spec["prior"]
    jm = JaxHopVAE(jcfg)
    raw = serialization.msgpack_restore((CKPTS / spec["checkpoint"]).read_bytes())
    params = serialization.from_state_dict(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))), raw)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tm = HopVAE(tcfg, impl="torch", device="cpu")
    tm.load_state_dict(state_from_checkpoint(str(CKPTS / spec["checkpoint"])))
    return jm, params, tm


def test_committed_grid_is_the_jax_grid(ffhq):
    """The asset is JAX's quantized grid of the golden batch: 22 of 512
    levels, and no sigmoid(logit)·511 within 1e-4 of a level from a
    rounding edge, so a small change of a logit flips no bin."""
    jm, params, _ = ffhq
    x = jnp.asarray(golden_input("ffhq64_synthetic4"))
    z = jm._encode_to_tokens(params, x)
    _, zq, _ = jax_bottleneck(bottleneck_params(params), z, jm.num_levels, impl="xla")
    np.testing.assert_array_equal(golden_grid(), np.asarray(zq).reshape(golden_grid().shape))
    assert len(np.unique(golden_grid())) == 22
    e = hopfield_lookup(params["hopfield"], z)
    levels = np.asarray(jax.nn.sigmoid(hopfield_lookup(params["embedding_to_index"], e))) * 511
    assert np.min(np.abs(levels - np.floor(levels) - 0.5)) > 1e-4


def test_full_prior_holds_the_goldens(ffhq):
    """The prior's bits on the committed grid, and the second output of
    ``forward(fit_prior=True)`` on the golden batch: JAX within 1e-5 of the
    pinned numbers, the port within 1e-5 of them too."""
    spec = PRIOR_GOLDENS
    jm, params, tm = ffhq
    g = golden_grid()
    jbits = float(_jax_nll_bits(jax.jit(jm.prior.forward)(params["prior"], jnp.asarray(g)), jnp.asarray(g)))
    x = golden_input("ffhq64_synthetic4")
    _, jloss = jax.jit(lambda p, x: jm.forward(p, x, fit_prior=True))(params, jnp.asarray(x))
    assert abs(jbits / spec["bits"] - 1) < 1e-5 and abs(float(jloss) / spec["loss"] - 1) < 1e-5
    with torch.no_grad():
        bits = float(tm.prior_bits(torch.from_numpy(g).reshape(g.shape[0], -1, g.shape[-1])))
        recon, loss = tm(torch.from_numpy(x), fit_prior=True)
        _, zq, aux = tm.backbone(torch.from_numpy(x))
    assert abs(bits / spec["bits"] - 1) < 1e-5
    assert abs(float(loss) / spec["loss"] - 1) < 1e-5
    assert abs(float(aux) / spec["aux"] - 1) < 1e-2  # the eager lookups' f32 sums (tests/test_torch_model.py)
    np.testing.assert_array_equal(zq.numpy().reshape(g.shape), g)


def test_fit_prior_forward_matches_jax(ffhq):
    """``forward(fit_prior=True)``: the reconstruction within the backbone
    test's tolerance, the loss within 1e-5, and the gradients of the loss
    reach the prior alone from the bits (the grid's gradient is stopped)."""
    jm, params, tm = ffhq
    x = golden_input("ffhq64_synthetic4")[:2]
    jrecon, jloss = jax.jit(lambda p, x: jm.forward(p, x, fit_prior=True))(params, jnp.asarray(x))
    recon, loss = tm(torch.from_numpy(x), fit_prior=True)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    tm.zero_grad(set_to_none=True)
    _, zq, _ = tm.backbone(torch.from_numpy(x))
    assert zq.requires_grad
    tm.prior_bits(zq).backward()
    assert all(p.grad is not None for p in tm.prior.parameters())
    assert all(p.grad is None for n, p in tm.named_parameters() if not n.startswith("prior."))
    tm.zero_grad(set_to_none=True)


def test_device_rules():
    """The prior's kernels run on the card only: ``impl="cuda"`` on the CPU
    raises, and the flash path on a tensor that is neither on the CPU nor
    on the card raises instead of falling back."""
    _, tcfg = _tiny_configs(prior_attn="flash")
    with pytest.raises(ValueError, match="impl='cuda'"):
        HopVAE(tcfg, impl="cuda", device="cpu")
    prior = TransformerPrior(tcfg, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        prior(torch.zeros(1, 4, 4, 3, device="meta"))
