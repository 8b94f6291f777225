"""The port's KV-cached decode of the Transformer prior against the JAX
package's, on the CPU (f32, the eager step).

Tiny priors (r 5, C 3, L 16, d 32, 2 heads, 2 layers; ``prior_kv_heads``
2, and 1 for MQA; ``prior_decode_segment=16``, so S = 75 runs in five
growing segments) with parameters made by numpy from a seed and carried
over the bridge:

- ``_quantize_token`` against JAX's at int8 and int4;
- ``decode_logits`` against JAX's ``decode_logits`` for each cache dtype,
  and against ``forward`` (f32 exactly; int8 and int4 within JAX's own
  bands);
- the draws: the same numpy Gumbel noise into the port's
  ``sample(_gumbel=...)`` and into JAX's ``_decode_all`` with
  ``argmax(logits + noise[t])``, the ``sample`` of the JAX package with
  its ``jax.random.categorical`` draw replaced by that noise;
- ``sample``'s own noise from a ``torch.Generator``, and the caches it
  writes;
- ``HopVAE.sample`` under ``Transformer-MNIST-28.msgpack`` against the
  JAX chain on the same draws, the engine's ``sample`` and the CLI;
- the error messages.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import _lookup
from hopvae_tpu.models.priors.transformer import TransformerPrior as JaxTransformerPrior
from hopvae_tpu.models.priors.transformer import _quantize_token as jax_quantize_token
from hopvae_torch import load_config
from hopvae_torch.data import gumbel_noise
from hopvae_torch.models.priors import get_prior
from hopvae_torch.models.priors.decode import Decoder
from hopvae_torch.models.priors.pixelcnn import PixelCNNPrior
from hopvae_torch.models.priors.transformer import QMAX, TransformerPrior, _quantize_token, gumbel_
from hopvae_torch.serving import InferenceEngine, main, state_from_checkpoint
from hopvae_torch.utils.checkpoint import params_from_jax
from test_torch_sample import _transformer_pair

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
PORT = Path(__file__).resolve().parents[1] / "hopvae_torch"
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8, "int4": jnp.int4}
TINY = {"representation_dim": 5, "index_dim": 3, "num_levels": 16, "prior": "Transformer", "prior_d_model": 32,
        "prior_heads": 2, "prior_layers": 2, "prior_decode_segment": 16}


def _numpy_params(template, seed: int):
    """A prior's parameters from numpy, in the shapes of ``template``: weights
    of unit gain, so that attention is far from uniform and logits are O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * rng.standard_normal(a.shape, dtype=np.float32)
        if name.endswith("['kernel']"):
            return rng.standard_normal(a.shape, dtype=np.float32) / np.float32(np.sqrt(a.shape[0]))
        if name.endswith("['bias']"):
            return 0.1 * rng.standard_normal(a.shape, dtype=np.float32)
        return rng.standard_normal(a.shape, dtype=np.float32)  # tok_emb, bos, pos_emb

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(template))


def _tiny_pair(kv_heads: int, seed: int = 0, **over):
    """(JAX prior, its parameters, the port's prior on the same numpy weights)."""
    jcfg, tcfg = jax_load_config("pixelcnn_mnist_28"), load_config("pixelcnn_mnist_28")
    for k, v in {**TINY, "prior_kv_heads": kv_heads, **over}.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jprior = JaxTransformerPrior(jcfg)
    params = _numpy_params(jprior.init(jax.random.PRNGKey(0)), seed)
    prior = TransformerPrior(tcfg)
    prior.load_state_dict({k.removeprefix("prior."): v for k, v in params_from_jax({"prior": params}).items()})
    return jprior, jax.tree_util.tree_map(jnp.asarray, params), prior


def _grid(prior, b=3, seed=3):
    r, c = prior.representation_dim, prior.index_dim
    return np.random.default_rng(seed).integers(0, prior.num_levels, (b, r, r, c)).astype(np.float32)


def jax_draws(jprior, params, noise, cache_dtype) -> np.ndarray:
    """JAX's ``sample`` with its draw ``jax.random.categorical(fold_in(key,
    t), logits)`` replaced by ``argmax(logits + noise[t])``: the same
    ``x_of``, the same ``_decode_all``."""
    b, d = noise.shape[1], jprior.d
    noise = jnp.asarray(noise)

    def x_of(tok_prev, t):
        return jnp.where(t == 0, jnp.broadcast_to(params["bos"], (b, d)), params["tok_emb"][tok_prev]) + \
            params["pos_emb"][t]

    def emit(tok_prev, t, logits):
        draw = jnp.argmax(logits + noise[t], axis=-1).astype(jnp.int32)
        return draw, draw

    run = jax.jit(lambda p: jprior._decode_all(p, b, x_of, emit, jnp.zeros((b,), jnp.int32), cache_dtype))
    r, c = jprior.representation_dim, jprior.index_dim
    return np.asarray(run(params)).T.reshape(b, r, r, c).astype(np.float32)


def generator_noise(prior, b: int, seed: int) -> np.ndarray:
    """The noise ``sample(generator=Generator().manual_seed(seed))`` draws:
    a uniform block ``(n, B, L)`` for each segment of ``n`` positions, in
    order, through ``gumbel_``."""
    gen, t = torch.Generator().manual_seed(seed), prior.decode_segment
    blocks = [torch.rand((min(a + t, prior.seq) - a, b, prior.num_levels), generator=gen)
              for a in range(0, prior.seq, t)]
    return gumbel_(torch.cat(blocks)).numpy()


@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_quantize_token_matches_jax(cache_dtype, kv):
    """Codes equal to JAX's and scales within 1e-7 relative, heads of very
    different sizes, a zero head (the 1e-12 floor) and exact halves, which
    both round to even; int4's codes are int8 in [-7, 7]."""
    qmax = QMAX[cache_dtype]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 32)) * rng.choice([1e-3, 1.0, 50.0], size=(6, 32))).astype(np.float32)
    x[0, :16] = 0.0
    x[1] = 0.0
    x[1, 0] = qmax  # the scale is exactly 1 on this head: x/s is x itself
    x[1, 1:5] = [2.5, -3.5, 0.5, -1.5]
    x[1, 16] = qmax
    x[1, 17:19] = [4.5, -5.5]
    want_q, want_s = jax_quantize_token(jnp.asarray(x), kv, qmax=qmax, dtype=JAX_DTYPES[cache_dtype])
    got_q, got_s = _quantize_token(torch.from_numpy(x), kv, qmax)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.shape == (6, kv)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).astype(np.int8))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)
    assert int(got_q.abs().max()) == qmax
    np.testing.assert_array_equal(got_q.numpy()[1, 1:5], [2, -4, 0, -2])


@pytest.mark.filterwarnings("ignore:prior_kv_heads")
@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_decode_logits_matches_jax(cache_dtype, kv):
    """Teacher-forced logits through the cached decode, across five growing
    segments. f32: within rtol 2e-5, atol 2e-5 of JAX's decode and of the
    port's own ``forward`` (JAX's gate). bf16, int8, int4: within 1e-3 of
    the largest logit of JAX's decode in the same dtype (an f32 ulp of an
    input may move one bf16 or code rounding); int8 and int4 also within
    JAX's own bands against ``forward``, 0.05 and 0.5 of it."""
    jprior, params, prior = _tiny_pair(kv)
    assert prior.seq == 75 and prior.decode_segment == 16
    g = _grid(prior)
    want = np.asarray(jax.jit(lambda p, g: jprior.decode_logits(p, g, JAX_DTYPES[cache_dtype]))(params, jnp.asarray(g)))
    got = prior.decode_logits(torch.from_numpy(g), cache_dtype).numpy()
    with torch.no_grad():
        exact = prior(torch.from_numpy(g)).numpy()
    assert got.shape == exact.shape == (3, 5, 5, 3, 16)
    scale = float(np.abs(exact).max())
    assert scale > 1.0  # the weights make logits O(1)
    if cache_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, exact, rtol=2e-5, atol=2e-5)
        return
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    band = {"bfloat16": None, "int8": 0.05, "int4": 0.5}[cache_dtype]
    if band is not None:
        assert np.abs(got - exact).max() < band * max(scale, 1.0)
    assert np.abs(got - exact).max() > 1e-6  # the quantized caches do change the logits


@pytest.mark.filterwarnings("ignore:prior_kv_heads")
@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_draws_with_shared_noise_match_jax(cache_dtype, kv):
    """The same numpy Gumbel noise into both samplers: the grids equal draw
    for draw, float levels in [0, L-1] over many levels."""
    jprior, params, prior = _tiny_pair(kv, prior_cache_dtype=cache_dtype)
    assert prior.cache_dtype == cache_dtype
    noise = gumbel_noise((prior.seq, 4, prior.num_levels), seed=5)
    want = jax_draws(jprior, params, noise, JAX_DTYPES[cache_dtype])
    got = prior.sample(4, _gumbel=noise)
    assert got.dtype == torch.float32 and got.shape == (4, 5, 5, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8


@pytest.mark.filterwarnings("ignore:prior_kv_heads")
def test_sample_draws_from_a_generator():
    """``sample`` draws its noise from the generator, a uniform block for
    each segment (``generator_noise``); the same seed gives the same grid,
    another seed another; the caches hold the auto dtype (bf16 at S 75);
    a noise of the wrong shape and a prior on another device raise."""
    _, _, prior = _tiny_pair(1)
    assert prior.cache_dtype == "bfloat16"
    a = prior.sample(3, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(a.numpy(), prior.sample(3, _gumbel=generator_noise(prior, 3, 2)).numpy())
    torch.testing.assert_close(a, prior.sample(3, generator=torch.Generator().manual_seed(2)), rtol=0, atol=0)
    assert not torch.equal(a, prior.sample(3, generator=torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="_gumbel"):
        prior.sample(3, _gumbel=np.zeros((prior.seq, 2, prior.num_levels), np.float32))
    with pytest.raises(ValueError, match="not cuda"):
        prior.sample(3, device="cuda")
    with pytest.raises(ValueError, match="cache_dtype"):
        prior.decode_logits(a, "fp8")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_the_caches_hold_every_position(cache_dtype):
    """After a decode every position of every layer's caches is written (a
    step index frozen at one position would leave the others zero): each
    k and v row is nonzero, each scale of a quantized cache positive, and
    the codes of int4 lie in [-7, 7]."""
    _, _, prior = _tiny_pair(2)
    dec = Decoder(prior, 2, cache_dtype, "sample")
    noise = torch.from_numpy(gumbel_noise((prior.seq, 2, prior.num_levels), seed=1))
    with torch.inference_mode():
        draws = dec.run(lambda buf, a, b: buf.copy_(noise[a:b]))
    assert draws.shape == (prior.seq, 2) and int(dec.t) == prior.seq
    for cache in dec.caches:
        for name in ("k", "v"):
            assert cache[name].shape == (2, 2, prior.seq, 16)
            assert bool((cache[name].float().abs().amax(dim=-1) > 0).all()), name
        if cache_dtype in QMAX:
            assert bool((cache["ks"] > 0).all()) and bool((cache["vs"] > 0).all())
            assert int(cache["k"].abs().max()) == QMAX[cache_dtype]


@pytest.fixture(scope="module")
def mnist_transformer():
    return _transformer_pair("pixelcnn_mnist_28", "Transformer-MNIST-28.msgpack")


def test_hopvae_sample_matches_jax(mnist_transformer):
    """``HopVAE.sample`` under the trained ``Transformer-MNIST-28`` prior (S
    192 in three segments, auto bf16 caches) from a seeded generator: the
    grid equals JAX's draws with that generator's noise, and the images
    JAX's ``index_to_embedding`` lookup and decoder of that grid within
    1e-5."""
    jm, params, tm = mnist_transformer
    assert tm.prior.cache_dtype == "bfloat16" and jm.prior.cache_dtype == jnp.bfloat16
    noise = generator_noise(tm.prior, 4, 11)
    grid = jax_draws(jm.prior, params["prior"], noise, jnp.bfloat16)
    r, c, top = jm.representation_dim, jm.index_dim, jm.num_levels - 1
    tokens = jnp.asarray(grid).reshape(4, r * r, c) / top
    want = np.asarray(jm._tokens_to_image(params, _lookup(params["index_to_embedding"], tokens, "xla")))
    got = tm.sample(4, generator=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(tm.prior.sample(4, _gumbel=noise).numpy(), grid)
    assert got.shape == (4, 28, 28, 1) and len(np.unique(grid)) > 20
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_engine_and_cli_sample_under_the_transformer_prior(mnist_transformer, tmp_path, capsys):
    """``InferenceEngine(ops=("sample",))`` under ``prior=Transformer`` warms
    up and serves the model's ``sample`` for the seed; the CLI's ``--mode
    sample --set prior=Transformer`` writes ``samples.png``."""
    _, _, tm = mnist_transformer
    cfg = load_config("pixelcnn_mnist_28")
    cfg.prior = "Transformer"
    state = state_from_checkpoint(str(CKPTS / "Transformer-MNIST-28.msgpack"))
    eng = InferenceEngine(cfg, state, max_batch=2, impl="torch", compute_dtype=None, device="cpu", n_sample=3,
                          ops=("sample",))
    got = eng.sample(4)
    np.testing.assert_array_equal(got, eng.sample(4))
    np.testing.assert_allclose(got, tm.sample(3, generator=torch.Generator().manual_seed(4)).numpy(), rtol=0, atol=0)
    out = tmp_path / "served"
    main(["--config", "pixelcnn_mnist_28", "--set", "prior=Transformer", "--checkpoint",
          str(CKPTS / "Transformer-MNIST-28.msgpack"), "--mode", "sample", "--n-sample", "2", "--out", str(out),
          "--impl", "torch", "--compute-dtype", "float32", "--device", "cpu"])
    y = np.load(out / "samples.npy")
    assert y.shape == (2, 28, 28, 1) and np.isfinite(y).all() and (out / "samples.png").is_file()
    assert "samples.png" in capsys.readouterr().out


def test_error_messages():
    """The PixelCNN prior is ported: ``get_prior`` builds it, and an unknown
    prior name raises; no module of the port names item 5 or item 6 of
    the ROADMAP's queue, both ported."""
    cfg = load_config("pixelcnn_mnist_28")
    assert isinstance(get_prior(cfg), PixelCNNPrior)
    cfg.prior = "Glow"
    with pytest.raises(ValueError, match="unknown prior 'Glow'"):
        get_prior(cfg)
    named = [p for p in PORT.rglob("*.py") if "item 6" in p.read_text() or "item 5" in p.read_text()]
    assert not named
