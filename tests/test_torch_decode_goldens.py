"""``DECODE_GOLDENS``, which ``chip_smoke.py`` holds the card to, recomputed
with the JAX package on the CPU (f32, ``impl="xla"``), and the port on the
CPU against them: ffhq_64_scaled with ``Transformer-FFHQ-64.msgpack``
(S 867 in seven segments of 128), the committed grid ``golden_grid()``
and the noise of ``gumbel_noise()``."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_torch import HopVAE, load_config
from hopvae_torch.data import DECODE_GOLDENS, PRIOR_GOLDENS, golden_grid, gumbel_noise, sample_grid
from hopvae_torch.serving import state_from_checkpoint
from test_torch_decode import JAX_DTYPES

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
LOG2E = float(np.log2(np.e))


@pytest.fixture(scope="module")
def ffhq():
    """JAX's prior and parameters from the checkpoint read by flax; the
    port's model from the port's reader."""
    spec = DECODE_GOLDENS
    jcfg, tcfg = jax_load_config(spec["config"]), load_config(spec["config"])
    jcfg.prior = tcfg.prior = spec["prior"]
    jm = JaxHopVAE(jcfg)
    raw = serialization.msgpack_restore((CKPTS / spec["checkpoint"]).read_bytes())
    params = serialization.from_state_dict(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))), raw)
    tm = HopVAE(tcfg, impl="torch", device="cpu")
    tm.load_state_dict(state_from_checkpoint(str(CKPTS / spec["checkpoint"])))
    return jm.prior, jax.tree_util.tree_map(jnp.asarray, params["prior"]), tm.prior


def _bits(logits: np.ndarray, grid: np.ndarray) -> float:
    logp = torch.log_softmax(torch.from_numpy(np.array(logits, np.float32)), -1)
    return float(-torch.gather(logp, -1, torch.from_numpy(grid).long()[..., None]).mean()) * LOG2E


def _jax_draws_and_margins(jprior, params, noise, cache_dtype):
    """JAX's ``sample`` with ``argmax(logits + noise[t])`` as its draw, and
    the smallest top-two margin of ``logits + noise[t]`` along each row."""
    b, d = noise.shape[1], jprior.d
    noise = jnp.asarray(noise)

    def x_of(tok_prev, t):
        return jnp.where(t == 0, jnp.broadcast_to(params["bos"], (b, d)), params["tok_emb"][tok_prev]) + \
            params["pos_emb"][t]

    def emit(tok_prev, t, logits):
        y = logits + noise[t]
        draw = jnp.argmax(y, axis=-1).astype(jnp.int32)
        top2 = jax.lax.top_k(y, 2)[0]
        return draw, jnp.stack([draw.astype(jnp.float32), top2[:, 0] - top2[:, 1]])

    out = jax.jit(lambda p: jprior._decode_all(p, b, x_of, emit, jnp.zeros((b,), jnp.int32), cache_dtype))(params)
    out = np.asarray(out)
    r, c = jprior.representation_dim, jprior.index_dim
    return out[:, 0].T.reshape(b, r, r, c), out[:, 1].min(axis=0)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_decode_bits_match_jax(cache_dtype, ffhq):
    """The teacher-forced bits of the committed grid through ``decode_logits``:
    JAX within 1e-6 relative of ``DECODE_GOLDENS``, the f32 caches within
    1e-6 of ``forward``'s ``PRIOR_GOLDENS`` bits; the port on the CPU within
    1e-6 of the golden with f32 caches and 1e-4 with the others, where an
    input an f32 ulp off a bf16 or code rounding edge moves a cache entry by
    a rounding step (measured: bf16 3.7e-6, int8 under 1e-5, int4 2.5e-5;
    the card's limits are 1e-4 and 1e-3)."""
    jprior, params, prior = ffhq
    g = golden_grid()
    want = DECODE_GOLDENS["bits"][cache_dtype]
    logits = np.asarray(jax.jit(lambda p, g: jprior.decode_logits(p, g, JAX_DTYPES[cache_dtype]))(params, jnp.asarray(g)))
    assert abs(_bits(logits, g) / want - 1) < 1e-6
    got = prior.decode_logits(torch.from_numpy(g), cache_dtype).numpy()
    assert abs(_bits(got, g) - want) < (1e-6 if cache_dtype == "float32" else 1e-4)
    if cache_dtype == "float32":
        assert abs(want / PRIOR_GOLDENS["bits"] - 1) < 1e-6
        # against forward, normwise (chip_smoke.py's limit at this size):
        # JAX's own decode lands 3.4e-6 off its forward, past its tiny-size
        # elementwise gate (rtol, atol 2e-5) at 10 of 1.78 M logits
        jfwd = np.asarray(jax.jit(jprior.forward)(params, jnp.asarray(g)))
        with torch.no_grad():
            fwd = prior(torch.from_numpy(g)).numpy()
        assert _normwise(logits, jfwd) < 1e-5 and _normwise(got, fwd) < 1e-5


def _normwise(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_decode_draws_match_jax(cache_dtype, ffhq):
    """The noise recipe, JAX's draws with it equal to the committed grid and
    its smallest margins to ``min_margin`` (each above the card's near-tie
    floor), and the port's draws on the CPU equal to the grid, draw for
    draw."""
    jprior, params, prior = ffhq
    noise = gumbel_noise()
    assert noise.shape == DECODE_GOLDENS["noise"]["shape"] and noise.dtype == np.float32 and np.isfinite(noise).all()
    grid, margins = _jax_draws_and_margins(jprior, params, noise, JAX_DTYPES[cache_dtype])
    np.testing.assert_array_equal(grid, sample_grid(cache_dtype))
    np.testing.assert_allclose(margins, DECODE_GOLDENS["min_margin"][cache_dtype], rtol=1e-3)
    assert margins.min() > DECODE_GOLDENS["near_tie"]
    prior.cache_dtype = cache_dtype
    try:
        got = prior.sample(4, _gumbel=noise)
    finally:
        prior.cache_dtype = "int8"  # the auto rule at S 867
    np.testing.assert_array_equal(got.numpy(), sample_grid(cache_dtype))
