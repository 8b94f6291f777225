"""The trainer's debug aids against the JAX package's, on the CPU:
``watch_gradients`` (``--watch-grads``) against JAX's watched
``_step_core`` and its epoch record, ``--profile``'s trace and
``--debug-nans``' ``FloatingPointError``. JAX's parameters are made by its
own converter from the port's seeded init (a JAX init compiles for
seconds)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import reference_key
from hopvae_tpu.train import HIST_BINS as JAX_HIST_BINS
from hopvae_tpu.train import HIST_RANGE as JAX_HIST_RANGE
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.train import _log_magnitude_histogram
from hopvae_tpu.utils import checkpoint as jax_ckpt
from hopvae_tpu.utils.metrics import MetricLogger as JaxMetricLogger
from hopvae_torch import HopVAE
from hopvae_torch import data as tdata
from hopvae_torch import train as ttrain
from test_torch_train import SMALL, _configs, _jax_steps

MODULES = ("encoder", "pre_vq_conv", "hopfield", "embedding_to_index", "index_to_embedding", "post_vq_conv",
           "decoder")
EDGE = 1e-6  # log10 distance to a bin edge within which two log10s may bin apart


def _watched_pair():
    """A tiny mnist_28 port trainer with watch_gradients on, JAX's params of
    the same weights, and a batch of the golden digits."""
    jcfg, tcfg = _configs("mnist_28", SMALL)
    torch.manual_seed(0)
    model = HopVAE(tcfg, impl="torch", device="cpu")
    sd = {reference_key(k): (v[None] if k.endswith("lookup_weights") else v).numpy()
          for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, jax_ckpt.convert_torch_state_dict(sd, jcfg))
    tr = ttrain.Trainer(model, tcfg)
    tr.watch_gradients = True
    tr.build_optimizer(1)
    return jcfg, params, tr, tdata.golden_input("mnist_digits")[:8]


@pytest.fixture(scope="module")
def jax_watched():
    """JAX's two watched steps on the batch of ``_watched_pair`` (one epoch
    of two steps), compiled once for the tests below."""
    jcfg, params, _, x = _watched_pair()
    return params, _jax_steps(jcfg, params, [x, x], steps_per_epoch=2, watch=True)[1]


def test_watched_step_matches_jax(jax_watched):
    """One watched step: the global and per-module gradient norms against
    JAX's watched ``_step_core`` within ``test_torch_train.py``'s gradient
    norm tolerance; each histogram against JAX's on the same gradients,
    bin for bin except values within 1e-6 of a bin edge in log10 (counted,
    at most 0.01%), and counting every parameter, as JAX's."""
    _, _, tr, x = _watched_pair()
    theirs = jax_watched[1][0]
    ours = tr.train_step(torch.from_numpy(x))
    rtol = tdata.TRAIN_GOLDEN["grad_norm_rtol"]
    np.testing.assert_allclose(float(ours["grad_norm"]), float(theirs["grad_norm"]), rtol=rtol)
    assert {k for k in ours if k.startswith("grad_")} == {k for k in theirs if k.startswith("grad_")}
    flats = {k: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in getattr(tr.model, k).parameters()]) for k in MODULES}
    # JAX's histogram of each module's gradients, in one compile
    wants = jax.jit(lambda fs: [_log_magnitude_histogram([f]) for f in fs])([jnp.asarray(f.numpy())
                                                                               for f in flats.values()])
    for k, want in zip(MODULES, wants):
        np.testing.assert_allclose(float(ours[f"grad_norm/{k}"]), float(theirs[f"grad_norm/{k}"]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
        flat, want = flats[k], np.asarray(want)
        got = ours[f"grad_hist/{k}"].numpy()
        v = np.log10(np.abs(flat.numpy().astype(np.float64)) + 1e-12)
        interior = (v > JAX_HIST_RANGE[0] + 0.5) & (v < JAX_HIST_RANGE[1] - 0.5)  # the ends have one side
        near = int((interior & (np.abs(v - np.round(v)) < EDGE)).sum())
        assert got.dtype == np.int64 and got.sum() == flat.numel() == np.asarray(theirs[f"grad_hist/{k}"]).sum(), k
        assert np.abs(got - want).sum() <= near <= 1e-4 * flat.numel(), (k, got, want, near)
    assert (ttrain.HIST_BINS, ttrain.HIST_RANGE) == (JAX_HIST_BINS, JAX_HIST_RANGE)


def test_histogram_counts_like_numpy():
    """Values on each edge, at the ends and past them, and a zero: the
    port's counts equal ``np.histogram``'s (JAX's rule) on the same f32
    log10s."""
    v = np.array([0.0, 1e-12, 1e-6, 1.0, 9.999e3, 1e4, 2e4, -3.5, 1e-3, 0.1], np.float32)
    got = ttrain.log_magnitude_histogram([torch.from_numpy(v)]).numpy()
    lv = torch.log10(torch.from_numpy(v).abs() + 1e-12).numpy()
    want = np.histogram(lv, bins=ttrain.HIST_BINS, range=ttrain.HIST_RANGE)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(_log_magnitude_histogram([jnp.asarray(v)])))


def test_epoch_record_keys_match_jax(tmp_path, jax_watched):
    """A watched epoch's record holds JAX's keys: ``param_hist``,
    ``grad_hist`` (summed) and ``grad_norm`` (averaged) for each module,
    beside the standard ones. JAX's record is written by its
    ``_write_epoch_record`` from its watched steps and the ``param_hist``
    base its ``fit`` builds."""
    _, _, tr, x = _watched_pair()
    params, metrics = jax_watched
    base = {"epoch": 0, "fit_prior": False}
    for key, sub in params.items():
        leaves = jax.tree_util.tree_leaves(sub)
        if leaves:
            flat = np.concatenate([np.ravel(np.asarray(l)).astype(np.float32) for l in leaves])
            base[f"param_hist/{key}"] = np.histogram(np.log10(np.abs(flat) + 1e-12), bins=JAX_HIST_BINS,
                                                     range=JAX_HIST_RANGE)[0].tolist()
    parts = {k: [m[k] for m in metrics] for k in metrics[0] if k != "loss"}
    JaxTrainer._write_epoch_record(JaxMetricLogger(str(tmp_path / "j")), base, parts, 2, 16, 8, 0.0)
    ds = tdata.ArrayDataset(np.concatenate([x, x]), np.zeros(16, np.int64))
    tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path / "t"), eval_every=0, save_every=0)
    theirs = json.loads(open(tmp_path / "j" / "metrics.jsonl").read())
    ours = json.loads(open(tmp_path / "t" / "metrics.jsonl").read())
    assert ours.keys() == theirs.keys()
    for k in MODULES:
        assert sum(ours[f"grad_hist/{k}"]) == 2 * sum(p.numel() for p in getattr(tr.model, k).parameters())
        assert ours[f"param_hist/{k}"] == ttrain.param_histogram(list(getattr(tr.model, k).parameters()))


def test_cli_profile_and_debug_aids(tmp_path):
    """``--profile --watch-grads --debug-nans`` on one tiny epoch: a trace
    under ``<out>/trace`` that parses, a watched record, nothing raised."""
    out = tmp_path / "run"
    sets = [f"--set={k}={v}" for k, v in {**SMALL, "batch_size": 512}.items()]
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--epochs", "1", "--out", str(out),
                 "--profile", "--watch-grads", "--debug-nans", *sets])
    (trace,) = (out / "trace").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    record = next(json.loads(l) for l in open(out / "metrics.jsonl") if "Train Reconstruction Error" in l)
    assert "grad_norm/hopfield" in record and "param_hist/decoder" in record


def test_debug_nans_raises_at_the_first_bad_step(tmp_path):
    """A NaN in one weight raises ``FloatingPointError`` at epoch 0, step 0,
    naming the modules, before any update; without it nothing is raised."""
    _, _, tr, x = _watched_pair()
    tr.debug_nans = True
    ds = tdata.ArrayDataset(np.concatenate([x, x]), np.zeros(16, np.int64))
    tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path / "ok"), eval_every=0, save_every=0)
    with torch.no_grad():
        tr.model.decoder.conv_1.weight[0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(FloatingPointError, match=r"epoch 1, step 0.*decoder"):
        tr.fit(ds, ds, epochs=2, start_epoch=1, out_dir=str(tmp_path / "nan"), eval_every=0, save_every=0)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]) or torch.isnan(v).any(), k
