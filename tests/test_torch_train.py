"""The port's training path against the JAX package's, on the CPU.

Three Adam steps of a narrow MNIST model through the port's ``Trainer``
(``impl="torch"``) against JAX ``Trainer._step_core`` (``impl="xla"``)
with ``make_optimizer``; the MNIST train golden pinned in
``hopvae_torch.data.TRAIN_GOLDEN`` against both packages; the schedule
against ``optax``; the batch order against JAX ``iterate_batches``; the
epoch record's quirk; save and resume; and the CLI. The prior phase:
three prior-only steps of a tiny Transformer prior against JAX
``_step_core(True)``, the prior-train golden of ``PRIOR_TRAIN_GOLDEN``
against both packages, the schedule's restart at the switch, the frozen
backbone, and a resume across the switch. Inputs come from numpy with a
seed, and parameters cross over the bridge.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.data import ArrayDataset as JaxArrayDataset
from hopvae_tpu.data import get_datasets as jax_get_datasets
from hopvae_tpu.data import iterate_batches as jax_iterate_batches
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.parallel import mesh as mesh_lib
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.train import make_optimizer as jax_make_optimizer
from hopvae_tpu.utils.checkpoint import load_reference_checkpoint
from hopvae_torch import HopVAE, load_config
from hopvae_torch import data as tdata
from hopvae_torch import train as ttrain
from hopvae_torch.serving import state_from_checkpoint
from hopvae_torch.utils.checkpoint import params_from_jax
from hopvae_torch.utils.metrics import MetricLogger, denormalize
from test_torch_sample import one_thread  # noqa: F401 (a fixture)

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"
SMALL = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 64, "batch_size": 8}
MODULES = ("encoder", "pre_vq_conv", "hopfield", "embedding_to_index", "index_to_embedding", "decoder")


def _configs(name, overrides):
    jcfg, tcfg = jax_load_config(name), load_config(name)
    for k, v in overrides.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    return jcfg, tcfg


def _jax_steps(jcfg, params, batches, steps_per_epoch, watch=False):
    """JAX ``Trainer._step_core`` over ``batches``: (params, [metrics])."""
    model = JaxHopVAE(jcfg)
    tr = JaxTrainer(model, jcfg, mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    tr.watch_gradients = watch
    tr._tx = {False: jax_make_optimizer(jcfg, steps_per_epoch, prior_only=False, params=params)}
    step = jax.jit(tr._step_core(False))
    opt_state = tr._tx[False].init(params)
    out = []
    for x in batches:
        params, opt_state, m = step(params, opt_state, jnp.asarray(x))
        out.append(jax.device_get(m))
    return params, out


def _torch_trainer(tcfg, state, steps_per_epoch):
    model = HopVAE(tcfg, impl="torch", device="cpu")
    model.load_state_dict(state)
    tr = ttrain.Trainer(model, tcfg)
    tr.build_optimizer(steps_per_epoch)
    return tr


def _grad_norms(model) -> dict:
    return {
        k: float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in getattr(model, k).parameters())))
        for k in MODULES
    }


def test_three_train_steps_match_jax():
    """Three steps with the per-epoch decay at one step an epoch, so the
    learning rate changes every step. The loss and its parts agree to 1e-4
    relative (measured: 2.2e-6 for the loss, 1.2e-5 for aux): f32 sums of
    two frameworks in another order. Parameters
    agree to 10% of one step of lr. Adam divides each gradient by its own
    running scale, so where a gradient element is near zero the order of
    the sums moves its update by a visible part of lr: 4.7% at most,
    measured, in one element of 49,414; most differ by under 1e-5 of a
    step. The analytically zero ``norm_stored.bias`` gradients are float
    residue on both sides, which Adam turns into full steps of lr in
    either direction, so those leaves are left out."""
    jcfg, tcfg = _configs("mnist_28", SMALL)
    params = jax.jit(JaxHopVAE(jcfg).init)(jax.random.PRNGKey(0))
    digits = tdata.golden_input("mnist_digits")
    batches = [digits[8 * i : 8 * i + 8] for i in range(3)]
    jparams, jmetrics = _jax_steps(jcfg, params, batches, steps_per_epoch=1)

    tr = _torch_trainer(tcfg, params_from_jax(params), steps_per_epoch=1)
    metrics = [tr.train_step(torch.from_numpy(x)) for x in batches]
    for ours, theirs in zip(metrics, jmetrics):
        for k in ("loss", "recon_error", "aux"):
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4, err_msg=k)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.99**3)
    want = params_from_jax(jparams)
    lr = tcfg.learning_rate
    compared = 0
    for name, p in tr.model.state_dict().items():
        if name.endswith("norm_stored.bias"):
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=0.1 * lr, err_msg=name)
        compared += 1
    assert compared == len(want) - 3


@pytest.mark.parametrize("embedding_dim,index_dim", [(32, 4), (128, 5)])
def test_three_train_steps_match_jax_at_other_widths(embedding_dim, index_dim):
    """The lookups at widths no config uses, which the card's kernels take
    zero-padded (``chip_smoke.py`` phase 13 trains (32, 4) on them): three
    steps of the eager CPU path against JAX's, the loss and its parts
    within 1e-4 relative, as at the configs' widths."""
    jcfg, tcfg = _configs("mnist_28", {**SMALL, "embedding_dim": embedding_dim, "index_dim": index_dim})
    params = jax.jit(JaxHopVAE(jcfg).init)(jax.random.PRNGKey(1))
    digits = tdata.golden_input("mnist_digits")
    batches = [digits[8 * i : 8 * i + 8] for i in range(3)]
    _, jmetrics = _jax_steps(jcfg, params, batches, steps_per_epoch=1)
    tr = _torch_trainer(tcfg, params_from_jax(params), steps_per_epoch=1)
    widths = [(layer.d_in, layer.out_proj.weight.shape[0]) for layer in tr.model.bottleneck_layers().values()]
    assert widths == [(embedding_dim, embedding_dim), (embedding_dim, index_dim), (index_dim, embedding_dim)]
    for x, theirs in zip(batches, jmetrics):
        ours = tr.train_step(torch.from_numpy(x))
        for k in ("loss", "recon_error", "aux"):
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4, err_msg=k)


def _jax_mnist_params():
    spec = tdata.GOLDENS["mnist_digits"]
    jcfg = jax_load_config(spec["config"])
    jcfg.gamma = 1.0
    model = JaxHopVAE(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return jcfg, load_reference_checkpoint(model, params, str(CKPTS / spec["checkpoint"]))


def test_train_golden_pins_the_jax_steps():
    """The JAX numbers pinned in TRAIN_GOLDEN: the step-0 loss and the
    per-module gradient norms (``watch_gradients``), then the loss after
    each of three Adam steps at a constant lr of 1e-3."""
    gold = tdata.TRAIN_GOLDEN
    jcfg, params = _jax_mnist_params()
    x = tdata.golden_input("mnist_digits")
    _, metrics = _jax_steps(jcfg, params, [x] * (len(gold["losses"])), steps_per_epoch=1, watch=True)
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], gold["losses"], rtol=1e-5)
    for k in MODULES:
        np.testing.assert_allclose(float(metrics[0][f"grad_norm/{k}"]), gold["grad_norms"][k], rtol=1e-5, err_msg=k)


def test_port_holds_the_train_golden():
    """The port's eager path (``impl="torch"``, f32, CPU) against the
    pinned JAX numbers, with the tolerances ``chip_smoke.py`` applies to
    the kernels on the card."""
    gold = tdata.TRAIN_GOLDEN
    losses, norms, _ = ttrain.train_golden(str(CKPTS), device="cpu", impl="torch")
    np.testing.assert_allclose(losses[0], gold["losses"][0], rtol=gold["loss0_rtol"])
    np.testing.assert_allclose(losses, gold["losses"], rtol=gold["losses_rtol"])
    for k in MODULES:
        np.testing.assert_allclose(norms[k], gold["grad_norms"][k], rtol=gold["grad_norm_rtol"], err_msg=k)


def test_schedule_matches_optax():
    cfg = load_config("mnist_28")
    cfg.learning_rate, cfg.gamma = 2e-3, 0.5
    steps_per_epoch = 4
    want = optax.exponential_decay(2e-3, transition_steps=steps_per_epoch, decay_rate=0.5, staircase=True)
    opt, schedule = ttrain.make_optimizer(cfg, torch.nn.Linear(2, 1), steps_per_epoch)
    got = []
    for _ in range(10):  # 2.5 epochs
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        schedule.step()
    np.testing.assert_allclose(got, [float(want(k)) for k in range(10)], rtol=1e-6)
    # prior_only: the prior's parameters alone; a prior without parameters raises
    model = torch.nn.Module()
    model.backbone, model.prior = torch.nn.Linear(2, 1), torch.nn.Linear(3, 1)
    opt, _ = ttrain.make_optimizer(cfg, model, steps_per_epoch, prior_only=True)
    assert [p for g in opt.param_groups for p in g["params"]] == list(model.prior.parameters())
    model.prior = torch.nn.ReLU()
    with pytest.raises(ValueError, match="no parameters"):
        ttrain.make_optimizer(cfg, model, 4, prior_only=True)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batch_order_matches_jax(shuffle, drop):
    images = np.arange(37, dtype=np.float32).reshape(37, 1, 1, 1)
    labels = np.arange(37)
    ours = list(tdata.iterate_batches(tdata.ArrayDataset(images, labels), 8, shuffle=shuffle, seed=5,
                                      drop_remainder=drop))
    theirs = list(jax_iterate_batches(JaxArrayDataset(images, labels), 8, shuffle=shuffle, seed=5,
                                      drop_remainder=drop))
    assert len(ours) == len(theirs) == (4 if drop else 5)
    for (a, la), (b, lb) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_device_batches_match_host_batches():
    """The staged path gathers on the device in the order the streaming
    path reads from the host, and that is JAX's fit order."""
    cfg = load_config("mnist_28")
    cfg.batch_size = 8
    images = np.random.default_rng(0).standard_normal((30, 28, 28, 1)).astype(np.float32)
    ds = tdata.ArrayDataset(images, np.zeros(30, np.int64))
    tr = ttrain.Trainer(HopVAE(cfg, impl="torch", device="cpu"), cfg)
    staged = [b.numpy() for b in tr.epoch_batches(ds, epoch=3)]
    tr.DEVICE_DATA_MAX_BYTES = 0
    host = [b.numpy() for b in tr.epoch_batches(ds, epoch=3)]
    theirs = [b for b, _ in jax_iterate_batches(ds, 8, shuffle=True, seed=cfg.seed + 3, drop_remainder=True)]
    assert len(staged) == len(host) == len(theirs) == 3
    for a, b, c in zip(staged, host, theirs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_epoch_record_keeps_the_reference_quirk(tmp_path):
    """"Train Reconstruction Error" is the sum of the per-step means of
    recon_error and aux divided by len(dataset), as in the JAX record."""
    from hopvae_tpu.utils.metrics import MetricLogger as JaxMetricLogger

    steps = np.random.default_rng(2).uniform(0, 1, (5, 2)).astype(np.float32)
    parts = [{"loss": torch.tensor(r + a), "recon_error": torch.tensor(r), "aux": torch.tensor(a)} for r, a in steps]
    ours = ttrain.Trainer._write_epoch_record(MetricLogger(str(tmp_path / "t")), {"epoch": 3}, parts, 77, 16, 0.0)
    JaxTrainer._write_epoch_record(
        JaxMetricLogger(str(tmp_path / "j")), {"epoch": 3},
        {"recon_error": list(steps[:, 0]), "aux": list(steps[:, 1])}, 5, 77, 16, 0.0,
    )
    theirs = json.loads(open(tmp_path / "j" / "metrics.jsonl").read())
    line = json.loads(open(tmp_path / "t" / "metrics.jsonl").read())
    for k in ("Train Reconstruction Error", "train_loss_per_batch"):
        assert ours[k] == theirs[k] == line[k], k
    assert ours["Train Reconstruction Error"] == pytest.approx(float(steps.astype(np.float64).sum()) / 77)
    assert line["step"] == 3 and line["images_per_sec"] > 0


def _tiny(tmp_path, **over):
    cfg = load_config("mnist_28")
    for k, v in {**SMALL, **over}.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    model = HopVAE(cfg, impl="torch", device="cpu")
    rng = np.random.default_rng(1)
    ds = tdata.ArrayDataset(rng.standard_normal((20, 28, 28, 1)).astype(np.float32), np.zeros(20, np.int64))
    return cfg, ttrain.Trainer(model, cfg), ds


def test_save_and_resume_round_trip(tmp_path):
    """Two epochs, saved; a fresh trainer resumes from the checkpoint with
    the same parameters, optimizer state, step count and learning rate,
    and its third epoch equals that of an uninterrupted run."""
    cfg, tr, ds = _tiny(tmp_path, gamma=0.5)
    tr.fit(ds, ds, epochs=2, out_dir=str(tmp_path / "a"), eval_every=0, save_every=1)
    assert tr.schedule.last_epoch == 4 and tr.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.25)

    _, tr2, _ = _tiny(tmp_path, gamma=0.5)
    tr2.fit(ds, ds, epochs=3, out_dir=str(tmp_path / "a"), eval_every=0, save_every=0, resume=True)
    tr.fit(ds, ds, epochs=3, start_epoch=2, out_dir=str(tmp_path / "b"), eval_every=0, save_every=0)
    assert tr2.schedule.last_epoch == tr.schedule.last_epoch == 6
    assert tr2.optimizer.param_groups[0]["lr"] == tr.optimizer.param_groups[0]["lr"]
    for (name, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    records = [json.loads(l) for l in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1, 2]


def test_fit_evaluates_and_raises_at_the_prior_phase(tmp_path, one_thread):
    """A PixelCNN config evaluates in epoch 0, then trains its prior phase
    (a fresh PixelCNN, the backbone frozen); an unknown prior raises at the
    phase check; a prior without parameters never switches."""
    cfg, tr, ds = _tiny(tmp_path, prior="PixelCNN", prior_start=0, prior_num_filters=12, prior_num_res_blocks=1)
    tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path), save_every=0)
    records = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    test_err = [r["Test Reconstruction Error"] for r in records if "Test Reconstruction Error" in r]
    assert len(test_err) == 1 and test_err[0] == pytest.approx(tr.evaluate(ds), rel=1e-6)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.fit(ds, ds, epochs=2, start_epoch=1, out_dir=str(tmp_path), eval_every=0, save_every=0)
    assert tr.fit_prior and json.loads(open(tmp_path / "metrics.jsonl").readlines()[-1])["fit_prior"]
    for name, p in tr.model.state_dict().items():
        assert torch.equal(p, before[name]) != name.startswith("prior."), name
    cfg.prior = "Glow"
    with pytest.raises(ValueError, match="unknown prior"):
        tr.fit(ds, ds, epochs=3, start_epoch=2, out_dir=str(tmp_path), eval_every=0, save_every=0)
    cfg.prior = "None"  # a prior without parameters never switches
    tr.fit(ds, ds, epochs=2, start_epoch=1, out_dir=str(tmp_path), eval_every=0, save_every=0)


def test_datasets_match_jax():
    """The hermetic MNIST fallback renders the same digits as JAX's, and
    the FFHQ fallback splits 70/10/20 with the same permutation."""
    jcfg, tcfg = _configs("mnist_28", {})
    ours, theirs = tdata.get_datasets(tcfg, None), jax_get_datasets(jcfg, None)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    fcfg = load_config("ffhq_64_scaled")
    train, val, test = tdata.get_datasets(fcfg, None)
    assert (len(train), len(val), len(test)) == (1433, 204, 411)
    assert train.images.shape[1:] == (64, 64, 3) and train.images.dtype == np.float32
    np.testing.assert_allclose(denormalize(train.images[:2], "FFHQ"), train.images[:2] + 0.5)


def test_cli_trains_one_tiny_epoch(tmp_path, capsys):
    out = tmp_path / "run"
    sets = [f"--set={k}={v}" for k, v in {**SMALL, "batch_size": 512}.items()]
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--epochs", "1",
                 "--out", str(out), *sets])
    records = [json.loads(l) for l in open(out / "metrics.jsonl")]
    train_rec = [r for r in records if "Train Reconstruction Error" in r]
    assert len(train_rec) == 1 and np.isfinite(train_rec[0]["Train Reconstruction Error"])
    assert any("Test Reconstruction Error" in r for r in records)
    ckpt = out / "MNIST-28.pt"
    assert ckpt.exists()
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--eval-only",
                 "--checkpoint", str(ckpt), "--out", str(out), *sets])
    assert "Test Reconstruction Error" in capsys.readouterr().out


def test_cli_trains_the_prior_phase(tmp_path):
    """The prior-phase command on the CPU at a small override: every epoch
    is a prior epoch, and its checkpoint holds the prior and its phase."""
    out = tmp_path / "prior"
    sets = [f"--set={k}={v}" for k, v in {**SMALL, "batch_size": 512, **TINY_PRIOR, "prior_start": -1}.items()]
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--epochs", "1", "--out", str(out), *sets])
    records = [json.loads(l) for l in open(out / "metrics.jsonl") if "Train Reconstruction Error" in l]
    assert len(records) == 1 and records[0]["fit_prior"] and np.isfinite(records[0]["Train Reconstruction Error"])
    ckpt = torch.load(out / "MNIST-28.pt")
    assert ckpt["fit_prior"] is True and "prior.tok_emb" in ckpt["model"]


def test_cli_trains_the_prior_phase_with_one_wide_head(tmp_path):
    """The one-wide-head recipe (``prior_d_model=256``, ``prior_heads=1``)
    through the prior-phase CLI on the CPU at a small override, with
    ``prior_attn=flash``: the K5 kernels at head width 256 on the card, the
    blocked path here. Every epoch is a prior epoch, and the checkpoint
    holds the 256-wide prior."""
    out = tmp_path / "wide"
    over = {**SMALL, "batch_size": 512, **TINY_PRIOR, "prior_d_model": 256, "prior_heads": 1, "prior_layers": 1,
            "prior_attn": "flash", "prior_start": -1}
    ttrain.main(["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--epochs", "1", "--out", str(out),
                 *(f"--set={k}={v}" for k, v in over.items())])
    records = [json.loads(l) for l in open(out / "metrics.jsonl") if "Train Reconstruction Error" in l]
    assert len(records) == 1 and records[0]["fit_prior"] and np.isfinite(records[0]["train_loss_per_batch"])
    model = torch.load(out / "MNIST-28.pt")["model"]
    assert model["prior.blocks.0.qkv.weight"].shape == (768, 256) and "prior.blocks.1.qkv.weight" not in model


def test_cli_without_card_raises(monkeypatch):
    """No --device means the card; without one the CLI raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--config", "mnist_28", "--epochs", "1"])
    with pytest.raises(ValueError, match="impl='cuda'"):
        ttrain.main(["--config", "mnist_28", "--epochs", "1", "--device", "cpu"])


# ------------------------------------------------------------ prior phase

TINY_PRIOR = {"prior": "Transformer", "prior_d_model": 32, "prior_heads": 2, "prior_layers": 2}


def test_prior_phase_steps_match_jax():
    """Three prior-only steps of a narrow MNIST model with a tiny
    Transformer prior, the learning rate decaying every step: the loss and
    its parts within 1e-4 relative, the prior's parameters within 10% of
    one step of lr (as in ``test_three_train_steps_match_jax``), and the
    backbone bit-identical in the port and in JAX."""
    jcfg, tcfg = _configs("mnist_28", {**SMALL, **TINY_PRIOR})
    params = jax.jit(JaxHopVAE(jcfg).init)(jax.random.PRNGKey(0))
    digits = tdata.golden_input("mnist_digits")
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
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4, err_msg=k)
    want, lr = params_from_jax(jparams), tcfg.learning_rate
    for name, p in model.state_dict().items():
        if name.startswith("prior."):
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=0.1 * lr, err_msg=name)
        else:
            torch.testing.assert_close(p, start[name], rtol=0, atol=0, msg=name)
            torch.testing.assert_close(want[name], start[name], rtol=0, atol=0, msg=name)


def test_prior_train_golden_pins_the_jax_steps():
    """The JAX numbers pinned in PRIOR_TRAIN_GOLDEN: the prior's step-0
    gradient norm (``watch_gradients``) and the loss after each of three
    prior-only Adam steps at a constant lr of 1e-3."""
    gold, spec = tdata.PRIOR_TRAIN_GOLDEN, tdata.PRIOR_GOLDENS
    jcfg = jax_load_config(spec["config"])
    jcfg.prior, jcfg.gamma = spec["prior"], 1.0
    model = JaxHopVAE(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, load_reference_checkpoint(model, params, str(CKPTS / spec["checkpoint"])))
    tr = JaxTrainer(model, jcfg, mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    tr.watch_gradients = True
    tr._tx = {True: jax_make_optimizer(jcfg, 1, prior_only=True, params=params)}
    step = jax.jit(tr._step_core(True))
    opt_state, x, losses = tr._tx[True].init(params), jnp.asarray(tdata.golden_input("ffhq64_synthetic4")), []
    for k in range(len(gold["losses"])):
        params, opt_state, m = step(params, opt_state, x)
        losses.append(float(m["loss"]))
        if k == 0:
            np.testing.assert_allclose(float(m["grad_norm/prior"]), gold["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(losses, gold["losses"], rtol=1e-5)


def test_port_holds_the_prior_train_golden():
    """The port's CPU path (eager lookups, blocked attention) against the
    pinned JAX numbers, with the tolerances ``chip_smoke.py`` applies on
    the card, and the backbone left bit-identical."""
    gold, spec = tdata.PRIOR_TRAIN_GOLDEN, tdata.PRIOR_GOLDENS
    losses, norm, model = ttrain.prior_train_golden(str(CKPTS), device="cpu", impl="torch")
    np.testing.assert_allclose(losses, gold["losses"], rtol=gold["losses_rtol"])
    np.testing.assert_allclose(norm, gold["grad_norm"], rtol=gold["grad_norm_rtol"])
    stored = state_from_checkpoint(str(CKPTS / spec["checkpoint"]))
    for name, p in model.state_dict().items():
        if not name.startswith("prior."):
            torch.testing.assert_close(p, stored[name], rtol=0, atol=0, msg=name)


class _LrTrainer(ttrain.Trainer):
    """Records the learning rate and the phase of every step."""

    def train_step(self, x):
        self.seen.append((self.fit_prior, self.optimizer.param_groups[0]["lr"]))
        return super().train_step(x)


def _tiny_prior_trainer(**over):
    cfg = load_config("mnist_28")
    for k, v in {**SMALL, **TINY_PRIOR, **over}.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    tr = _LrTrainer(HopVAE(cfg, impl="torch", device="cpu"), cfg)
    tr.seen = []
    rng = np.random.default_rng(1)
    ds = tdata.ArrayDataset(rng.standard_normal((16, 28, 28, 1)).astype(np.float32), np.zeros(16, np.int64))
    return cfg, tr, ds


def test_phase_switch_restarts_the_schedule_and_freezes_the_backbone(tmp_path):
    """At epoch > prior_start a fresh optimizer over the prior alone: its
    learning rate restarts at learning_rate and decays as a fresh optax
    schedule does; the records carry fit_prior; the backbone stays
    bit-identical through the prior phase while the prior trains."""
    cfg, tr, ds = _tiny_prior_trainer(gamma=0.5, prior_start=0)
    tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path), eval_every=0, save_every=0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.fit(ds, ds, epochs=3, start_epoch=1, out_dir=str(tmp_path), eval_every=0, save_every=0)
    sched = optax.exponential_decay(1e-3, transition_steps=2, decay_rate=0.5, staircase=True)
    want = [(False, float(sched(k))) for k in range(2)] + [(True, float(sched(k))) for k in range(4)]
    assert [p for p, _ in tr.seen] == [p for p, _ in want]
    np.testing.assert_allclose([lr for _, lr in tr.seen], [lr for _, lr in want], rtol=1e-6)
    records = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [bool(r["fit_prior"]) for r in records] == [False, True, True]
    for name, p in tr.model.state_dict().items():
        assert torch.equal(p, before[name]) != name.startswith("prior."), name


def test_resume_across_the_switch(tmp_path):
    """A checkpoint of the backbone phase resumed into the prior phase
    starts a fresh prior optimizer (and says so), as JAX's resume does;
    the resumed epoch equals that of an uninterrupted run."""
    cfg, tr, ds = _tiny_prior_trainer(prior_start=0)
    tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path / "a"), eval_every=0, save_every=1)
    assert torch.load(tmp_path / "a" / "MNIST-28.pt")["fit_prior"] is False
    _, resumed, _ = _tiny_prior_trainer(prior_start=0)
    resumed.fit(ds, ds, epochs=2, out_dir=str(tmp_path / "a"), eval_every=0, save_every=1, resume=True)
    tr.fit(ds, ds, epochs=2, start_epoch=1, out_dir=str(tmp_path / "b"), eval_every=0, save_every=0)
    assert resumed.fit_prior and resumed.schedule.last_epoch == tr.schedule.last_epoch == 2
    for (name, a), b in zip(tr.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    ckpt = torch.load(tmp_path / "a" / "MNIST-28.pt")
    assert ckpt["fit_prior"] is True and ckpt["epoch"] == 1
    # a resume inside the prior phase restores the prior's optimizer
    _, again, _ = _tiny_prior_trainer(prior_start=0)
    again.fit(ds, ds, epochs=2, out_dir=str(tmp_path / "a"), eval_every=0, save_every=0, resume=True)
    assert again.fit_prior and again.schedule.last_epoch == 2
    assert again.optimizer.state_dict()["state"].keys() == resumed.optimizer.state_dict()["state"].keys()
