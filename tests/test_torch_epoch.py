"""The whole-epoch training step (``Trainer.epoch_step``) and its parts, on the CPU.

- The port's ``fit`` on data staged on the device (``epoch_step``'s body,
  eagerly) against JAX's ``Trainer.fit`` on device-resident data (its
  ``epoch_step``, ``impl="xla"``): each epoch's "Train Reconstruction
  Error" and the final parameters, for the backbone phase, a Transformer
  prior phase of d 32, and with ``watch_gradients``.
- ``epoch_step``'s body against the eager ``train_step`` loop on the same
  batches, bit for bit; ``debug_nans`` keeps the eager step.
- The capture-safe histogram, the device-tensor learning rate, the
  logging thread, the capture-aware launch counts, ``utils/flops.py``
  against JAX's and ``utils/benchmark.py`` under a fake clock.

Sizes are ``tests/test_train.py::_tiny_cfg``'s scale: batch 8, 32 images,
2 epochs. Parameters cross from JAX's init over the bridge.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.data import ArrayDataset as JaxArrayDataset
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.parallel import mesh as jax_mesh
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.train import _log_magnitude_histogram
from hopvae_tpu.utils import flops as jax_flops
from hopvae_torch import HopVAE, load_config
from hopvae_torch import data as tdata
from hopvae_torch import train as ttrain
from hopvae_torch.models.priors.transformer import TokenEmbedding
from hopvae_torch.utils import benchmark, flops, nvcc
from hopvae_torch.utils.checkpoint import params_from_jax
from hopvae_torch.utils.metrics import MetricLogger
from test_torch_train import SMALL, TINY_PRIOR, _configs

N_IMAGES, EPOCHS = 32, 2
CONFIGS = ("mnist_28", "pixelcnn_mnist_28", "cifar10_32", "ffhq_32", "ffhq_64", "ffhq_64_scaled", "ffhq_128")


def _dataset(seed: int = 3):
    images = np.random.default_rng(seed).standard_normal((N_IMAGES, 28, 28, 1)).astype(np.float32)
    return images, np.zeros(N_IMAGES, np.int64)


def _records(path) -> list:
    return [r for r in map(json.loads, open(path / "metrics.jsonl")) if "Train Reconstruction Error" in r]


# ------------------------------------------------------------ fit against JAX


@pytest.mark.parametrize("case", ["backbone", "transformer_prior", "watch"])
def test_fit_on_staged_data_matches_jax(case, tmp_path):
    """Two epochs of four steps: the port's ``fit`` (staged data, so
    ``epoch_step``) against JAX's ``fit`` (its ``epoch_step``, one scan an
    epoch), the learning rate decaying once an epoch. Each epoch's "Train
    Reconstruction Error" within 1e-4 relative and the parameters within
    0.1 of a step of lr, as ``test_torch_train.py``'s three steps
    (``norm_stored.bias``, whose gradient is float residue, left out); in
    the prior phase the backbone bit-identical to its start. With
    ``watch_gradients`` each epoch's gradient norms within 2e-3 relative
    (``test_torch_train_flags.py``'s) and every module's histogram counting
    its parameters once a step, as JAX's."""
    over = {**SMALL, **(TINY_PRIOR | {"prior_start": -1} if case == "transformer_prior" else {})}
    jcfg, tcfg = _configs("mnist_28", over)
    params = jax.jit(JaxHopVAE(jcfg).init)(jax.random.PRNGKey(0))
    start = params_from_jax(params)
    images, labels = _dataset()

    jtr = JaxTrainer(JaxHopVAE(jcfg), jcfg, mesh=jax_mesh.make_mesh(devices=jax.devices()[:1]))
    jtr.watch_gradients = case == "watch"
    jparams, _ = jtr.fit(params, JaxArrayDataset(images, labels), JaxArrayDataset(images, labels), epochs=EPOCHS,
                         out_dir=str(tmp_path / "jax"), eval_every=0, save_every=0)

    model = HopVAE(tcfg, impl="torch", device="cpu")
    model.load_state_dict(start)
    tr = ttrain.Trainer(model, tcfg)
    tr.watch_gradients = case == "watch"
    calls = []
    run_epoch = tr._run_epoch
    tr._run_epoch = lambda data, rows: calls.append(rows.shape) or run_epoch(data, rows)
    ds = tdata.ArrayDataset(images, labels)
    tr.fit(ds, ds, epochs=EPOCHS, out_dir=str(tmp_path / "torch"), eval_every=0, save_every=0)
    assert calls == [(N_IMAGES // 8, 8)] * EPOCHS  # every epoch went through epoch_step

    ours, theirs = _records(tmp_path / "torch"), _records(tmp_path / "jax")
    assert len(ours) == len(theirs) == EPOCHS
    for a, b in zip(ours, theirs):
        assert a["fit_prior"] == b["fit_prior"] == (case == "transformer_prior")
        np.testing.assert_allclose(a["Train Reconstruction Error"], b["Train Reconstruction Error"], rtol=1e-4)
        if case == "watch":
            assert a.keys() == b.keys()
            for k in (k for k in a if k.startswith("grad_norm")):
                np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=1e-7, err_msg=k)
            for k in (k for k in a if k.startswith("grad_hist/")):
                module = getattr(tr.model, k.split("/")[1])
                assert sum(a[k]) == sum(b[k]) == 4 * sum(p.numel() for p in module.parameters()), k
    want, lr = params_from_jax(jparams), tcfg.learning_rate
    for name, p in tr.model.state_dict().items():
        if name.endswith("norm_stored.bias"):
            continue
        if case == "transformer_prior" and not name.startswith("prior."):
            torch.testing.assert_close(p, start[name], rtol=0, atol=0, msg=name)
        else:
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=0.1 * lr, err_msg=name)


# ------------------------------------------- the body against train_step


def _tiny_trainer(prior: bool, watch: bool):
    cfg = load_config("mnist_28")
    for k, v in {**SMALL, **(TINY_PRIOR if prior else {})}.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    tr = ttrain.Trainer(HopVAE(cfg, impl="torch", device="cpu"), cfg)
    tr.watch_gradients = watch
    tr.build_optimizer(N_IMAGES // 8, fit_prior=prior)
    return tr


@pytest.mark.parametrize("prior", [False, True], ids=["backbone", "prior"])
@pytest.mark.parametrize("watch", [False, True], ids=["plain", "watch"])
def test_epoch_step_repeats_train_step_bitwise(prior, watch):
    """Two epochs through ``epoch_step``'s body against ``train_step`` over
    ``epoch_batches`` (the same batches in the same order): every step's
    metrics, the parameters, Adam's state and the schedule bit for bit."""
    ds = tdata.ArrayDataset(*_dataset())
    stepped, eager = _tiny_trainer(prior, watch), _tiny_trainer(prior, watch)
    ours, theirs = [], []
    for epoch in range(EPOCHS):
        out = stepped.epoch_step(prior)(stepped._device_data(ds), stepped.epoch_rows(len(ds), epoch))
        ours += [{k: v[i] for k, v in out.items()} for i in range(len(out["loss"]))]
        theirs += [eager.train_step(x) for x in eager.epoch_batches(ds, epoch)]
    assert len(ours) == len(theirs) == EPOCHS * N_IMAGES // 8
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() and ("grad_hist/prior" in a) == (watch and prior)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(stepped.model.state_dict().values(), eager.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = stepped.optimizer.state_dict()["state"], eager.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
                                          for i in sa for k in sa[i])
    assert stepped.schedule.last_epoch == eager.schedule.last_epoch == EPOCHS * N_IMAGES // 8
    assert stepped.optimizer.param_groups[0]["lr"] == eager.optimizer.param_groups[0]["lr"]


def test_epoch_step_refuses_the_eager_paths():
    """``debug_nans`` and a phase other than the optimizer's raise instead
    of running."""
    tr = _tiny_trainer(False, False)
    with pytest.raises(RuntimeError, match="build_optimizer"):
        tr.epoch_step(True)
    tr.debug_nans = True
    with pytest.raises(RuntimeError, match="debug_nans"):
        tr.epoch_step(False)


def test_debug_nans_keeps_the_eager_step(tmp_path):
    """Under ``debug_nans`` ``fit`` on staged data runs ``train_step`` step by
    step, never ``epoch_step``, and still raises before the update."""
    tr = _tiny_trainer(False, False)
    tr.debug_nans = True
    tr.epoch_step = lambda fit_prior: pytest.fail("debug_nans went through epoch_step")
    ds = tdata.ArrayDataset(*_dataset())
    with torch.no_grad():
        tr.model.decoder.conv_1.weight[0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(FloatingPointError, match=r"epoch 0, step 0.*decoder"):
        tr.fit(ds, ds, epochs=1, out_dir=str(tmp_path), eval_every=0, save_every=0)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]) or torch.isnan(v).any(), k


@pytest.mark.parametrize("levels,d", [(512, 128), (9, 5)])
def test_token_embedding_matches_embedding(levels, d):
    """The Transformer prior's ``TokenEmbedding`` (its backward one f32
    product with the one-hot tokens, which repeats bit for bit on the card)
    against ``F.embedding``: the lookup bit for bit, the table's gradient
    within f32 rounding of the other summation order (1e-6 of its largest
    entry), repeated levels included."""
    gen = torch.Generator().manual_seed(levels)
    table = torch.randn(levels, d, generator=gen, requires_grad=True)
    tokens = torch.randint(0, levels, (3, 289), generator=gen)
    cot = torch.randn(3, 289, d, generator=gen)
    ours = TokenEmbedding.apply(tokens, table)
    assert torch.equal(ours, torch.nn.functional.embedding(tokens, table))
    (got,) = torch.autograd.grad((ours * cot).sum(), table)
    (want,) = torch.autograd.grad((torch.nn.functional.embedding(tokens, table) * cot).sum(), table)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------------ histogram


def _histogram_with_boolean_mask(tensors) -> torch.Tensor:
    """The port's histogram before it was made capture-safe: boolean-mask
    indexing and ``bincount``, each of which reads a size on the host."""
    v = torch.log10(torch.cat([t.detach().float().reshape(-1) for t in tensors]).abs() + 1e-12)
    lo, hi = ttrain.HIST_RANGE
    v = v[(v >= lo) & (v <= hi)]
    edges = torch.linspace(lo, hi, ttrain.HIST_BINS + 1, device=v.device)
    idx = (torch.bucketize(v, edges, right=True) - 1).clamp_(max=ttrain.HIST_BINS - 1)
    return torch.bincount(idx, minlength=ttrain.HIST_BINS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capture_safe_histogram_matches_the_old_one_and_jax(seed):
    """Seeded gradient-like tensors over many magnitudes, with values on
    -12 (a zero), on 4 (1e4), past 4 and not finite: the fixed-shape
    histogram equals the boolean-mask one bin for bin, and JAX's
    ``_log_magnitude_histogram``."""
    rng = np.random.default_rng(seed)
    parts = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-14, 6, n)).astype(np.float32) for n in (997, 64, 3001)]
    parts.append(np.array([0.0, -0.0, 1e4, -1e4, 2e4, 1e5, np.inf, -np.inf, np.nan, 1e-12], np.float32))
    tensors = [torch.from_numpy(p) for p in parts]
    got = ttrain.log_magnitude_histogram(tensors)
    assert got.dtype == torch.int64 and got.shape == (ttrain.HIST_BINS,)
    torch.testing.assert_close(got, _histogram_with_boolean_mask(tensors), rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_log_magnitude_histogram([jnp.asarray(p) for p in parts])))
    lv = torch.log10(torch.cat(tensors).abs() + 1e-12)
    assert got.sum() == int(((lv >= -12) & (lv <= 4)).sum()) < sum(p.size for p in parts) - 5  # past 4, inf, NaN
    assert got[0] >= 2 and got[-1] >= 2  # the zeros on -12, the two values on 4


# ------------------------------------------------------------ schedule


def test_device_learning_rate_fills_in_place():
    """The capturable optimizer's learning rate is one 0-d float32 tensor
    that the schedule fills in place at every step (a graph reads it), and
    a checkpoint's optimizer state loads back into that form."""
    cfg = load_config("mnist_28")
    cfg.learning_rate, cfg.gamma = 2e-3, 0.5
    opt, schedule = ttrain.make_optimizer(cfg, torch.nn.Linear(2, 1), 4, capturable=True)
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32 and lr.dim() == 0
    assert opt.param_groups[0]["fused"] and opt.param_groups[0]["capturable"]
    for _ in range(6):
        opt.step()
        schedule.step()
        assert opt.param_groups[0]["lr"] is lr
    state = opt.state_dict()
    state["param_groups"][0].update(lr=float(lr), capturable=False, fused=None)
    opt.load_state_dict(state)
    ttrain._keep_capturable(opt)
    group = opt.param_groups[0]
    assert isinstance(group["lr"], torch.Tensor) and float(group["lr"]) == float(lr)
    assert group["fused"] and group["capturable"]


# ------------------------------------------------------------ logging thread


def _log_threads():
    return [t for t in threading.enumerate() if t.name == ttrain.LOG_THREAD]


def test_log_async_writes_the_synchronous_record(tmp_path):
    """A record queued to the logging thread equals the one written
    synchronously, but for its times; the thread is gone after the drain."""
    steps = np.random.default_rng(2).uniform(0, 1, (5, 2)).astype(np.float32)
    parts = {"loss": torch.from_numpy(steps.sum(1)), "recon_error": torch.from_numpy(steps[:, 0]),
             "aux": torch.from_numpy(steps[:, 1]), "grad_hist/x": torch.arange(80).reshape(5, 16)}
    ttrain.Trainer._write_epoch_record(MetricLogger(str(tmp_path / "s")), {"epoch": 3}, parts, 77, 16, 0.0)
    tr = _tiny_trainer(False, False)
    tr._log_async(MetricLogger(str(tmp_path / "a")), {"epoch": 3}, parts, 77, 16, 0.0)
    (thread,) = _log_threads()
    tr._drain_log_worker()
    thread.join(timeout=10)
    assert not thread.is_alive() and tr._log is None
    line, sync = (json.loads(open(tmp_path / d / "metrics.jsonl").read()) for d in "as")
    times = ("time", "epoch_seconds", "steps_per_sec", "images_per_sec")
    assert line.keys() == sync.keys() and line["epoch_seconds"] > 0
    assert {k: v for k, v in line.items() if k not in times} == {k: v for k, v in sync.items() if k not in times}
    assert line["grad_hist/x"] == np.arange(80).reshape(5, 16).sum(0).tolist()


def test_fit_joins_its_log_thread_and_reraises_its_error(tmp_path, monkeypatch):
    """``fit`` writes each epoch's record on its own named thread, which is
    gone when ``fit`` returns; an error of the writer is raised from
    ``fit`` after the epochs ran."""
    ds = tdata.ArrayDataset(*_dataset())
    tr = _tiny_trainer(False, False)
    seen = []
    write = ttrain.Trainer._write_epoch_record

    def spy(*args, **kw):
        seen.append(threading.current_thread())
        return write(*args, **kw)

    monkeypatch.setattr(ttrain.Trainer, "_write_epoch_record", staticmethod(spy))
    tr.fit(ds, ds, epochs=EPOCHS, out_dir=str(tmp_path / "ok"), eval_every=0, save_every=0)
    assert len(seen) == EPOCHS and {t.name for t in seen} == {ttrain.LOG_THREAD}
    assert all(not t.is_alive() for t in seen) and seen[0] is not threading.current_thread()
    assert len(_records(tmp_path / "ok")) == EPOCHS

    def broken(*args, **kw):
        seen.append(threading.current_thread())
        raise OSError("disk full")

    monkeypatch.setattr(ttrain.Trainer, "_write_epoch_record", staticmethod(broken))
    with pytest.raises(OSError, match="disk full"):
        tr.fit(ds, ds, epochs=EPOCHS + 1, start_epoch=EPOCHS, out_dir=str(tmp_path / "bad"), eval_every=0,
               save_every=0)
    assert not seen[-1].is_alive() and tr.schedule.last_epoch == (EPOCHS + 1) * N_IMAGES // 8


# ------------------------------------------------------------ launch counts


def test_captured_launches_count_at_each_replay(monkeypatch):
    """A launch while the stream is captured adds nothing to ``launches``
    and one to the capture's tally, which each replay adds; a launch
    outside a capture counts at once."""
    def kernel():
        pass

    kernel.launches = 0
    capturing = [False]
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    nvcc.count(kernel)
    capturing[0] = True
    with nvcc.captured_launches() as tally:
        nvcc.count(kernel)
        nvcc.count(kernel)
    nvcc.count(kernel)  # a capture outside captured_launches: counted nowhere
    capturing[0] = False
    assert kernel.launches == 1 and tally == {kernel: 2}
    for _ in range(3):
        nvcc.add_launches(tally)
    assert kernel.launches == 7


# ------------------------------------------------------------ flops


FLOPS_FUNCTIONS = ("encoder_flops", "decoder_flops", "bottleneck_flops", "pre_vq_flops", "forward_flops_per_image",
                   "train_flops_per_image")


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_match_jax(name, monkeypatch):
    """Every function of ``utils/flops.py`` gives JAX's integers for every
    config; the HBM model with JAX's token block set to the port's K1 tile."""
    cfg, jcfg = load_config(name), jax_load_config(name)
    for fn in FLOPS_FUNCTIONS:
        assert getattr(flops, fn)(cfg) == getattr(jax_flops, fn)(jcfg), fn
    r = cfg.representation_dim
    assert flops.residual_stack_flops(cfg, r) == jax_flops.residual_stack_flops(jcfg, r)
    assert flops.conv2d_flops(r, r, 3, 5, 3) == jax_flops.conv2d_flops(r, r, 3, 5, 3)
    f = flops.train_flops_per_image(cfg)
    assert flops.mfu(f, 1000.0) == f * 1000.0 / flops.PEAK_BF16_FLOPS
    assert flops.mfu(f, 1000.0, peak=1e12) == jax_flops.mfu(f, 1000.0, peak=1e12)
    import hopvae_tpu.ops.hopfield_pallas as pallas

    monkeypatch.setattr(pallas, "TOKEN_BLOCK", flops.K1_TOKEN_TILE)
    for table_bytes in (4, 2):
        assert (flops.bottleneck_hbm_bytes_per_image(cfg, table_dtype_bytes=table_bytes)
                == jax_flops.bottleneck_hbm_bytes_per_image(jcfg, table_dtype_bytes=table_bytes))


def test_bounds_reproduce_the_kernel_table():
    """The bound helpers moved from ``chip_smoke.py``: K1's three lookups of
    a full-width ffhq_64_scaled step (N 73,984, M 4,096) at three TF32
    passes give PERF.md's 0.962 ms, bound by operations, at an H100's exp
    rate (132 SMs at 1,980 MHz)."""
    cfg = load_config("ffhq_64_scaled")
    n, m = 256 * cfg.representation_dim**2, cfg.num_embeddings
    d, di = cfg.embedding_dim, cfg.index_dim
    exp_per_s = 132 * flops.SFU_PER_CLOCK_PER_SM * 1980e6
    parts = [flops.bound(n, m, a, b, exp_per_s, tensor_cores=True) for a, b in ((d, d), (d, di), (di, d))]
    assert (n, m) == (73_984, 4096) and {by for _, by in parts} == {"operations"}
    assert round(sum(ms for ms, _ in parts), 3) == 0.962
    assert flops.PEAKS_CARD == "NVIDIA H100 80GB HBM3, 700.00 W"


# ------------------------------------------------------------ benchmark


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def _bench(monkeypatch, times, repeats=3):
    clock = FakeClock(times)
    monkeypatch.setattr(benchmark.time, "perf_counter", clock)
    out = benchmark.device_seconds_per_iter(lambda s: s, torch.zeros(1), iters=10, repeats=repeats)
    assert not clock.times  # every reading used
    return out


def test_benchmark_takes_the_median_slope(monkeypatch):
    """Repeats of (t0, t1, t2): a chain of 10 takes t1 - t0, one of 20
    t2 - t1; the slopes 0.1, 0.3 and 0.2 s over 10 steps give their median,
    0.02 s a step."""
    times = [0, 1, 2.1, 10, 11, 12.3, 20, 21, 22.2]
    assert _bench(monkeypatch, times) == pytest.approx(0.02)


def test_benchmark_ignores_a_glitched_repeat(monkeypatch):
    """A repeat whose long chain came out shorter (a negative slope) is
    dropped; the two left give the mean of their middle."""
    times = [0, 1, 2.2, 10, 11, 11.5, 20, 21, 22.4]
    assert _bench(monkeypatch, times) == pytest.approx(0.03)


def test_benchmark_falls_back_to_the_mean(monkeypatch):
    """No positive slope: one more chain of 20, its mean a step."""
    times = [0, 1, 2, 10, 11, 11.9, 30, 32]
    assert _bench(monkeypatch, times, repeats=2) == pytest.approx(0.1)


def test_benchmark_times_a_real_step():
    """A real chained step on the CPU (no fake clock) takes more than 0 s."""
    w = torch.randn(64, 64)
    assert benchmark.device_seconds_per_iter(lambda s: torch.tanh(s @ w), torch.randn(64, 64), iters=5) > 0
