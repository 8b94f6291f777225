"""Training driver for the port (counterpart of ``hopvae_tpu/train.py``).

    python -m hopvae_torch.train --config ffhq_64_scaled --production   # on the card
    python -m hopvae_torch.train --config mnist_28 --device cpu --impl torch
    python -m hopvae_torch.train --config ffhq_64_scaled --production \
        --set prior=Transformer --set prior_start=-1 \
        --checkpoint checkpoints/Transformer-FFHQ-64.msgpack      # the prior phase
    python -m hopvae_torch.train --config pixelcnn_mnist_28 --set prior_start=-1 \
        --checkpoint checkpoints/PixelCNN-MNIST-28.msgpack        # the PixelCNN's

What it keeps from the JAX driver:

- Adam (0.9, 0.999, 1e-8) with a staircase decay of the learning rate once
  per epoch, stepped per optimizer step; loss = recon MSE + aux;
- each epoch shuffles with ``np.random.default_rng(seed + epoch)`` and
  drops the remainder; a dataset of up to 1 GB is staged on the device
  once and gathered there per batch, a larger one streams from the host;
- the reference's epoch metric, the sum of the per-step means divided by
  ``len(dataset)``, under its name "Train Reconstruction Error"; eval and
  save every 5 epochs with the modulo quirk (epoch 0 always), 0 disables;
- checkpoints carry the optimizer, its phase and the epoch, so a resume
  resumes the learning-rate schedule too;
- the prior phase: from ``epoch > prior_start`` (for a prior with
  parameters) a fresh Adam and schedule over the prior's parameters
  alone, the learning rate restarting at ``learning_rate``, and the
  prior's bits in the loss. The JAX package differentiates the whole
  model and gives the frozen leaves zero updates; here the backbone runs
  under ``torch.no_grad()``, which gives the same updates and runs no
  backbone backward. A resume across the switch starts a fresh prior
  optimizer, as JAX's does.

- ``evaluate``: the recon-MSE sweep, then JAX's PNG grids
  ``epoch{epoch:04d}_{name}.png`` in ``out_dir``: 16 samples drawn with the
  seed ``seed + epoch``, the last batch's inputs and reconstructions, the
  interpolation of the first two test batches and those two batches
  (``test_Y``, ``test_Z``); in ``fit`` and under ``--eval-only``.

- ``--watch-grads`` (``Trainer.watch_gradients``): each step's global
  gradient norm and, for each top-level module with parameters, its norm
  and a histogram of ``log10(|g| + 1e-12)`` in 16 unit bins over [-12, 4)
  (int64 counts); each epoch's record holds their mean and their sum, and
  the same histogram of each module's parameters. ``--profile``: a
  ``torch.profiler`` trace (CPU and, on the card, CUDA activity) written
  under ``<out>/trace``, with the program's spans on its clock.
  ``--debug-nans`` (``Trainer.debug_nans``): the
  first step whose loss or any gradient is not finite raises
  ``FloatingPointError`` before its update, naming the epoch, the step
  and the modules.
- a dataset that is not an in-memory array (``data.LazyImageFolder``)
  streams from the host, two batches read ahead on a thread;
- under a process group (``torchrun``; ``parallel.mesh``) each data index
  trains on its slice of every global batch and the gradients are
  averaged over the data group; with ``shard_patterns`` and a model group
  of more than one rank, each rank holds its rows of every pattern memory,
  the lookups merge over the group, and the folded tables' replicated
  parameters sum their partial gradients over it. ``evaluate`` averages
  the MSE over the data group; only rank 0 writes grids, records and
  checkpoints, which hold the full memories and their Adam moments, so a
  resume reads them on any layout. ``python -m hopvae_torch.train`` under
  ``torchrun`` trains data-parallel.

The step: the forward under autograd, the backward through the streaming
kernels (``impl="cuda"``) or the eager lookups (``impl="torch"``), the
Transformer prior's attention through the flash kernels on the card, the
PixelCNN prior's convs through cuDNN in full f32, then Adam (fused and
capturable on the card). Data staged on the device in a process without
a group trains through ``Trainer.epoch_step``, JAX's whole-epoch step: on
the card each phase's step is captured once in a CUDA graph, after two
eager warm-up steps, and replayed for every later step; on the CPU the
same body runs eagerly. ``--debug-nans`` (it reads the host between the
backward and the update), streamed data and process groups run
``train_step`` step by step. The epoch records are fetched and written on
a logging thread, which ``fit`` joins when it returns or raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.data import PRIOR_TRAIN_GOLDEN, TRAIN_GOLDEN, get_datasets, golden_input, iterate_batches
from hopvae_torch.models.hopvae import HopVAE, resolve_device
from hopvae_torch.ops.bottleneck import LAYERS
from hopvae_torch.parallel import mesh as mesh_lib
from hopvae_torch.serving import state_from_checkpoint
from hopvae_torch.utils.checkpoint import load_reference_checkpoint
from hopvae_torch.utils.graphs import collector_held
from hopvae_torch.utils.metrics import MetricLogger, denormalize, save_image_grid
from hopvae_torch.utils import tracing
from hopvae_torch.utils.nvcc import add_launches, captured_launches

# --watch-grads' histograms: 16 unit bins of log10|v| over [-12, 4), the last
# closed and values outside dropped (np.histogram's rule), as JAX's
HIST_BINS = 16
HIST_RANGE = (-12.0, 4.0)
# the folded tables' replicated parameters, which a pattern shard reaches
# only through its own rows of K and U (fold_layer): partial gradients
FOLDED = ("norm_stored.weight", "norm_stored.bias", "norm_proj.weight", "norm_proj.bias", "in_proj.weight",
          "in_proj.bias", "out_proj.weight")
PATTERNS = tuple(f"{name}.lookup_weights" for name in LAYERS)
LOG_THREAD = "hopvae-epoch-log"  # the thread that writes fit's epoch records


def log_magnitude_histogram(tensors) -> torch.Tensor:
    """``(HIST_BINS,)`` int64 counts of ``log10(|v| + 1e-12)`` over the
    values of ``tensors`` (f32), on their device: JAX's
    ``_log_magnitude_histogram``, counted exactly (``np.histogram``'s rule:
    the last bin closed, values outside the range dropped). Every shape is
    fixed by the inputs' sizes and nothing is read on the host, so a CUDA
    graph can capture it: each value goes to its bin, or to an extra bin
    past the last that is dropped, and the bins count with ``index_add_``."""
    v = torch.log10(torch.cat([t.detach().float().reshape(-1) for t in tensors]).abs() + 1e-12)
    lo, hi = HIST_RANGE
    edges = torch.linspace(lo, hi, HIST_BINS + 1, device=v.device)
    idx = (torch.bucketize(v, edges, right=True) - 1).clamp_(max=HIST_BINS - 1)
    idx = torch.where((v >= lo) & (v <= hi), idx, HIST_BINS)
    counts = torch.zeros(HIST_BINS + 1, dtype=torch.int64, device=v.device)
    return counts.index_add_(0, idx, torch.ones_like(idx))[:HIST_BINS]


def param_histogram(tensors) -> list[int]:
    """The epoch record's ``param_hist``: JAX's numpy histogram on the host."""
    flat = np.concatenate([t.detach().cpu().float().numpy().ravel() for t in tensors])
    return np.histogram(np.log10(np.abs(flat) + 1e-12), bins=HIST_BINS, range=HIST_RANGE)[0].tolist()


@contextlib.contextmanager
def profiled(out_dir: str, enabled: bool = True, cuda: bool = True):
    """A ``torch.profiler`` trace of the block (CPU and, with ``cuda``, CUDA
    activity), written as Chrome trace JSON to
    ``<out_dir>/trace/rank<r>.trace.json`` when the block ends, as JAX
    stops its trace, also on an exception. The program's spans
    (:mod:`hopvae_torch.utils.tracing`) are recorded over the block and
    written into the trace on its clock, with ``"cat": "program_span"``.
    Yields the profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    prof = torch.profiler.profile(activities=activities)
    tracing.enable()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        tracing.disable()
        os.makedirs(os.path.join(out_dir, "trace"), exist_ok=True)
        path = os.path.join(out_dir, "trace", f"rank{rank}.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(tracing.chrome_events(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)


def prior_has_parameters(config) -> bool:
    """Whether the config's prior is trained in a phase of its own (the
    JAX package switches to it at ``epoch > prior_start``)."""
    if config.prior in ("None", None):
        return False
    if config.prior in ("PixelCNN", "Transformer"):
        return True
    raise ValueError(f"unknown prior {config.prior!r}")


def make_optimizer(config, model: torch.nn.Module, steps_per_epoch: int, *, prior_only: bool = False,
                   capturable: bool | None = None):
    """``(Adam, schedule)`` over the parameters of ``model``, or with
    ``prior_only`` over those of ``model.prior`` alone: the learning rate
    at optimizer step ``k`` is ``learning_rate * gamma ** (k //
    steps_per_epoch)``, the value of ``optax.exponential_decay(staircase=
    True)`` at update ``k``. Step the schedule after each optimizer step;
    ``schedule.last_epoch`` counts the steps. A prior without parameters
    raises ``ValueError`` under ``prior_only``.

    ``capturable`` (by default: where the parameters are on a CUDA device)
    makes Adam fused and capturable, so that a CUDA graph can hold its
    step: the learning rate is a 0-d float32 tensor on the parameters'
    device, which the schedule fills in place and the graph reads; the
    step counts and the bias correction stay on the device. Fused, one
    kernel updates every parameter, where ``foreach`` takes about ten
    launches a step; the card's eager ``train_step`` and its graph run the
    same optimizer, so the two agree bit for bit. Otherwise (the CPU, where
    the tests hold the port against JAX) the learning rate is a Python
    float and Adam takes its default implementation."""
    if prior_only:
        model = model.prior
        if not any(True for _ in model.parameters()):
            raise ValueError(f"the prior {type(model).__name__} has no parameters to train")
    params = list(model.parameters())
    if capturable is None:
        capturable = bool(params) and params[0].device.type == "cuda"
    if capturable:
        lr = torch.tensor(config.learning_rate, dtype=torch.float32, device=params[0].device)
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True, capturable=True)
    else:
        optimizer = torch.optim.Adam(params, lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    per_epoch, gamma = max(steps_per_epoch, 1), config.gamma
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: gamma ** (step // per_epoch))
    return optimizer, schedule


def _keep_capturable(optimizer) -> None:
    """After ``load_state_dict``, which takes each group's settings and
    learning rate from the checkpoint (on the host, or a Python float from
    an older or a CPU checkpoint): fused and capturable again, the learning
    rate a new 0-d float32 tensor on the parameters' device, and the step
    counts there in float32."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        group.update(fused=True, capturable=True, foreach=None)
        group["lr"] = torch.as_tensor(group["lr"], dtype=torch.float32).to(device)
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = torch.as_tensor(state["step"], dtype=torch.float32).to(device)


class Trainer:
    """Trains a :class:`HopVAE` in place on the model's device; under a
    ``parallel.mesh.Mesh`` as one rank of it."""

    # datasets up to this many bytes are staged on the device once and
    # gathered there per batch; larger ones stream from the host
    DEVICE_DATA_MAX_BYTES = 1 << 30

    def __init__(self, model: HopVAE, config, mesh: mesh_lib.Mesh | None = None, *, shard_patterns: bool = False):
        """With a ``mesh`` every rank starts from rank 0's weights; with
        ``shard_patterns`` and more than one model rank each rank then keeps
        its rows of every pattern memory, and the model's lookups merge over
        the model group. The model's routing is set here either way, so a
        model once trained sharded routes plainly under a later trainer
        without a mesh (as JAX's ``Trainer`` resets it)."""
        self.model = model
        self.config = config
        self.device = model.device
        self.mesh = mesh
        self.sharded = mesh is not None and shard_patterns and mesh.n_model > 1
        self.multi = mesh is not None and mesh.n_data * mesh.n_model > 1
        self.rank = mesh.rank if mesh is not None else 0
        self.watch_gradients = False
        self.debug_nans = False
        self.optimizer = self.schedule = None
        self.steps_per_epoch = None
        self.fit_prior = False  # the phase of the optimizer
        self.position = (0, 0)  # (epoch, step) of the next train_step
        self.captures = 0  # CUDA graphs captured by epoch_step
        self._staged = None  # (host images, device copy)
        self._epochs = {}  # the epoch steps of the current optimizer, by key (epoch_step)
        self._log = None  # the logging thread, its queue and its errors (_log_async)
        if mesh is not None:
            mesh_lib.broadcast_state(model)
        if self.sharded:
            mesh_lib.shard_patterns(model, mesh)
        model.pattern_group = mesh.patterns if self.sharded else None

    def build_optimizer(self, steps_per_epoch: int, *, fit_prior: bool = False) -> None:
        """A fresh optimizer and schedule, over the prior alone when
        ``fit_prior``; ``fit`` calls this, callers that drive
        ``train_step`` themselves call it first."""
        self.optimizer, self.schedule = make_optimizer(self.config, self.model, steps_per_epoch,
                                                       prior_only=fit_prior)
        self.steps_per_epoch = steps_per_epoch
        self.fit_prior = fit_prior
        self._epochs = {}  # their graphs update the old optimizer's state

    # ------------------------------------------------------------- steps

    def _loss_fn(self, x: torch.Tensor):
        """``(loss, (recon_error, aux))`` for one normalized NHWC batch. In
        the prior phase aux holds the prior's bits too, and the backbone
        runs without autograd: its parameters take no update then."""
        if not self.fit_prior:
            x_recon, aux = self.model(x)
            recon_error = torch.mean((x_recon - x) ** 2)
            return recon_error + aux, (recon_error, aux)
        with torch.no_grad():
            x_recon, zq, aux = self.model.backbone(x)
            recon_error = torch.mean((x_recon - x) ** 2)
        aux = self.model.prior_bits(zq) + aux
        return recon_error + aux, (recon_error, aux)

    def train_step(self, x: torch.Tensor) -> dict:
        """Loss, backward, the gradients' reductions over the mesh, one Adam
        update and one schedule step. Returns the metrics ``loss``,
        ``recon_error`` and ``aux`` (means over the global batch) as 0-d
        tensors on the device (reading them waits for the step), and with
        ``watch_gradients`` the gradient norms and histograms.
        ``position``, ``(epoch, step)``, names the step in ``debug_nans``'
        error; ``fit`` sets it."""
        if self.optimizer is None:
            raise RuntimeError("no optimizer: call build_optimizer(steps_per_epoch) first (fit does)")
        out = self._step_core(x)
        self.schedule.step()
        return out

    def _step_core(self, x: torch.Tensor) -> dict:
        """One step's body, shared by ``train_step`` and ``epoch_step``: all
        of ``train_step`` but the schedule's step, which runs on the host."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, (recon_error, aux) = self._loss_fn(x)
        loss.backward()
        self._reduce_gradients()
        metrics = torch.stack([loss.detach(), recon_error.detach(), aux.detach()])
        if self.mesh is not None:
            self._all_reduce(metrics, self.mesh.data_group, mean=True)
        if self.debug_nans:
            self._check_finite(metrics[0], *self.position)
        out = dict(zip(("loss", "recon_error", "aux"), metrics.unbind()))
        if self.watch_gradients:
            out.update(self._gradient_stats())
        self.optimizer.step()
        return out

    def epoch_step(self, fit_prior: bool):
        """The whole-epoch step for data staged on the device (JAX's
        ``epoch_step``): returns ``run(data, rows)``, which trains one step
        for each row of the epoch's ``(K, B)`` index matrix ``rows`` (numpy)
        over the staged images ``data``, and returns each step's metrics
        stacked, ``{name: (K, ...)}`` tensors on the device.

        The matrix goes to the device once an epoch. A step's body reads its
        row through a step counter on the device, gathers the batch from
        ``data``, runs ``_step_core`` (loss, backward, Adam and, with
        ``watch_gradients``, the gradient stats), writes the metrics into
        row ``step`` of an epoch buffer and adds 1 to the counter; the
        schedule steps on the host after each step. On a CUDA device the
        first ``_EpochRun.WARMUP`` steps of a key run that body eagerly on a
        side stream (real steps, on the epoch's own batches); then the body
        is captured once in a CUDA graph, which replays for every later step
        of the key. A key is the phase, the batch shape, the steps an epoch,
        ``watch_gradients``, the staged data and the optimizer's parameters
        and learning-rate tensor, and its graph is kept across epochs and
        ``fit`` calls until the next ``build_optimizer``; where Adam's state
        was loaded anew since the capture (a resume), the key warms up and
        captures again. A failed capture or replay raises; nothing falls
        back to the eager step. On the CPU the body runs eagerly, step by
        step.

        ``fit_prior`` must be the optimizer's phase. ``debug_nans`` and a
        process group keep ``train_step``: the NaN check reads the host
        between the backward and the update, and a graph would have to hold
        NCCL's collectives."""
        if self.optimizer is None or fit_prior != self.fit_prior:
            raise RuntimeError(f"the optimizer is not built for fit_prior={fit_prior}: call build_optimizer first")
        if self.debug_nans or self.mesh is not None:
            raise RuntimeError("debug_nans and a process group train step by step (train_step)")
        return self._run_epoch

    def _run_epoch(self, data: torch.Tensor, rows: np.ndarray) -> dict:
        groups = self.optimizer.param_groups
        tensors = [p for g in groups for p in g["params"]] + [g["lr"] for g in groups if torch.is_tensor(g["lr"])]
        key = (self.fit_prior, tuple(data.shape), data.data_ptr(), rows.shape, self.watch_gradients,
               tuple(t.data_ptr() for t in tensors))
        run = self._epochs.get(key)
        if run is None:  # a graph of other parameters or rate would update stale ones: drop those
            self._epochs = {k: v for k, v in self._epochs.items() if k[-1] == key[-1]}
            run = self._epochs[key] = _EpochRun(self, data, *rows.shape)
        return run(rows)

    def _optimizer_state(self) -> tuple:
        """The addresses of Adam's state tensors (``load_state_dict``
        replaces them)."""
        return tuple(v.data_ptr() for st in self.optimizer.state.values() for v in st.values() if torch.is_tensor(v))

    # ------------------------------------------------------------- mesh

    def _all_reduce(self, t: torch.Tensor, group, mean: bool = False) -> None:
        dist.all_reduce(t, group=group)
        if mean:
            t /= dist.get_world_size(group)

    def _reduce_tensors(self, tensors: list, group, mean: bool = False) -> None:
        """Sum (or average) ``tensors`` in place over ``group``, in one
        flattened all-reduce."""
        if tensors:
            flat = _flatten_dense_tensors(tensors)
            self._all_reduce(flat, group, mean)
            for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
                t.copy_(r)

    def _reduce_gradients(self) -> None:
        """The folded tables' partial gradients summed over the model group
        (pattern sharding); then every gradient averaged over the data
        group. A shard's pattern gradient is complete, and so are those of
        ``norm_state`` and of each lookup's output bias, and everything
        upstream, whose ``dx`` the lookups sum."""
        if self.mesh is None:
            return
        named = [(n, p) for n, p in self.model.named_parameters() if p.grad is not None]
        if self.sharded:
            self._reduce_tensors([p.grad for n, p in named if n.split(".", 1)[0] in LAYERS
                                  and n.split(".", 1)[1] in FOLDED], self.mesh.model_group)
        self._reduce_tensors([p.grad for _, p in named], self.mesh.data_group, mean=True)

    # ------------------------------------------------------- debug aids

    def _watched_modules(self) -> dict:
        """The top-level modules the gradient stats cover: those with
        parameters, or in the prior phase the prior alone (the backbone's
        gradients are not computed then, where JAX's are)."""
        modules = {"prior": self.model.prior} if self.fit_prior else dict(self.model.named_children())
        return {k: m for k, m in modules.items() if any(True for _ in m.parameters())}

    def _full(self, mod, tensors) -> list:
        """``tensors``, one for each parameter of ``mod`` in order, with each
        pattern shard gathered into its full memory (a collective)."""
        return [mesh_lib.gather_rows(self.mesh, t) if self.sharded and n == "lookup_weights" else t
                for (n, _), t in zip(mod.named_parameters(), tensors)]

    def _gradient_stats(self) -> dict:
        """``grad_norm`` and each watched module's ``grad_norm/<k>`` and
        ``grad_hist/<k>`` on the device, as JAX's watched step; a gradient
        that was not computed counts as zeros, as JAX's of an unused
        parameter does."""
        out, total = {}, 0.0
        for k, mod in self._watched_modules().items():
            grads = self._full(mod, [p.grad if p.grad is not None else torch.zeros_like(p) for p in mod.parameters()])
            sq = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
            total = total + sq
            out[f"grad_norm/{k}"] = torch.sqrt(sq)
            out[f"grad_hist/{k}"] = log_magnitude_histogram(grads)
        return {"grad_norm": torch.sqrt(total), **out}

    def _param_histograms(self) -> dict:
        """Each top-level module's ``param_hist/<k>`` over its full parameters."""
        return {f"param_hist/{k}": param_histogram(self._full(mod, list(mod.parameters())))
                for k, mod in self.model.named_children() if any(True for _ in mod.parameters())}

    def _check_finite(self, loss: torch.Tensor, epoch: int, step: int) -> None:
        """``FloatingPointError`` (JAX's ``jax_debug_nans`` error) where the
        loss or a gradient is not finite, naming the modules whose
        gradients are not."""
        bad = [name for name, m in self.model.named_children()
               if (gs := [p.grad.reshape(-1) for p in m.parameters() if p.grad is not None])
               and not torch.isfinite(torch.cat(gs)).all()]
        if bad or not torch.isfinite(loss):
            raise FloatingPointError(f"a non-finite loss ({float(loss)}) or gradient at epoch {epoch}, step {step}; "
                                     f"modules whose gradients are not finite: {bad}")

    # ------------------------------------------------------------ epochs

    def _device_data(self, ds):
        """The dataset's images on the device, staged once per dataset, or
        None when it is not an in-memory array within the budget."""
        images = getattr(ds, "images", None)
        if not isinstance(images, np.ndarray) or images.nbytes > self.DEVICE_DATA_MAX_BYTES:
            return None
        if self._staged is None or self._staged[0] is not images:
            self._staged = (images, torch.from_numpy(np.asarray(images, np.float32)).to(self.device))
        return self._staged[1]

    def _local_slice(self):
        """This rank's part of every global batch under a mesh of more than
        one rank, else None."""
        return mesh_lib.process_batch_bounds(self.mesh, self.config.batch_size) if self.multi else None

    def epoch_rows(self, n: int, epoch: int) -> np.ndarray:
        """The epoch's ``(K, B)`` index matrix over ``n`` images, in the JAX
        order: shuffled by ``np.random.default_rng(seed + epoch)``,
        remainder dropped."""
        idx = np.arange(n)
        np.random.default_rng(self.config.seed + epoch).shuffle(idx)
        k = n // self.config.batch_size
        return idx[: k * self.config.batch_size].reshape(k, self.config.batch_size)

    def epoch_batches(self, ds, epoch: int):
        """The epoch's training batches on the device, in the JAX order
        (:meth:`epoch_rows`). An in-memory dataset within the budget is
        gathered on the device (one process); any other streams from the
        host, two batches read ahead, each rank reading its slice."""
        cfg = self.config
        data = None if self.multi else self._device_data(ds)
        if data is None:
            for bx, _ in iterate_batches(ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                                         drop_remainder=True, prefetch=2, local_slice=self._local_slice()):
                yield torch.from_numpy(bx).to(self.device)
            return
        for row in torch.from_numpy(self.epoch_rows(len(ds), epoch)).to(self.device):
            yield data[row]

    def _train_epoch(self, ds, epoch: int) -> dict:
        """One epoch's steps, ``{name: (K, ...)}`` metrics on the device:
        data staged on the device in a process without a group goes through
        ``epoch_step`` (JAX's choice in its ``fit``); ``debug_nans``,
        streamed data and process groups run ``train_step`` step by step."""
        data = self._device_data(ds) if self.mesh is None and not self.debug_nans else None
        rows = self.epoch_rows(len(ds), epoch)
        if data is not None and len(rows):
            return self.epoch_step(self.fit_prior)(data, rows)
        steps = []
        for i, x in enumerate(self.epoch_batches(ds, epoch)):
            self.position = (epoch, i)
            steps.append(self.train_step(x))
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]} if steps else {}

    def fit(self, train_ds, test_ds, *, epochs: int | None = None, out_dir: str = "outputs",
            eval_every: int = 5, save_every: int = 5, start_epoch: int = 0, resume: bool = False) -> None:
        """Train in place. ``eval_every`` / ``save_every`` = 0 turn eval and
        checkpoints off (the final-epoch save too); a positive period keeps
        the reference's modulo quirk. ``resume`` restores the model, the
        optimizer and the next epoch from ``out_dir``."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
        logger = MetricLogger(out_dir, primary=self.rank == 0)
        has_prior = prior_has_parameters(cfg)
        if resume:
            start_epoch = self._try_resume(out_dir, start_epoch)
        fit_prior = start_epoch > cfg.prior_start and has_prior
        if self.optimizer is None or self.steps_per_epoch != steps_per_epoch or self.fit_prior != fit_prior:
            self.build_optimizer(steps_per_epoch, fit_prior=fit_prior)
        if resume and start_epoch > 0:
            self._try_resume_opt(out_dir)

        try:
            for epoch in range(start_epoch, epochs):
                if epoch > cfg.prior_start and has_prior and not self.fit_prior:
                    # the phase switch: a fresh optimizer and schedule over the prior
                    self.build_optimizer(steps_per_epoch, fit_prior=True)
                t_epoch = time.perf_counter()
                parts = self._train_epoch(train_ds, epoch)
                base = {"epoch": epoch, "fit_prior": self.fit_prior}
                if self.watch_gradients:
                    base.update(self._param_histograms())
                self._log_async(logger, base, parts, len(train_ds), cfg.batch_size, t_epoch)
                if eval_every and not epoch % eval_every:
                    self.evaluate(test_ds, epoch=epoch, logger=logger, out_dir=out_dir)
                if save_every and (not epoch % save_every or epoch == epochs - 1):
                    self.save(epoch, out_dir)
        except BaseException:
            self._drain_log_worker(reraise=False)
            raise
        self._drain_log_worker()

    # ------------------------------------------------- async metric logging

    def _log_async(self, logger, base: dict, parts: dict, n_data: int, batch_size: int, t_start: float) -> None:
        """Queue the epoch's record to the logging thread (JAX's
        ``_log_async``), which the first call starts. On the card the
        metrics are copied into pinned host memory behind the epoch's steps
        and an event is recorded after them; the thread waits for that event,
        so ``epoch_seconds`` ends where the epoch's work ends on the device,
        while this thread goes on to the next epoch. Only rank 0's logger
        writes."""
        event = None
        if any(v.is_cuda for v in parts.values()):
            parts = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
                     for k, v in parts.items()}
            event = torch.cuda.Event()
            event.record()
        if self._log is None:
            self._log = {"queue": queue.Queue(maxsize=4), "errors": []}
            self._log["thread"] = threading.Thread(target=self._log_worker, args=(self._log,), name=LOG_THREAD,
                                                   daemon=True)
            self._log["thread"].start()
        self._log["queue"].put((logger, base, parts, event, n_data, batch_size, t_start))

    def _log_worker(self, log: dict) -> None:
        """The logging thread: each epoch's record, in order, until ``None``.
        An epoch's time runs from its start, or from the last epoch's
        completion where that came later (the epochs overlap on the host),
        to its own completion, as in JAX's."""
        last = None
        while (item := log["queue"].get()) is not None:
            logger, base, parts, event, n_data, batch_size, t_start = item
            try:
                if event is not None:
                    event.synchronize()
                done = time.perf_counter()
                self._write_epoch_record(logger, base, parts, n_data, batch_size,
                                         t_start if last is None else max(t_start, last), t_done=done)
                last = done
            except Exception as e:  # re-raised by _drain_log_worker
                log["errors"].append(e)

    def _drain_log_worker(self, reraise: bool = True) -> None:
        """Join the logging thread after the records queued so far; with
        ``reraise``, raise its first error. The next ``fit`` starts a new
        one."""
        if self._log is None:
            return
        log, self._log = self._log, None
        log["queue"].put(None)
        log["thread"].join()
        if reraise and log["errors"]:
            raise log["errors"][0]

    @staticmethod
    def _write_epoch_record(logger, base: dict, parts: dict, n_data: int, batch_size: int, t_start: float, *,
                            t_done: float | None = None) -> dict:
        """The epoch's JSONL record from its steps' metrics, each stacked over
        the steps, ``parts = {name: (K, ...)}``. Keeps the reference's quirk:
        "Train Reconstruction Error" is the sum of the per-step means of
        recon_error and aux over ``len(dataset)``. As in JAX's record,
        ``grad_hist/*`` are summed over the steps (int64) and
        ``grad_norm*`` averaged. The epoch's time runs from ``t_start`` to
        ``t_done`` (by default, once its metrics are fetched)."""
        record = dict(base)
        n_batches = len(next(iter(parts.values()))) if parts else 0
        epoch_sum = 0.0
        for k, v in parts.items():
            if k == "loss":
                continue
            arr = v.cpu().numpy()
            if k in ("recon_error", "aux"):  # recon_error, then aux, as the JAX record sums them
                epoch_sum += float(arr.astype(np.float64).sum())
            elif k.startswith("grad_hist"):
                record[k] = arr.astype(np.int64).sum(axis=0).tolist()
            elif k.startswith("grad_norm"):
                record[k] = float(arr.astype(np.float64).sum()) / n_batches
        elapsed = (time.perf_counter() if t_done is None else t_done) - t_start
        record.update({
            "Train Reconstruction Error": epoch_sum / n_data,
            "train_loss_per_batch": epoch_sum / max(n_batches, 1),
            "epoch_seconds": elapsed,
            "steps_per_sec": n_batches / max(elapsed, 1e-9),
            "images_per_sec": n_batches * batch_size / max(elapsed, 1e-9),
        })
        logger.log(record, step=base["epoch"])
        return record

    # -------------------------------------------------------------- eval

    @torch.inference_mode()
    def evaluate(self, test_ds, *, epoch: int = 0, logger: MetricLogger | None = None, out_dir: str | None = None,
                 n_sample_images: int = 16) -> float:
        """Recon-MSE sweep over ``test_ds`` in order, ragged last batch
        kept: "Test Reconstruction Error" = sum of the per-batch MSEs over
        ``len(test_ds)``, with one fetch at the end. With ``out_dir`` it
        also writes the grids of JAX's ``evaluate`` there, each of at most
        ``n_sample_images`` images: ``samples`` (drawn with the seed
        ``seed + epoch``), ``inputs`` and ``reconstructions`` of the last
        batch, ``interpolations`` of the second test batch with the first
        (when both have one shape), and those two batches as ``test_Y``
        and ``test_Z``.

        Under a mesh of more than one rank each rank sweeps its slice of
        every batch, the ragged last batch dropped (as JAX's multi-process
        sweep), the batch MSEs are averaged over the data group, and the
        grids gathered over it; only rank 0 writes. Every rank must call
        this: the sharded lookups and the gathers are collectives."""
        cfg, model = self.config, self.model
        mses, first, last = [], [], None
        for bx, _ in iterate_batches(test_ds, cfg.batch_size, shuffle=False, drop_remainder=self.multi,
                                     local_slice=self._local_slice()):
            x = torch.from_numpy(bx).to(self.device)
            x_recon, _ = model(x)
            mses.append(torch.mean((x_recon - x) ** 2))
            if len(first) < 2:
                first.append(x)
            last = (x, x_recon)
        total = 0.0
        if mses:
            mses = torch.stack(mses)
            if self.mesh is not None:
                self._all_reduce(mses, self.mesh.data_group, mean=True)
            total = float(mses.cpu().numpy().astype(np.float64).sum())
        err = total / len(test_ds)
        if out_dir is not None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed + epoch)
            grids = {"samples": model.sample(n_sample_images, generator=gen)}
            local = {}
            if last is not None:
                local["inputs"], local["reconstructions"] = last
            if len(first) == 2:
                if first[0].shape == first[1].shape:
                    local["interpolations"] = model.interpolate(first[1], first[0])
                local["test_Y"], local["test_Z"] = first
            grids.update({k: self._gather_batch(v) for k, v in local.items()})
            if self.rank == 0:
                for name, images in grids.items():
                    save_image_grid(os.path.join(out_dir, f"epoch{epoch:04d}_{name}.png"),
                                    denormalize(images[:n_sample_images].cpu().numpy(), cfg.data_set))
        if logger is not None:
            logger.log({"Test Reconstruction Error": err, "epoch": epoch}, step=epoch)
        return err

    def _gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of this rank's slice ``t``, in data order."""
        if not self.multi or self.mesh.n_data == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.mesh.n_data)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.data_group)
        return torch.cat(parts)

    # ------------------------------------------------------------- ckpts

    def checkpoint_path(self, out_dir: str) -> str:
        return os.path.join(out_dir, f"{self.config.data_set}-{self.config.image_size}.pt")

    def _pattern_slots(self) -> list[int]:
        """The optimizer's state indices of the pattern memories."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        layers = {id(getattr(self.model, n).lookup_weights) for n in LAYERS}
        return [i for i, p in enumerate(params) if id(p) in layers]

    def _moments(self, opt: dict, fn) -> dict:
        """``opt`` (an optimizer state dict) with ``fn`` applied to the Adam
        moments of the pattern memories."""
        state = dict(opt["state"])
        for i in self._pattern_slots():
            if i in state:
                state[i] = {k: fn(v) if k in ("exp_avg", "exp_avg_sq") else v for k, v in state[i].items()}
        return {**opt, "state": state}

    def save(self, epoch: int, out_dir: str) -> None:
        """Model, optimizer and schedule state, the optimizer's phase and
        the epoch, written to a temporary file and renamed into place.
        Under pattern sharding the memories and their Adam moments are
        gathered first (every rank enters); only rank 0 writes."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.sharded:
            model = {k: mesh_lib.gather_rows(self.mesh, v) if k in PATTERNS else v for k, v in model.items()}
            opt = self._moments(opt, lambda v: mesh_lib.gather_rows(self.mesh, v))
        if self.rank != 0:
            return
        os.makedirs(out_dir, exist_ok=True)
        path = self.checkpoint_path(out_dir)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save({
            "model": model,
            "optimizer": opt,
            "schedule": self.schedule.state_dict(),
            "fit_prior": self.fit_prior,
            "epoch": int(epoch),
        }, tmp)
        os.replace(tmp, path)

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full pattern memory (or of its moments)."""
        return t[mesh_lib.pattern_rows(self.mesh, t.shape[0])] if self.sharded else t

    def _load(self, out_dir: str):
        """The checkpoint in ``out_dir``, on the host: ``load_state_dict``
        moves each tensor to its parameter's device, and Adam keeps its step
        counts on the host, as a fresh Adam does (on the card they would
        cost a device sync per parameter per step)."""
        path = self.checkpoint_path(out_dir)
        return torch.load(path, map_location="cpu") if os.path.exists(path) else None

    def _try_resume(self, out_dir: str, start_epoch: int) -> int:
        """Restore the model from ``out_dir``; returns the next epoch."""
        ckpt = self._load(out_dir)
        if ckpt is None:
            return start_epoch
        self.model.load_state_dict({k: self._rows(v) if k in PATTERNS else v for k, v in ckpt["model"].items()})
        return ckpt["epoch"] + 1

    def _try_resume_opt(self, out_dir: str) -> None:
        """Restore the optimizer and the schedule's step from ``out_dir``,
        unless they belong to the other phase: then the fresh optimizer
        stays, as in the JAX package."""
        ckpt = self._load(out_dir)
        if ckpt is not None and ckpt.get("fit_prior", False) != self.fit_prior:
            print(
                f"warning: the optimizer in {self.checkpoint_path(out_dir)} belongs to the "
                f"{'prior' if ckpt.get('fit_prior') else 'backbone'} phase; starting with a fresh optimizer",
                file=sys.stderr,
            )
        elif ckpt is not None:
            self.optimizer.load_state_dict(self._moments(ckpt["optimizer"], self._rows))
            self.schedule.load_state_dict(ckpt["schedule"])
            if self.optimizer.param_groups[0]["params"][0].is_cuda:
                _keep_capturable(self.optimizer)


class _EpochRun:
    """``Trainer.epoch_step``'s state for one key: the static index matrix,
    the step counter, the epoch's metric buffers and, on the card, the
    step's CUDA graph with the kernels its capture recorded."""

    WARMUP = 2  # eager steps of a key before its capture, over one epoch or more

    def __init__(self, trainer: Trainer, data: torch.Tensor, k: int, b: int):
        self.trainer, self.data = trainer, data
        self.rows = torch.zeros(k, b, dtype=torch.int64, device=data.device)
        self.step = torch.zeros(1, dtype=torch.int64, device=data.device)
        self.metrics = None  # {name: (K, ...)}, made by the first step
        self.graph = None
        self.launches = {}  # {kernel wrapper: launches} of one replay
        self.state = None  # the addresses of Adam's state the graph updates
        self.warm = 0  # warm-up steps run since the last capture was dropped
        self.side = torch.cuda.Stream() if data.is_cuda else None  # the warm-up's stream

    def body(self) -> None:
        """Step ``self.step`` of the epoch, all on the device."""
        x = self.data.index_select(0, self.rows.index_select(0, self.step)[0])
        out = self.trainer._step_core(x)
        if self.metrics is None:
            self.metrics = {k: torch.empty(len(self.rows), *v.shape, dtype=v.dtype, device=v.device)
                            for k, v in out.items()}
        for k, v in out.items():
            self.metrics[k].index_copy_(0, self.step, v[None])
        self.step.add_(1)

    def __call__(self, rows: np.ndarray) -> dict:
        tr, k = self.trainer, len(rows)
        cuda = self.rows.is_cuda
        host = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
        self.rows.copy_(host.pin_memory() if cuda else host, non_blocking=cuda)
        self.step.zero_()
        if self.graph is not None and tr._optimizer_state() != self.state:
            self.graph, self.warm = None, 0  # Adam's state was loaded anew: warm up and capture again
        if not cuda:
            eager = k
        else:  # the warm-up, until this key has run WARMUP steps
            eager = min(self.WARMUP - self.warm, k) if self.graph is None else 0
        if eager:
            with _side_stream(self.side) if cuda else contextlib.nullcontext():
                for _ in range(eager):
                    self.body()
                    tr.schedule.step()
            self.warm += eager
        if cuda and self.graph is None and eager < k:
            self.capture()
        lr = tr.optimizer.param_groups[0]["lr"]
        for _ in range(eager, k):
            self.graph.replay()
            add_launches(self.launches)
            tr.schedule.step()
        if tr.optimizer.param_groups[0]["lr"] is not lr:
            raise RuntimeError("the schedule replaced the learning-rate tensor that the graph reads")
        return {name: buf.clone() for name, buf in self.metrics.items()}

    def capture(self) -> None:
        """Record the body in a CUDA graph (in a memory pool of its own): the
        gradients are None before it, so the backward makes them in the
        graph's pool, where every replay writes them again. The capture
        forbids unsafe CUDA calls on its own thread only: ``fit``'s logging
        thread may wait on the last epoch's event meanwhile, which a capture
        in CUDA's global mode would take for an error and invalidate."""
        self.trainer.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with collector_held(), captured_launches() as tally, torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.body()
        self.graph, self.launches, self.state = graph, tally, self.trainer._optimizer_state()
        self.trainer.captures += 1


@contextlib.contextmanager
def _side_stream(side: torch.cuda.Stream):
    """Work on ``side`` that starts after, and ends before, the current
    stream's next work (PyTorch's warm-up before a capture)."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream().wait_stream(side)


def load_weights(model: HopVAE, path: str) -> None:
    """Warm start from a checkpoint that must exist: the JAX package's
    native ``.msgpack``, this trainer's ``.pt`` or the reference's torch
    ``state_dict``, through ``load_reference_checkpoint``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    load_reference_checkpoint(model, path)


def train_golden(checkpoint_dir: str, device=None, impl: str = "cuda") -> tuple[list, dict, HopVAE]:
    """The train golden of ``TRAIN_GOLDEN``: the trained MNIST backbone on
    the 64 committed digits, f32 conv stacks, Adam at a constant learning
    rate. Returns the loss of each step (step k's loss is taken after k
    updates), the global gradient norm of each top-level module at step
    0, and the trained model."""
    spec = TRAIN_GOLDEN
    config = load_config(spec["config"])
    config.learning_rate, config.gamma = spec["learning_rate"], 1.0
    model = HopVAE(config, impl=impl, device=device)
    model.load_state_dict(state_from_checkpoint(os.path.join(checkpoint_dir, spec["checkpoint"])))
    trainer = Trainer(model, config)
    trainer.build_optimizer(1)
    x = torch.from_numpy(golden_input("mnist_digits")).to(model.device)
    losses, norms = [], {}
    for step in range(len(spec["losses"])):
        losses.append(float(trainer.train_step(x)["loss"]))
        if step == 0:  # the gradients stay on the parameters until the next step
            norms = {
                name: float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in getattr(model, name).parameters())))
                for name in spec["grad_norms"]
            }
    return losses, norms, model


def prior_train_golden(checkpoint_dir: str, device=None, impl: str = "cuda",
                       gold: dict = PRIOR_TRAIN_GOLDEN) -> tuple[list, float, HopVAE]:
    """A prior-train golden: ``PRIOR_TRAIN_GOLDEN`` (ffhq_64_scaled with the
    Transformer prior of ``Transformer-FFHQ-64.msgpack`` on the
    ``ffhq64_synthetic4`` batch) or ``PIXELCNN_TRAIN_GOLDEN`` (the PixelCNN
    anchor on the 64 golden digits): f32, prior-only Adam at a constant
    learning rate. Returns the loss of each step (step k's is taken after
    k updates), the global norm of the prior's gradient at step 0, and the
    trained model."""
    config = load_config(gold["config"])
    config.prior = gold["prior"]
    config.learning_rate, config.gamma = gold["learning_rate"], 1.0
    model = HopVAE(config, impl=impl, device=device)
    model.load_state_dict(state_from_checkpoint(os.path.join(checkpoint_dir, gold["checkpoint"])))
    trainer = Trainer(model, config)
    trainer.build_optimizer(1, fit_prior=True)
    x = torch.from_numpy(golden_input(gold["input"])).to(model.device)
    losses, norm = [], None
    for step in range(len(gold["losses"])):
        losses.append(float(trainer.train_step(x)["loss"]))
        if step == 0:
            norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.prior.parameters())))
    return losses, norm, model


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train HopVAE (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="mnist_28")
    parser.add_argument("--data", type=str, default=None, help="dataset root")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--out", type=str, default="outputs")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="weights to start from, loaded leniently: the reference's torch .ckpt, a JAX "
                             ".msgpack or this trainer's .pt (default: checkpoints/<DATA>-<size>.ckpt where it "
                             "exists)")
    parser.add_argument("--production", action="store_true",
                        help="bf16 conv stacks (the streaming kernels are the default already)")
    parser.add_argument("--impl", type=str, default="cuda", choices=("cuda", "torch"),
                        help="cuda: the streaming kernels (f32-exact); torch: the eager lookups")
    parser.add_argument("--compute-dtype", type=str, default=None, choices=("float32", "bfloat16"),
                        help="conv-stack compute dtype (default float32, bfloat16 with --production)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config key (repeatable), e.g. --set batch_size=64")
    parser.add_argument("--resume", action="store_true", help="resume model, optimizer and epoch from --out")
    parser.add_argument("--eval-only", action="store_true", help="run one evaluation pass and exit")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    parser.add_argument("--profile", action="store_true", help="write a torch.profiler trace of the run to <out>/trace")
    parser.add_argument("--debug-nans", action="store_true",
                        help="raise FloatingPointError at the first step whose loss or a gradient is not finite")
    parser.add_argument("--watch-grads", action="store_true",
                        help="log gradient norms and log-magnitude histograms of gradients and parameters per epoch "
                             "(the reference's wandb.watch(log='all'))")
    args = parser.parse_args(argv)

    if args.checkpoint and not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")
    config = load_config(args.config)
    try:
        apply_overrides(config, args.set, config_name=args.config)
    except ValueError as e:
        parser.error(str(e))
    compute = args.compute_dtype or ("bfloat16" if args.production else "float32")
    # under torchrun: one data-parallel rank of the group its environment names
    distributed = "WORLD_SIZE" in os.environ
    device = mesh_lib.init_distributed(args.device) if distributed else resolve_device(args.device)
    try:
        torch.manual_seed(config.seed)
        model = HopVAE(config, impl=args.impl, compute_dtype=torch.bfloat16 if compute == "bfloat16" else None,
                       device=device)
        # the reference's default location, skipped where absent (an explicit
        # --checkpoint was checked above)
        load_reference_checkpoint(model, args.checkpoint or f"checkpoints/{config.data_set}-{config.image_size}.ckpt")

        train_ds, _val_ds, test_ds = get_datasets(config, args.data)
        trainer = Trainer(model, config, mesh_lib.make_mesh() if distributed else None)
        trainer.watch_gradients, trainer.debug_nans = args.watch_grads, args.debug_nans
        if args.eval_only:
            err = trainer.evaluate(test_ds, out_dir=args.out)
            if trainer.rank == 0:
                print(f"Test Reconstruction Error: {err:.6f}")
            return
        with profiled(args.out, args.profile, cuda=model.device.type == "cuda"):
            trainer.fit(train_ds, test_ds, epochs=args.epochs, out_dir=args.out, resume=args.resume)
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
