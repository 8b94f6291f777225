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
  under ``<out>/trace``. ``--debug-nans`` (``Trainer.debug_nans``): the
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

The step runs eagerly: the forward under autograd, the backward through
the streaming kernels (``impl="cuda"``) or the eager lookups
(``impl="torch"``), the Transformer prior's attention through the flash
kernels on the card, the PixelCNN prior's convs through cuDNN in full
f32. Not ported yet (``ROADMAP.md``): CUDA graphs for the step.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
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
from hopvae_torch.utils.metrics import MetricLogger, denormalize, save_image_grid

# --watch-grads' histograms: 16 unit bins of log10|v| over [-12, 4), the last
# closed and values outside dropped (np.histogram's rule), as JAX's
HIST_BINS = 16
HIST_RANGE = (-12.0, 4.0)
# the folded tables' replicated parameters, which a pattern shard reaches
# only through its own rows of K and U (fold_layer): partial gradients
FOLDED = ("norm_stored.weight", "norm_stored.bias", "norm_proj.weight", "norm_proj.bias", "in_proj.weight",
          "in_proj.bias", "out_proj.weight")
PATTERNS = tuple(f"{name}.lookup_weights" for name in LAYERS)


def log_magnitude_histogram(tensors) -> torch.Tensor:
    """``(HIST_BINS,)`` int64 counts of ``log10(|v| + 1e-12)`` over the
    values of ``tensors`` (f32), on their device: JAX's
    ``_log_magnitude_histogram``, counted exactly."""
    v = torch.log10(torch.cat([t.detach().float().reshape(-1) for t in tensors]).abs() + 1e-12)
    lo, hi = HIST_RANGE
    v = v[(v >= lo) & (v <= hi)]
    edges = torch.linspace(lo, hi, HIST_BINS + 1, device=v.device)
    idx = (torch.bucketize(v, edges, right=True) - 1).clamp_(max=HIST_BINS - 1)
    return torch.bincount(idx, minlength=HIST_BINS)


def param_histogram(tensors) -> list[int]:
    """The epoch record's ``param_hist``: JAX's numpy histogram on the host."""
    flat = np.concatenate([t.detach().cpu().float().numpy().ravel() for t in tensors])
    return np.histogram(np.log10(np.abs(flat) + 1e-12), bins=HIST_BINS, range=HIST_RANGE)[0].tolist()


@contextlib.contextmanager
def profiled(out_dir: str, enabled: bool = True, cuda: bool = True):
    """A ``torch.profiler`` trace of the block (CPU and, with ``cuda``, CUDA
    activity), written as Chrome trace JSON to
    ``<out_dir>/trace/rank<r>.trace.json`` when the block ends, as JAX
    stops its trace, also on an exception. Yields the profiler, or None
    when not ``enabled``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(os.path.join(out_dir, "trace"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace", f"rank{rank}.trace.json"))


def prior_has_parameters(config) -> bool:
    """Whether the config's prior is trained in a phase of its own (the
    JAX package switches to it at ``epoch > prior_start``)."""
    if config.prior in ("None", None):
        return False
    if config.prior in ("PixelCNN", "Transformer"):
        return True
    raise ValueError(f"unknown prior {config.prior!r}")


def make_optimizer(config, model: torch.nn.Module, steps_per_epoch: int, *, prior_only: bool = False):
    """``(Adam, schedule)`` over the parameters of ``model``, or with
    ``prior_only`` over those of ``model.prior`` alone: the learning rate
    at optimizer step ``k`` is ``learning_rate * gamma ** (k //
    steps_per_epoch)``, the value of ``optax.exponential_decay(staircase=
    True)`` at update ``k``. Step the schedule after each optimizer step.
    A prior without parameters raises ``ValueError`` under ``prior_only``."""
    if prior_only:
        model = model.prior
        if not any(True for _ in model.parameters()):
            raise ValueError(f"the prior {type(model).__name__} has no parameters to train")
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    per_epoch, gamma = max(steps_per_epoch, 1), config.gamma
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: gamma ** (step // per_epoch))
    return optimizer, schedule


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
        self._staged = None  # (host images, device copy)
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
        self.schedule.step()
        return out

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

    def epoch_batches(self, ds, epoch: int):
        """The epoch's training batches on the device, in the JAX order:
        shuffled by ``np.random.default_rng(seed + epoch)``, remainder
        dropped. An in-memory dataset within the budget is gathered on the
        device (one process); any other streams from the host, two
        batches read ahead, each rank reading its slice."""
        cfg = self.config
        data = None if self.multi else self._device_data(ds)
        if data is None:
            for bx, _ in iterate_batches(ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                                         drop_remainder=True, prefetch=2, local_slice=self._local_slice()):
                yield torch.from_numpy(bx).to(self.device)
            return
        idx = np.arange(len(ds))
        np.random.default_rng(cfg.seed + epoch).shuffle(idx)
        n_batches = len(idx) // cfg.batch_size
        rows = torch.from_numpy(idx[: n_batches * cfg.batch_size].reshape(n_batches, cfg.batch_size))
        for row in rows.to(self.device):
            yield data[row]

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

        for epoch in range(start_epoch, epochs):
            if epoch > cfg.prior_start and has_prior and not self.fit_prior:
                # the phase switch: a fresh optimizer and schedule over the prior
                self.build_optimizer(steps_per_epoch, fit_prior=True)
            t_epoch = time.perf_counter()
            parts = []
            for i, x in enumerate(self.epoch_batches(train_ds, epoch)):
                self.position = (epoch, i)
                parts.append(self.train_step(x))
            base = {"epoch": epoch, "fit_prior": self.fit_prior}
            if self.watch_gradients:
                base.update(self._param_histograms())
            self._write_epoch_record(logger, base, parts, len(train_ds), cfg.batch_size, t_epoch)
            if eval_every and not epoch % eval_every:
                self.evaluate(test_ds, epoch=epoch, logger=logger, out_dir=out_dir)
            if save_every and (not epoch % save_every or epoch == epochs - 1):
                self.save(epoch, out_dir)

    @staticmethod
    def _write_epoch_record(logger, base: dict, parts: list, n_data: int, batch_size: int,
                            t_start: float) -> dict:
        """The epoch's JSONL record from its steps' metrics, a fetch from
        the device for each. Keeps the reference's quirk: "Train
        Reconstruction Error" is the sum of the per-step means of
        recon_error and aux over ``len(dataset)``. As in JAX's record,
        ``grad_hist/*`` are summed over the steps (int64) and
        ``grad_norm*`` averaged."""
        record = dict(base)
        n_batches = len(parts)
        epoch_sum = 0.0
        for k in parts[0] if parts else ():
            if k == "loss":
                continue
            arr = torch.stack([p[k] for p in parts]).cpu().numpy()
            if k in ("recon_error", "aux"):  # recon_error, then aux, as the JAX record sums them
                epoch_sum += float(arr.astype(np.float64).sum())
            elif k.startswith("grad_hist"):
                record[k] = arr.astype(np.int64).sum(axis=0).tolist()
            elif k.startswith("grad_norm"):
                record[k] = float(arr.astype(np.float64).sum()) / n_batches
        elapsed = time.perf_counter() - t_start
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
