"""Training driver for the port (counterpart of ``hopvae_tpu/train.py``).

    python -m hopvae_torch.train --config ffhq_64_scaled --production   # on the card
    python -m hopvae_torch.train --config mnist_28 --device cpu --impl torch
    python -m hopvae_torch.train --config ffhq_64_scaled --production \
        --set prior=Transformer --set prior_start=-1 \
        --checkpoint checkpoints/Transformer-FFHQ-64.msgpack      # the prior phase

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

The step runs eagerly: the forward under autograd, the backward through
the streaming kernels (``impl="cuda"``) or the eager lookups
(``impl="torch"``), the prior's attention through the flash kernels on
the card. Not ported yet (``ROADMAP.md``): the PixelCNN prior, the sample
and interpolation grids of ``evaluate``, gradient watching, profiling,
multi-GPU and CUDA graphs for the step.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.data import (PRIOR_GOLDENS, PRIOR_TRAIN_GOLDEN, TRAIN_GOLDEN, get_datasets, golden_input,
                               iterate_batches)
from hopvae_torch.models.hopvae import HopVAE, resolve_device
from hopvae_torch.models.priors import PIXELCNN_NOT_PORTED
from hopvae_torch.serving import state_from_checkpoint
from hopvae_torch.utils.metrics import MetricLogger


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
    True)`` at update ``k``. Step the schedule after each optimizer step."""
    if prior_only:
        if model.prior is None:
            raise NotImplementedError(PIXELCNN_NOT_PORTED)
        model = model.prior
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    per_epoch, gamma = max(steps_per_epoch, 1), config.gamma
    schedule = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: gamma ** (step // per_epoch))
    return optimizer, schedule


class Trainer:
    """Trains a :class:`HopVAE` in place on the model's device."""

    # datasets up to this many bytes are staged on the device once and
    # gathered there per batch; larger ones stream from the host
    DEVICE_DATA_MAX_BYTES = 1 << 30

    def __init__(self, model: HopVAE, config):
        self.model = model
        self.config = config
        self.device = model.device
        self.optimizer = self.schedule = None
        self.steps_per_epoch = None
        self.fit_prior = False  # the phase of the optimizer
        self._staged = None  # (host images, device copy)

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
        """Loss, backward, one Adam update and one schedule step. Returns
        the metrics ``loss``, ``recon_error`` and ``aux`` as 0-d tensors on
        the device (reading them waits for the step)."""
        if self.optimizer is None:
            raise RuntimeError("no optimizer: call build_optimizer(steps_per_epoch) first (fit does)")
        self.optimizer.zero_grad(set_to_none=True)
        loss, (recon_error, aux) = self._loss_fn(x)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return {"loss": loss.detach(), "recon_error": recon_error.detach(), "aux": aux.detach()}

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

    def epoch_batches(self, ds, epoch: int):
        """The epoch's training batches on the device, in the JAX order:
        shuffled by ``np.random.default_rng(seed + epoch)``, remainder
        dropped."""
        cfg = self.config
        data = self._device_data(ds)
        if data is None:
            for bx, _ in iterate_batches(ds, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                                         drop_remainder=True):
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
        logger = MetricLogger(out_dir)
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
            parts = [self.train_step(x) for x in self.epoch_batches(train_ds, epoch)]
            self._write_epoch_record(
                logger, {"epoch": epoch, "fit_prior": self.fit_prior}, parts, len(train_ds), cfg.batch_size,
                t_epoch,
            )
            if eval_every and not epoch % eval_every:
                self.evaluate(test_ds, epoch=epoch, logger=logger)
            if save_every and (not epoch % save_every or epoch == epochs - 1):
                self.save(epoch, out_dir)

    @staticmethod
    def _write_epoch_record(logger, base: dict, parts: list, n_data: int, batch_size: int,
                            t_start: float) -> dict:
        """The epoch's JSONL record from its steps' metrics, with one fetch
        from the device. Keeps the reference's quirk: "Train Reconstruction
        Error" is the sum of the per-step means of recon_error and aux over
        ``len(dataset)``."""
        record = dict(base)
        n_batches = len(parts)
        epoch_sum = 0.0
        if parts:
            steps = torch.stack([torch.stack((p["recon_error"], p["aux"])) for p in parts]).cpu().numpy()
            for col in steps.T.astype(np.float64):  # recon_error, then aux, as the JAX record sums them
                epoch_sum += float(col.sum())
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
    def evaluate(self, test_ds, *, epoch: int = 0, logger: MetricLogger | None = None) -> float:
        """Recon-MSE sweep over ``test_ds`` in order, ragged last batch
        kept: "Test Reconstruction Error" = sum of the per-batch MSEs over
        ``len(test_ds)``, with one fetch at the end."""
        mses = []
        for bx, _ in iterate_batches(test_ds, self.config.batch_size, shuffle=False):
            x = torch.from_numpy(bx).to(self.device)
            x_recon, _ = self.model(x)
            mses.append(torch.mean((x_recon - x) ** 2))
        total = float(torch.stack(mses).cpu().numpy().astype(np.float64).sum()) if mses else 0.0
        err = total / len(test_ds)
        if logger is not None:
            logger.log({"Test Reconstruction Error": err, "epoch": epoch}, step=epoch)
        return err

    # ------------------------------------------------------------- ckpts

    def checkpoint_path(self, out_dir: str) -> str:
        return os.path.join(out_dir, f"{self.config.data_set}-{self.config.image_size}.pt")

    def save(self, epoch: int, out_dir: str) -> None:
        """Model, optimizer and schedule state, the optimizer's phase and
        the epoch, written to a temporary file and renamed into place."""
        os.makedirs(out_dir, exist_ok=True)
        path = self.checkpoint_path(out_dir)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "fit_prior": self.fit_prior,
            "epoch": int(epoch),
        }, tmp)
        os.replace(tmp, path)

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
        self.model.load_state_dict(ckpt["model"])
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
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self.schedule.load_state_dict(ckpt["schedule"])


def load_weights(model: HopVAE, path: str) -> None:
    """Warm start: the JAX package's native ``.msgpack`` or this trainer's
    ``.pt`` checkpoint."""
    if path.endswith(".msgpack"):
        state = state_from_checkpoint(path)
    else:
        state = torch.load(path, map_location=model.device)["model"]
    model.load_state_dict(state)


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


def prior_train_golden(checkpoint_dir: str, device=None, impl: str = "cuda") -> tuple[list, float, HopVAE]:
    """The prior-train golden of ``PRIOR_TRAIN_GOLDEN``: ffhq_64_scaled with
    the Transformer prior of ``PRIOR_GOLDENS``' checkpoint on the
    ``ffhq64_synthetic4`` batch, f32, prior-only Adam at a constant
    learning rate. Returns the loss of each step (step k's is taken after
    k updates), the global norm of the prior's gradient at step 0, and the
    trained model."""
    spec, gold = PRIOR_GOLDENS, PRIOR_TRAIN_GOLDEN
    config = load_config(spec["config"])
    config.prior = spec["prior"]
    config.learning_rate, config.gamma = gold["learning_rate"], 1.0
    model = HopVAE(config, impl=impl, device=device)
    model.load_state_dict(state_from_checkpoint(os.path.join(checkpoint_dir, spec["checkpoint"])))
    trainer = Trainer(model, config)
    trainer.build_optimizer(1, fit_prior=True)
    x = torch.from_numpy(golden_input("ffhq64_synthetic4")).to(model.device)
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
                        help="weights to start from: a JAX .msgpack or this trainer's .pt")
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
    args = parser.parse_args(argv)

    if args.checkpoint and not os.path.exists(args.checkpoint):
        parser.error(f"checkpoint not found: {args.checkpoint}")
    config = load_config(args.config)
    try:
        apply_overrides(config, args.set, config_name=args.config)
    except ValueError as e:
        parser.error(str(e))
    compute = args.compute_dtype or ("bfloat16" if args.production else "float32")
    device = resolve_device(args.device)
    torch.manual_seed(config.seed)
    model = HopVAE(config, impl=args.impl, compute_dtype=torch.bfloat16 if compute == "bfloat16" else None,
                   device=device)
    if args.checkpoint:
        load_weights(model, args.checkpoint)

    train_ds, _val_ds, test_ds = get_datasets(config, args.data)
    trainer = Trainer(model, config)
    if args.eval_only:
        print(f"Test Reconstruction Error: {trainer.evaluate(test_ds):.6f}")
        return
    trainer.fit(train_ds, test_ds, epochs=args.epochs, out_dir=args.out, resume=args.resume)


if __name__ == "__main__":
    main()
