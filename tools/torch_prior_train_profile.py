"""Profile the port's prior-phase training step on the card (PyTorch/CUDA port).

    python3 tools/torch_prior_train_profile.py [--steps 5] [--trace PATH]

Builds ``ffhq_64_scaled`` with ``prior=Transformer`` and ``prior_start=-1``
from ``checkpoints/Transformer-FFHQ-64.msgpack`` on the production path
(kernels + bf16 conv stacks), batch 256, in the prior phase; warms up two
steps, then runs ``--steps`` steps of ``Trainer.train_step`` under
``torch.profiler`` and prints one JSON line: the wall time per step on the
host clock, the device busy share (the union of GPU activity intervals
over the window), and device time per step by kernel name and by the
host op that launched it. ``--trace`` also writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from hopvae_torch.config import load_config  # noqa: E402
from hopvae_torch.data import _normalize, synthetic_images  # noqa: E402
from hopvae_torch.models.hopvae import HopVAE  # noqa: E402
from hopvae_torch.train import Trainer, load_weights  # noqa: E402
from torch_serving_profile import busy_ms  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_prior_train_profile: no CUDA device", file=sys.stderr)
        return 2
    cfg = load_config("ffhq_64_scaled")
    cfg.prior, cfg.prior_start = "Transformer", -1
    model = HopVAE(cfg, impl="cuda", compute_dtype=torch.bfloat16, device="cuda")
    load_weights(model, str(ROOT / "checkpoints" / "Transformer-FFHQ-64.msgpack"))
    trainer = Trainer(model, cfg)
    trainer.build_optimizer(1, fit_prior=True)
    x = torch.from_numpy(_normalize(synthetic_images(cfg.batch_size, cfg.image_size, seed=3), cfg.data_set)).cuda()
    for _ in range(2):
        trainer.train_step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels, ops = {}, {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0:  # device kernels by name, and the host ops that launched them
            into = kernels if e.device_type == torch.autograd.DeviceType.CUDA else ops
            into[e.key] = {"device_ms_per_step": dev / 1e3 / args.steps, "calls_per_step": e.count / args.steps}

    def top(d, n):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]["device_ms_per_step"])[:n])

    busy = busy_ms(prof.events(), kernels_only=False)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy / args.steps,
        "device_busy_share": busy / wall_ms,
        "kernel_ms_per_step": sum(v["device_ms_per_step"] for v in kernels.values()),
        "by_kernel": top(kernels, 25),
        "by_op": top(ops, 25),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
