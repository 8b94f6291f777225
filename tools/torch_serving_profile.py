"""Profile the port's serving path on the card (PyTorch/CUDA port).

    python3 tools/torch_serving_profile.py [--requests 5] [--trace PATH]

Builds the production ``InferenceEngine`` for ``ffhq_64_scaled`` at
``max_batch=256`` (kernel + bf16 convs), serves ``--requests`` batches of
256 synthetic images under ``torch.profiler``, and prints one JSON line:
the wall time per request on the host clock, the device busy share (the
union of GPU activity intervals over the window, with and without the
copies), and device time by kernel name. ``--trace`` also writes a Chrome trace.
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

from hopvae_torch.config import load_config  # noqa: E402
from hopvae_torch.data import _normalize, synthetic_images  # noqa: E402
from hopvae_torch.serving import InferenceEngine, state_from_checkpoint  # noqa: E402


def busy_ms(events, kernels_only: bool) -> float:
    """Length of the union of the device intervals, in ms; with
    ``kernels_only`` copies and memsets do not count."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not (kernels_only and e.name.startswith(("Memcpy", "Memset")))
    )
    total, cur_start, cur_end = 0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3  # profiler times are in us


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2
    cfg = load_config("ffhq_64_scaled")
    state = state_from_checkpoint(str(ROOT / "checkpoints" / "Transformer-FFHQ-64.msgpack"))
    engine = InferenceEngine(cfg, state, max_batch=256)
    x = _normalize(synthetic_images(256, cfg.image_size, seed=3), cfg.data_set)
    engine.reconstruct(x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            engine.reconstruct(x)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0:
            by_name[e.key] = {"device_ms_per_request": dev / 1e3 / args.requests, "calls": e.count}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms_per_request"])[:20])
    busy = busy_ms(prof.events(), kernels_only=False)
    compute = busy_ms(prof.events(), kernels_only=True)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "requests": args.requests,
        "wall_ms_per_request": wall_ms / args.requests,
        "device_busy_ms_per_request": busy / args.requests,
        "device_busy_share": busy / wall_ms,
        "kernel_busy_ms_per_request": compute / args.requests,
        "kernel_busy_share": compute / wall_ms,
        "by_kernel": top,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
