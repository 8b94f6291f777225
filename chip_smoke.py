#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``hopvae_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Five phases, each of which raises on failure:

1. Environment: versions, the card's name and power limit, and the build
   of every kernel in ``hopvae_torch/csrc`` (timed).
2. Each kernel against its plain torch version on the card, in f32 with
   TF32 off, at the shapes the serving path gives it; kernel, plain and
   library-call times from CUDA events, and the bound of each shape.
3. MNIST golden: the trained backbone in ``checkpoints/`` through the
   ``InferenceEngine`` on the 64 committed digits, on the f32 path and on
   the production path (bf16 conv stacks).
4. Full-width serving: ``ffhq_64_scaled`` at ``max_batch=256`` on the
   production path, requests of 256, 256, 100 and 1 images with the
   kernels' launch counts read around them; images/s, per-stage times,
   and the f32 path against the JAX recon MSE pinned for a fixed batch.
5. The kernel summary as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of ``hopvae_tpu``; it exits non-zero, and
prints no result, without a CUDA card or outside the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from hopvae_torch.config import load_config
from hopvae_torch.data import GOLDENS, golden_input, synthetic_images, _normalize
from hopvae_torch.models.hopvae import HopVAE
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.ops.hopfield import HopfieldLookup
from hopvae_torch.ops.ste import straight_through_round
from hopvae_torch.serving import InferenceEngine, state_from_checkpoint
from hopvae_torch.utils import nvcc

ROOT = Path(__file__).resolve().parent
CHECKPOINTS = ROOT / "checkpoints"

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): f32 on the CUDA
# cores and HBM3 bandwidth. exp runs on the special-function units at 16
# results per clock per SM (CUDA C++ Programming Guide, compute 9.0).
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16

OUT_ATOL = 1e-4  # out: f32 sums in another order than cuBLAS's
STAT_RTOL = 1e-5  # m (floored at |m| = 1: it enters only as exp(sc - m)) and l
# The production path (kernel + bf16 conv stacks) is held to the MNIST
# golden within 1%, and its recon to the JAX package's own bound on its
# bf16 path: mean((r16 - r32)^2) < 1e-3 (tests/test_resume_and_dtype.py).
BF16_GOLDEN_RTOL = 1e-2
BF16_VS_F32_MSE = 1e-3


def log(*args) -> None:
    print(*args, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def parity_mode():
    """f32 products and convs in full f32 (TF32 off for both); the flags
    are restored after, so the production path runs with torch's defaults."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------ phase 1


def phase_environment() -> dict:
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    card = smi("name,power.limit")
    log(f"card: {card}")
    t0 = time.perf_counter()
    stems = nvcc.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {stems} in {build_s:.1f} s")
    for stem in stems:
        for line in nvcc.build_logs.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    log(f"{props.multi_processor_count} SMs, max SM clock {clock_hz / 1e6:.0f} MHz")
    return {
        "card": card,
        "build_s": build_s,
        "exp_per_s": props.multi_processor_count * SFU_PER_CLOCK_PER_SM * clock_hz,
    }


# ------------------------------------------------------------ phase 2


def bound(n, m, d_in, d_out, exp_per_s) -> tuple[float, str]:
    """Least time (ms) of one lookup: its FLOPs at the f32 peak and its
    exps on the SFUs (they overlap) against its bytes at the HBM rate,
    each input read once and each output written once."""
    ops_s = max(2 * n * m * (d_in + d_out) / F32_FLOPS, n * m / exp_per_s)
    bytes_s = 4 * (n * d_in + m * (d_in + d_out) + 2 * d_in + n * d_out + 2 * n) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def library_ms(q, k, u, reps) -> float | None:
    """One PyTorch call for the same function, as a yardstick only."""
    beta = 1.0 / math.sqrt(q.shape[1])
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], u[None], scale=beta), reps)
    except RuntimeError as e:  # no SDPA backend takes these widths
        log(f"  library call refused: {str(e).splitlines()[0]}")
        return None


@parity_mode()
def phase_kernel_vs_plain(env: dict, tables: dict) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for tag, n, name in (("ffhq64 b256", 73984, "ffhq"), ("mnist b64", 4096, "mnist"), ("ragged", 37, "ragged")):
        for layer, (d_in, d_out) in zip(("L1", "L2", "L3"), hc.SUPPORTED):
            cases.append((f"{tag} {layer}", n, tables[name][layer], d_in, d_out))
    rows = []
    for label, n, (k, u, s, t), d_in, d_out in cases:
        if d_in == 3:  # the quantized grid zq / (L - 1) that the third lookup reads
            x = torch.randint(0, 512, (n, d_in), device="cuda", generator=g).float() / 511
        else:
            x = torch.randn(n, d_in, device="cuda", generator=g)
        with torch.inference_mode():
            out, m, l = hc.stream_lookup_fwd(x, k, u, s, t)
            torch.cuda.synchronize()
            ref_out, ref_m, ref_l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
            err = (out - ref_out).abs().max().item()
            m_err = ((m - ref_m).abs() / ref_m.abs().clamp_min(1.0)).max().item()
            l_err = ((l - ref_l).abs() / ref_l).max().item()
            big = n * k.shape[0] > 1e8
            reps = 10 if big else 50
            kernel_ms = cuda_ms(lambda: hc.stream_lookup_fwd(x, k, u, s, t), reps)
            plain_ms = cuda_ms(lambda: hc.stream_lookup_fwd_reference(x, k, u, s, t), 3 if big else 20)
            xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-5)
            lib_ms = library_ms((xhat * s + t).contiguous(), k, u, reps)
        b_ms, b_by = bound(n, k.shape[0], d_in, d_out, env["exp_per_s"])
        row = {
            "shape": label, "n": n, "m": k.shape[0], "d_in": d_in, "d_out": d_out,
            "max_abs_err": err, "m_rel_err": m_err, "l_rel_err": l_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(json.dumps(row))
        rows.append(row)
        if not (err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL):
            raise AssertionError(f"kernel disagrees with its plain version at {label}: {row}")
    return rows


# ------------------------------------------------------------ phase 3


def engine_for(golden: str, **kw) -> InferenceEngine:
    spec = GOLDENS[golden]
    state = state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"]))
    return InferenceEngine(load_config(spec["config"]), state, **kw)


def phase_mnist_golden() -> dict:
    spec = GOLDENS["mnist_digits"]
    x = golden_input("mnist_digits")
    with parity_mode():
        f32 = engine_for("mnist_digits", max_batch=64, compute_dtype=None)
        y_f32 = f32.reconstruct(x)
        with torch.inference_mode():
            _, aux = f32.model.forward(torch.from_numpy(x).cuda())
    mse_f32 = float(np.mean((y_f32 - x) ** 2))
    aux = float(aux)
    prod = engine_for("mnist_digits", max_batch=64)
    y_prod = prod.reconstruct(x)
    mse_prod = float(np.mean((y_prod - x) ** 2))
    res = {
        "recon_mse_f32": mse_f32, "aux_f32": aux, "recon_mse_bf16": mse_prod,
        "bf16_vs_f32_mse": float(np.mean((y_prod - y_f32) ** 2)), "golden": spec["recon_mse"],
    }
    log(json.dumps({"mnist_golden": res}))
    if abs(mse_f32 / spec["recon_mse"] - 1) > 1e-3:
        raise AssertionError(f"f32 recon MSE {mse_f32} is not within 0.1% of {spec['recon_mse']}")
    if abs(aux / spec["aux"] - 1) > 2e-2:
        raise AssertionError(f"f32 aux {aux} is not within 2% of {spec['aux']}")
    if abs(mse_prod / spec["recon_mse"] - 1) > BF16_GOLDEN_RTOL:
        raise AssertionError(f"production recon MSE {mse_prod} is not within 1% of {spec['recon_mse']}")
    if res["bf16_vs_f32_mse"] >= BF16_VS_F32_MSE:
        raise AssertionError(f"production recon is {res['bf16_vs_f32_mse']} (MSE) from the f32 recon")
    return res


# ------------------------------------------------------------ phase 4


def stage_ms(model, x: torch.Tensor, reps: int = 5) -> dict:
    """Per-stage device times of one forward, the stages composed as
    ``HopVAE.forward`` composes them; the composed output must equal it.

    A spin kernel of about 25 ms holds the stream while the host enqueues
    the forward, so each stage's events bracket its device work and not
    the host's launch time (which exceeds it in the encoder)."""
    layers = model.bottleneck_layers()
    levels = model.num_levels
    names = ("encoder", "lookup_1", "lookup_2", "lookup_3", "decoder")
    totals = dict.fromkeys(names, 0.0)
    with torch.inference_mode():
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            torch.cuda._sleep(50_000_000)
            ev[0].record()
            z = model._encode_to_tokens(x)
            ev[1].record()
            e = hc.hopfield_lookup_stream(layers["hopfield"], z)
            ev[2].record()
            i = torch.sigmoid(hc.hopfield_lookup_stream(layers["embedding_to_index"], e))
            zn = straight_through_round(i * (levels - 1)) / (levels - 1)
            ev[3].record()
            hc.hopfield_lookup_stream(layers["index_to_embedding"], zn)
            ev[4].record()
            recon = model._tokens_to_image(e)
            ev[5].record()
            torch.cuda.synchronize()
            if rep == 0:  # the first pass checks; the rest are timed
                if not torch.equal(recon, model.reconstruct(x)[0]):
                    raise AssertionError("the timed stages do not compose to HopVAE.forward")
                continue
            for a, name in enumerate(names):
                totals[name] += ev[a].elapsed_time(ev[a + 1]) / reps
    return totals


def phase_serving() -> dict:
    engine = engine_for("ffhq64_synthetic4", max_batch=256)  # production: kernel + bf16 convs
    cfg = engine.config
    sizes = (256, 256, 100, 1)
    requests = [
        _normalize(synthetic_images(b, cfg.image_size, seed=10 + j), cfg.data_set) for j, b in enumerate(sizes)
    ]
    hc.stream_lookup_fwd.launches = 0
    per_request = []
    t_all = time.perf_counter()
    for x in requests:
        before = hc.stream_lookup_fwd.launches
        t0 = time.perf_counter()
        y = engine.reconstruct(x)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = hc.stream_lookup_fwd.launches - before
        if y.shape != x.shape or not np.isfinite(y).all():
            raise AssertionError(f"bad reconstruction: shape {y.shape}, finite {np.isfinite(y).all()}")
        per_request.append({"batch": len(x), "ms": ms, "launches": launches,
                            "recon_mse": float(np.mean((y - x) ** 2))})
    wall_s = time.perf_counter() - t_all
    launches = hc.stream_lookup_fwd.launches
    if [r["launches"] for r in per_request] != [3] * len(sizes):
        raise AssertionError(f"expected 3 kernel launches per request: {per_request}")

    full = [r["ms"] for r in per_request if r["batch"] == 256]
    stages = stage_ms(engine.model, torch.from_numpy(requests[0]).cuda())
    res = {
        "requests": per_request,
        "images_per_s": sum(sizes) / wall_s,
        "images_per_s_b256": 256e3 / (sum(full) / len(full)),
        "stage_ms_b256": stages,
        "launches": launches,
    }

    spec = GOLDENS["ffhq64_synthetic4"]
    x4 = golden_input("ffhq64_synthetic4")
    with parity_mode():
        f32 = engine_for("ffhq64_synthetic4", max_batch=4, compute_dtype=None)
        mse4 = float(np.mean((f32.reconstruct(x4) - x4) ** 2))
    res["recon_mse_f32_b4"] = mse4
    log(json.dumps({"serving": res}))
    if abs(mse4 / spec["recon_mse"] - 1) > 1e-3:
        raise AssertionError(f"f32 batch-4 recon MSE {mse4} is not within 0.1% of the pinned {spec['recon_mse']}")
    return res


# ------------------------------------------------------------ main


def kernel_summary(rows: list[dict], launches: int) -> dict:
    """One entry per kernel. Times and bounds are those of one
    full-width forward: the sum over its three lookups."""
    full = [r for r in rows if r["shape"].startswith("ffhq64")]
    lib = [r["library_ms"] for r in full]
    return {
        "name": "hopfield_stream_fwd",
        "route": "cuda",
        "source": "hopvae_torch/csrc/hopfield_stream_fwd.cu",
        "replaces": "hopvae_tpu/ops/hopfield_pallas.py:258 (_stream_fwd_kernel)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in full),
        "kernel_ms": sum(r["ms"] for r in full),
        "plain_ms": sum(r["plain_ms"] for r in full),
        "bound_ms": sum(r["bound_ms"] for r in full),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in full) else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "shapes": rows,
    }


def folded_tables() -> dict:
    """The folded tables of each lookup: the trained FFHQ-64 and MNIST
    checkpoints, and random ones with M = 3000 for the ragged case."""
    out = {}
    for name, golden in (("ffhq", "ffhq64_synthetic4"), ("mnist", "mnist_digits")):
        spec = GOLDENS[golden]
        model = HopVAE(load_config(spec["config"]), device="cuda")
        model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"])))
        out[name] = model.bottleneck_layers()
    g = torch.Generator(device="cuda").manual_seed(1)
    out["ragged"] = {}
    for j, (d_in, d_out) in enumerate(hc.SUPPORTED):
        layer = HopfieldLookup(d_in, d_out, 3000, device="cuda")
        layer.reset_parameters(generator=g)
        out["ragged"][j] = layer
    with torch.inference_mode():
        return {
            name: {f"L{j + 1}": tuple(a.contiguous() for a in (k, u, s, t))
                   for j, (k, u, _b, s, t) in enumerate(map(hc.fold_layer, layers.values()))}
            for name, layers in out.items()
        }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    env = phase_environment()
    rows = phase_kernel_vs_plain(env, folded_tables())
    phase_mnist_golden()
    serving = phase_serving()
    log(json.dumps({"kernels": [kernel_summary(rows, serving["launches"])]}))
    log(f"card: {smi('name,power.limit')}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
