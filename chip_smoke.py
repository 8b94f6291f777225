#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``hopvae_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Eleven phases, each of which raises on failure:

1. Environment: versions, the card's name and power limit, and the build
   of every kernel in ``hopvae_torch/csrc`` (timed).
2. Each kernel against its plain torch version on the card, in f32 with
   TF32 off, at the shapes the serving and training paths give it: K1
   (the forward), then K2 and K3 (the backward, from K1's row stats and a
   seeded cotangent, each run twice to repeat bit for bit); kernel, plain
   and library-call times from CUDA events, and the bound of each shape.
3. MNIST golden: the trained backbone in ``checkpoints/`` through the
   ``InferenceEngine`` on the 64 committed digits, on the f32 path and on
   the production path (bf16 conv stacks).
4. Full-width serving: ``ffhq_64_scaled`` at ``max_batch=256`` on the
   production path, requests of 256, 256, 100 and 1 images with the
   kernels' launch counts read around them; images/s, per-stage times,
   and the f32 path against the JAX recon MSE pinned for a fixed batch.
5. Train golden: the MNIST backbone through ``Trainer`` on the kernels,
   f32, against the JAX losses and gradient norms pinned in
   ``TRAIN_GOLDEN``, twice, repeating bit for bit.
6. Full-width training: ``ffhq_64_scaled`` at batch 256 on the
   production path through ``Trainer.fit``, 2 epochs, with the kernels'
   launch counts read around it; images/s, a save and resume, and the
   per-stage device times of one step, forward and backward.
7. The causal flash-attention kernels K5-fwd, K5-dkv and K5-dq against
   their plain versions, f32 with TF32 off, at the prior's full width
   (B 256, S 867, 4 heads of 32, strided views of one projection as the
   prior gives them), at ``prior_heads=1`` (one head of 128) and at small
   ragged shapes; the backward runs twice and must repeat bit for bit;
   kernel, plain, bound and SDPA times.
8. Prior golden: the Transformer prior of ``Transformer-FFHQ-64.msgpack``
   on the committed grid through K5, and ``HopVAE.forward(fit_prior=True)``
   on the golden batch, against the JAX numbers in ``PRIOR_GOLDENS``.
9. Prior-train golden: three prior-only Adam steps through ``Trainer``,
   f32, twice, against ``PRIOR_TRAIN_GOLDEN``; bit-for-bit repeat, and
   the backbone left bit-identical.
10. Full-width prior phase: ``ffhq_64_scaled`` with ``prior=Transformer``,
    ``prior_start=-1``, batch 256, production path, 2 epochs through
    ``Trainer.fit`` with every kernel's launch count read around it (K5
    4 a step each, K1 3, K2 and K3 none); images/s, a save and resume,
    and the per-stage device times of one step.
11. The kernel summary as one JSON line, the card line, and last
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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from hopvae_torch.config import load_config
from hopvae_torch.data import (GOLDENS, PRIOR_GOLDENS, PRIOR_TRAIN_GOLDEN, TRAIN_GOLDEN, get_datasets, golden_grid,
                               golden_input, synthetic_images, _normalize)
from hopvae_torch.models.hopvae import PRIOR, HopVAE
from hopvae_torch.ops import attention_cuda as ac
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.ops.hopfield import HopfieldLookup
from hopvae_torch.ops.ste import straight_through_round
from hopvae_torch.serving import InferenceEngine, state_from_checkpoint
from hopvae_torch.train import Trainer, load_weights, prior_train_golden, train_golden
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
# K2 and K3 against their plain versions, max|a - b| / max|b| of each of
# dx, ds, dt, dK, dU: f32 sums over up to 74k tokens and 4096 patterns in
# another order (6e-6 at most on an H100)
BWD_NORMWISE = 5e-5
# K5 against its plain versions, normwise as above: out and lse of the
# forward, sums over up to 867 keys in another order than cuBLAS's; dQ, dK
# and dV of the backward, which also carry the cancellation in dP - delta
ATTN_FWD_NORMWISE = 1e-5
ATTN_BWD_NORMWISE = 5e-5


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


def roof(flops: float, exps: float, floats: float, exp_per_s: float) -> tuple[float, str]:
    """Least time (ms) of a kernel: its FLOPs at the f32 peak and its exps
    on the SFUs (they overlap) against the f32 words it must move at the
    HBM rate, each input read once and each output written once."""
    ops_s = max(flops / F32_FLOPS, exps / exp_per_s)
    bytes_s = 4 * floats / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def bound(n, m, d_in, d_out, exp_per_s) -> tuple[float, str]:
    """K1: reads x, K, U, s, t; writes out, m, l."""
    floats = n * d_in + m * (d_in + d_out) + 2 * d_in + n * d_out + 2 * n
    return roof(2 * n * m * (d_in + d_out), n * m, floats, exp_per_s)


def bound_bwd(kernel: str, n, m, d_in, d_out, exp_per_s) -> tuple[float, str]:
    """K2 and K3 read x, K, U, s, t, g, m, l and delta. K2 does the score
    product, g·Uᵀ and dS·K and writes dx, ds, dt; K3 does the score
    product, g·Uᵀ, Aᵀg and dSᵀq and writes dK, dU."""
    reads = n * d_in + m * (d_in + d_out) + 2 * d_in + n * d_out + 3 * n
    if kernel == "dx":
        return roof(2 * n * m * (2 * d_in + d_out), n * m, reads + n * d_in + 2 * d_in, exp_per_s)
    return roof(2 * n * m * (2 * d_in + 2 * d_out), n * m, reads + m * (d_in + d_out), exp_per_s)


def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))).name


def library_ms(q, k, u, reps) -> tuple[float | None, str]:
    """One PyTorch call for the same function, as a yardstick only, and
    the SDPA backend it ran on (or the message of its refusal)."""
    beta = 1.0 / math.sqrt(q.shape[1])
    try:
        backend = sdpa_backend(q[None], k[None], u[None])
        return cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], u[None], scale=beta), reps), backend
    except RuntimeError as e:  # no SDPA backend takes these widths
        msg = str(e).splitlines()[0]
        log(f"  library call refused: {msg}")
        return None, f"refused: {msg}"


def kernel_cases(tables: dict) -> list[tuple]:
    """``(label, n, (K, U, s, t), d_in, d_out)`` at the shapes the main
    paths give the kernels: a full-width ffhq_64_scaled batch of 256, an
    MNIST batch of 64, and a ragged case."""
    cases = []
    for tag, n, name in (("ffhq64 b256", 73984, "ffhq"), ("mnist b64", 4096, "mnist"), ("ragged", 37, "ragged")):
        for layer, (d_in, d_out) in zip(("L1", "L2", "L3"), hc.SUPPORTED):
            cases.append((f"{tag} {layer}", n, tables[name][layer], d_in, d_out))
    return cases


def case_input(n: int, d_in: int, g: torch.Generator) -> torch.Tensor:
    if d_in == 3:  # the quantized grid zq / (L - 1) that the third lookup reads
        return torch.randint(0, 512, (n, d_in), device="cuda", generator=g).float() / 511
    return torch.randn(n, d_in, device="cuda", generator=g)


def state_query(x, s, t) -> torch.Tensor:
    """``LN(x) * s + t`` in f32: the library call's query."""
    xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    return (xhat * s + t).contiguous()


@parity_mode()
def phase_kernel_vs_plain(env: dict, tables: dict) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, n, (k, u, s, t), d_in, d_out in kernel_cases(tables):
        x = case_input(n, d_in, g)
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
            lib_ms, backend = library_ms(state_query(x, s, t), k, u, reps)
        b_ms, b_by = bound(n, k.shape[0], d_in, d_out, env["exp_per_s"])
        row = {
            "shape": label, "n": n, "m": k.shape[0], "d_in": d_in, "d_out": d_out,
            "max_abs_err": err, "m_rel_err": m_err, "l_rel_err": l_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_backend": backend,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(json.dumps(row))
        rows.append(row)
        if not (err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL):
            raise AssertionError(f"kernel disagrees with its plain version at {label}: {row}")
    return rows


def library_bwd_ms(q, k, u, g, reps) -> tuple[float | None, str]:
    """One ``torch.autograd.grad`` through ``F.scaled_dot_product_attention``
    for ``(dq, dK, dU)`` with the same cotangent, as a yardstick only: it
    has no LayerNorm backward and computes what K2 and K3 compute
    together. Returns its time and the backend SDPA picked."""
    beta = 1.0 / math.sqrt(q.shape[1])
    leaves = [a[None].detach().clone().requires_grad_() for a in (q, k, u)]  # clone: k, u are inference tensors
    try:
        backend = sdpa_backend(*leaves)
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, scale=beta)
            ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g[None], retain_graph=True), reps)
        return ms, backend
    except RuntimeError as e:  # no SDPA backend takes these widths
        msg = str(e).splitlines()[0]
        log(f"  library call refused: {msg}")
        return None, f"refused: {msg}"


def normwise(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@parity_mode()
def phase_backward_vs_plain(env: dict, tables: dict) -> list[dict]:
    """K2 and K3 against their plain versions at the shapes of phase 2,
    with ``m`` and ``l`` from K1 and a seeded cotangent; each kernel runs
    twice and must repeat bit for bit."""
    g_gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, n, (k, u, s, t), d_in, d_out in kernel_cases(tables):
        x = case_input(n, d_in, g_gen)
        g = torch.randn(n, d_out, device="cuda", generator=g_gen)
        big = n * k.shape[0] > 1e8
        reps, plain_reps = (5, 2) if big else (20, 10)
        with torch.inference_mode():
            out, m, l = hc.stream_lookup_fwd(x, k, u, s, t)
            delta = (g * out).sum(-1, keepdim=True)
            args = (x, k, u, s, t, g, m, l, delta)
            got = {"dx": hc.stream_bwd_dx(*args), "dku": hc.stream_bwd_dku(*args)}
            again = {"dx": hc.stream_bwd_dx(*args), "dku": hc.stream_bwd_dku(*args)}
            torch.cuda.synchronize()
            want = {"dx": hc.stream_bwd_dx_reference(*args), "dku": hc.stream_bwd_dku_reference(*args)}
            names = {"dx": ("dx", "ds", "dt"), "dku": ("dK", "dU")}
            times = {
                "dx": (cuda_ms(lambda: hc.stream_bwd_dx(*args), reps),
                       cuda_ms(lambda: hc.stream_bwd_dx_reference(*args), plain_reps)),
                "dku": (cuda_ms(lambda: hc.stream_bwd_dku(*args), reps),
                        cuda_ms(lambda: hc.stream_bwd_dku_reference(*args), plain_reps)),
            }
        lib_ms, backend = library_bwd_ms(state_query(x, s, t), k, u, g, reps)
        for kernel in ("dx", "dku"):
            errs = {nm: normwise(a, b) for nm, a, b in zip(names[kernel], got[kernel], want[kernel])}
            abs_err = max((a - b).abs().max().item() for a, b in zip(got[kernel], want[kernel]))
            repeats = all(torch.equal(a, b) for a, b in zip(got[kernel], again[kernel]))
            b_ms, b_by = bound_bwd(kernel, n, k.shape[0], d_in, d_out, env["exp_per_s"])
            row = {
                "kernel": f"hopfield_stream_bwd_{kernel}", "shape": label, "n": n, "m": k.shape[0],
                "d_in": d_in, "d_out": d_out, "normwise_err": errs, "max_abs_err": abs_err,
                "repeats_bitwise": repeats, "ms": times[kernel][0], "plain_ms": times[kernel][1],
                "library_ms": lib_ms, "library_backend": backend, "bound_ms": b_ms, "bound_by": b_by,
            }
            log(json.dumps(row))
            rows.append(row)
            if not (max(errs.values()) <= BWD_NORMWISE and repeats):
                raise AssertionError(f"{row['kernel']} disagrees with its plain version at {label}: {row}")
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


# ------------------------------------------------------------ phase 5


@parity_mode()
def phase_train_golden() -> dict:
    """The f32 train golden through the kernels, twice: the step-0 loss
    and module gradient norms, and the losses after 1 to 3 Adam steps,
    against the JAX numbers pinned in ``TRAIN_GOLDEN``; the second run must
    repeat the first bit for bit."""
    gold = TRAIN_GOLDEN
    runs = [train_golden(str(CHECKPOINTS), device="cuda", impl="cuda") for _ in range(2)]
    (losses, norms, model), (losses2, _, model2) = runs
    repeats = losses == losses2 and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(), model2.state_dict().values())
    )
    loss_rel = [abs(a / b - 1) for a, b in zip(losses, gold["losses"])]
    norm_rel = {k: abs(norms[k] / v - 1) for k, v in gold["grad_norms"].items()}
    res = {"losses": losses, "jax_losses": gold["losses"], "loss_rel_err": loss_rel,
           "grad_norms": norms, "grad_norm_rel_err": norm_rel, "repeats_bitwise": repeats}
    log(json.dumps({"train_golden": res}))
    if loss_rel[0] > gold["loss0_rtol"] or max(loss_rel) > gold["losses_rtol"]:
        raise AssertionError(f"train golden losses {losses} are not within tolerance of {gold['losses']}")
    if max(norm_rel.values()) > gold["grad_norm_rtol"]:
        raise AssertionError(f"step-0 gradient norms {norms} are not within {gold['grad_norm_rtol']} of JAX's")
    if not repeats:
        raise AssertionError("a second run of the train golden does not repeat the first bit for bit")
    return res


KERNEL_COUNTERS = {
    "hopfield_stream_fwd": hc.stream_lookup_fwd,
    "hopfield_stream_bwd_dx": hc.stream_bwd_dx,
    "hopfield_stream_bwd_dku": hc.stream_bwd_dku,
}


def module_grads(model) -> dict:
    """Each top-level module's gradients, flattened into one vector."""
    return {
        name: torch.cat([p.grad.flatten() for p in mod.parameters() if p.grad is not None])
        for name, mod in model.named_children() if any(p.grad is not None for p in mod.parameters())
    }


def train_stage_ms(model, x: torch.Tensor, reps: int = 5) -> dict:
    """Device times of one training forward and backward, stage by stage,
    composed as ``HopVAE.forward`` and ``Trainer._loss_fn`` compose them.
    Each stage's input is cut from the graph, so the backward runs stage
    by stage in reverse; the composed loss must equal the trainer's and its
    gradients must agree with one backward of the whole graph. A spin
    kernel holds the stream while the host enqueues, as in ``stage_ms``."""
    layers, levels = model.bottleneck_layers(), model.num_levels
    names = ("encoder", "lookup_1", "lookup_2", "lookup_3", "decoder_and_loss")
    fwd, bwd = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)

    def cut(a):
        return a.detach().requires_grad_()

    for rep in range(reps + 1):
        model.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * len(names) + 1)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        z = model._encode_to_tokens(x)
        ev[1].record()
        e = hc.hopfield_lookup_stream(layers["hopfield"], zc := cut(z))
        ev[2].record()
        i = torch.sigmoid(hc.hopfield_lookup_stream(layers["embedding_to_index"], ec := cut(e)))
        zn = straight_through_round(i * (levels - 1)) / (levels - 1)
        ev[3].record()
        r = hc.hopfield_lookup_stream(layers["index_to_embedding"], znc := cut(zn))
        ev[4].record()
        recon = model._tokens_to_image(ec)
        loss = torch.mean((recon - x) ** 2) + torch.mean(((rc := cut(r)) - ec) ** 2)
        ev[5].record()
        loss.backward()  # decoder, loss; the aux part reaches rc and ec
        ev[6].record()
        r.backward(rc.grad)
        ev[7].record()
        zn.backward(znc.grad)  # adds lookup_2's part to ec
        ev[8].record()
        e.backward(ec.grad)
        ev[9].record()
        z.backward(zc.grad)
        ev[10].record()
        torch.cuda.synchronize()
        if rep == 0:  # the first pass checks; the rest are timed
            staged = module_grads(model)
            model.zero_grad(set_to_none=True)
            whole, _ = Trainer(model, model.config)._loss_fn(x)
            whole.backward()
            if not torch.equal(loss, whole):
                raise AssertionError("the timed stages do not compose to the trainer's loss")
            # normwise per module: the summation order of e's three
            # gradients differs, and bf16 casts may round that differently
            worst = max(normwise(staged[k], v) for k, v in module_grads(model).items())
            if worst > 1e-2:
                raise AssertionError(f"the staged backward disagrees with the whole one: {worst}")
            continue
        for a, name in enumerate(names):
            fwd[name] += ev[a].elapsed_time(ev[a + 1]) / reps
        for a, name in enumerate(reversed(names)):
            bwd[name] += ev[5 + a].elapsed_time(ev[6 + a]) / reps
    model.zero_grad(set_to_none=True)
    return {"forward": fwd, "backward": bwd, "staged_vs_whole_grad_normwise": worst,
            "step_fwd_bwd_ms": sum(fwd.values()) + sum(bwd.values())}


def phase_train_full_width() -> dict:
    """``ffhq_64_scaled`` at batch 256 on the production path (kernels +
    bf16 conv stacks) through ``Trainer.fit`` on the synthetic FFHQ train
    split, 2 epochs, warm-started from the FFHQ-64 backbone. The kernel
    counts are set to 0 just before ``fit`` and read just after: 3
    launches of each kernel per step. Then a save and a resume, and the
    per-stage device times of one step."""
    cfg = load_config("ffhq_64_scaled")
    torch.manual_seed(cfg.seed)

    def fresh_model():
        model = HopVAE(cfg, impl="cuda", compute_dtype=torch.bfloat16, device="cuda")
        load_weights(model, str(CHECKPOINTS / GOLDENS["ffhq64_synthetic4"]["checkpoint"]))
        return model

    train_ds, _val, test_ds = get_datasets(cfg, None)
    steps = 2 * (len(train_ds) // cfg.batch_size)
    trainer = Trainer(fresh_model(), cfg)
    with tempfile.TemporaryDirectory() as out:
        for fn in KERNEL_COUNTERS.values():
            fn.launches = 0
        trainer.fit(train_ds, test_ds, epochs=2, out_dir=out, eval_every=0, save_every=0)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
        records = [json.loads(line) for line in open(Path(out) / "metrics.jsonl")]
        trainer.save(1, out)
        resumed = Trainer(fresh_model(), cfg)
        resumed.fit(train_ds, test_ds, epochs=2, out_dir=out, eval_every=0, save_every=0, resume=True)
    adam, adam_resumed = trainer.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    restored = {
        "step": resumed.schedule.last_epoch == trainer.schedule.last_epoch == steps,
        "lr": resumed.optimizer.param_groups[0]["lr"] == trainer.optimizer.param_groups[0]["lr"],
        "adam_state": adam.keys() == adam_resumed.keys() and all(
            torch.equal(adam[i][k], adam_resumed[i][k]) for i in adam for k in adam[i]
        ),
        "params": all(torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                                         trainer.model.state_dict().values())),
    }
    x = train_ds.images[: cfg.batch_size]
    stages = train_stage_ms(trainer.model, torch.from_numpy(x).cuda())
    res = {
        "steps": steps, "launches": launches,
        "epochs": [{k: r[k] for k in ("epoch", "Train Reconstruction Error", "train_loss_per_batch",
                                      "epoch_seconds", "images_per_sec")} for r in records],
        "images_per_s_epoch_2": records[-1]["images_per_sec"],
        "stage_ms": stages, "resume_restores": restored,
        "lr_after": trainer.optimizer.param_groups[0]["lr"],
    }
    log(json.dumps({"training": res}))
    if launches != dict.fromkeys(KERNEL_COUNTERS, 3 * steps):
        raise AssertionError(f"expected 3 launches of each kernel per step over {steps} steps: {launches}")
    if len(records) != 2 or not all(math.isfinite(r["train_loss_per_batch"]) for r in records):
        raise AssertionError(f"training records are missing or not finite: {records}")
    if not all(restored.values()):
        raise AssertionError(f"the resume did not restore the trainer: {restored}")
    return res


# ------------------------------------------------------------ phase 7


ATTENTION_COUNTERS = {
    "causal_attention_fwd": ac.causal_attention_fwd,
    "causal_attention_bwd_dkv": ac.causal_attention_bwd_dkv,
    "causal_attention_bwd_dq": ac.causal_attention_bwd_dq,
}
# (label, B, S, heads, dh): the prior at full width, at prior_heads=1, and
# small ragged shapes (S a multiple of no tile, of one tile, below one)
ATTENTION_CASES = (
    ("full B256 S867 h4 dh32", 256, 867, 4, 32),
    ("heads1 B256 S867 h1 dh128", 256, 867, 1, 128),
    ("ragged S5", 2, 5, 2, 8),
    ("ragged S37", 2, 37, 2, 8),
    ("ragged S48", 2, 48, 2, 8),
)


def attention_bound(kernel: str, b, s, h, dh, exp_per_s) -> tuple[float, str]:
    """Least time of one K5 launch. Each product over the causal triangle
    is 2·dh·S(S+1)/2 FLOPs per head; the forward needs 2 (QKᵀ, PV), dK/dV
    4 (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) and dQ 3 (QKᵀ, dO·Vᵀ, dS·K), each with
    one exp per score. Words: q, k, v (and dO, lse, delta) read once, the
    outputs (out and lse; dK and dV; dQ) written once."""
    pairs = b * h * s * (s + 1) / 2
    products = {"fwd": 2, "dkv": 4, "dq": 3}[kernel]
    tensor = b * s * h * dh
    words = {"fwd": 4 * tensor + b * h * s, "dkv": 6 * tensor + 2 * b * h * s,
             "dq": 5 * tensor + 2 * b * h * s}[kernel]
    return roof(products * 2 * dh * pairs, pairs, words, exp_per_s)


def attention_inputs(b, s, h, dh, g: torch.Generator):
    """q, k, v as strided views of one ``(B, S, 3·h·dh)`` projection, as
    the prior's split gives them, and a contiguous cotangent."""
    qkv = torch.randn(b, s, 3 * h * dh, device="cuda", generator=g)
    q, k, v = (qkv[..., i * h * dh : (i + 1) * h * dh].view(b, s, h, dh) for i in range(3))
    return q, k, v, torch.randn(b, s, h, dh, device="cuda", generator=g)


def sdpa_causal_ms(q, k, v, g, reps) -> dict:
    """The library yardstick, never called by the port: one
    ``F.scaled_dot_product_attention(is_causal=True)`` on the same f32
    inputs as contiguous ``(B, h, S, dh)``, forward, backward alone (dQ,
    dK, dV for the same cotangent) and forward + backward, and the backend
    it picked."""
    from torch.nn.attention import SDPBackend

    leaves = [a.transpose(1, 2).contiguous().requires_grad_() for a in (q, k, v)]
    gt = g.transpose(1, 2).contiguous()
    try:
        backend = SDPBackend(torch._fused_sdp_choice(*leaves, is_causal=True)).name
        with torch.no_grad():
            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, is_causal=True), reps)
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True), reps)
            both = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves, is_causal=True),
                                                       leaves, gt), reps)
        return {"fwd_ms": fwd, "bwd_ms": bwd, "fwd_bwd_ms": both, "backend": backend}
    except RuntimeError as e:  # no SDPA backend takes these inputs
        msg = str(e).splitlines()[0]
        log(f"  library call refused: {msg}")
        return {"fwd_ms": None, "bwd_ms": None, "fwd_bwd_ms": None, "backend": f"refused: {msg}"}


@parity_mode()
def phase_attention_vs_plain(env: dict) -> list[dict]:
    """K5-fwd, K5-dkv and K5-dq against their plain versions on the same
    inputs, the backward from the kernel's own lse; each backward kernel
    runs twice and must repeat bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, b, s, h, dh in ATTENTION_CASES:
        q, k, v, g = attention_inputs(b, s, h, dh, gen)
        scale = 1.0 / math.sqrt(dh)
        big = b * h * s * s > 1e8
        reps, plain_reps = (10, 3) if big else (50, 20)
        with torch.inference_mode():
            out, lse = ac.causal_attention_fwd(q, k, v, scale)
            delta = ac.attention_delta(out, g)
            args = (q, k, v, g, lse, delta, scale)
            dk, dv = ac.causal_attention_bwd_dkv(*args)
            dq = ac.causal_attention_bwd_dq(*args)
            dk2, dv2 = ac.causal_attention_bwd_dkv(*args)
            dq2 = ac.causal_attention_bwd_dq(*args)
            torch.cuda.synchronize()
            got = {"fwd": (out, lse), "dkv": (dk, dv), "dq": (dq,)}
            repeats = {"dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2), "dq": torch.equal(dq, dq2)}
            want = {"fwd": ac.causal_attention_fwd_reference(q, k, v, scale),
                    "dkv": ac.causal_attention_bwd_dkv_reference(*args),
                    "dq": (ac.causal_attention_bwd_dq_reference(*args),)}
            errs = {kn: [normwise(a, w) for a, w in zip(got[kn], want[kn])] for kn in got}
            abs_errs = {kn: max((a - w).abs().max().item() for a, w in zip(got[kn], want[kn])) for kn in got}
            del want, got, dk2, dv2, dq2
            times = {
                "fwd": (cuda_ms(lambda: ac.causal_attention_fwd(q, k, v, scale), reps),
                        cuda_ms(lambda: ac.causal_attention_fwd_reference(q, k, v, scale), plain_reps)),
                "dkv": (cuda_ms(lambda: ac.causal_attention_bwd_dkv(*args), reps),
                        cuda_ms(lambda: ac.causal_attention_bwd_dkv_reference(*args), plain_reps)),
                "dq": (cuda_ms(lambda: ac.causal_attention_bwd_dq(*args), reps),
                       cuda_ms(lambda: ac.causal_attention_bwd_dq_reference(*args), plain_reps)),
            }
        lib = sdpa_causal_ms(q, k, v, g, reps)
        for kn, names in (("fwd", ("out", "lse")), ("dkv", ("dK", "dV")), ("dq", ("dQ",))):
            b_ms, b_by = attention_bound(kn, b, s, h, dh, env["exp_per_s"])
            row = {
                "kernel": f"causal_attention_{'fwd' if kn == 'fwd' else 'bwd_' + kn}", "shape": label,
                "b": b, "s": s, "h": h, "dh": dh, "normwise_err": dict(zip(names, errs[kn])),
                "max_abs_err": abs_errs[kn], "repeats_bitwise": repeats.get(kn, True),
                "ms": times[kn][0], "plain_ms": times[kn][1],
                "library_ms": lib["fwd_ms"] if kn == "fwd" else lib["bwd_ms"],
                "library_fwd_bwd_ms": lib["fwd_bwd_ms"], "library_backend": lib["backend"],
                "bound_ms": b_ms, "bound_by": b_by,
            }
            log(json.dumps(row))
            rows.append(row)
            limit = ATTN_FWD_NORMWISE if kn == "fwd" else ATTN_BWD_NORMWISE
            if not (max(errs[kn]) <= limit and row["repeats_bitwise"]):
                raise AssertionError(f"{row['kernel']} disagrees with its plain version at {label}: {row}")
        del q, k, v, g, out, lse, delta, dk, dv, dq
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 8


def prior_config(**over):
    """``ffhq_64_scaled`` with the Transformer prior of ``PRIOR_GOLDENS``."""
    cfg = load_config(PRIOR_GOLDENS["config"])
    cfg.prior = PRIOR_GOLDENS["prior"]
    for key, val in over.items():
        setattr(cfg, key, val)
    return cfg


@parity_mode()
def phase_prior_golden() -> dict:
    """The prior alone on the committed JAX grid, through K5 (4 forward
    launches, one per layer), and ``HopVAE.forward(fit_prior=True)`` on
    the golden batch, f32; the quantized grid's bins that differ from the
    committed one are counted."""
    spec = PRIOR_GOLDENS
    model = HopVAE(prior_config(), impl="cuda", device="cuda")
    model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"])))
    grid = torch.from_numpy(golden_grid()).cuda()
    x = torch.from_numpy(golden_input("ffhq64_synthetic4")).cuda()
    with torch.inference_mode():
        ac.causal_attention_fwd.launches = 0
        bits = float(model.prior_bits(grid.reshape(grid.shape[0], -1, grid.shape[-1])))
        launches = ac.causal_attention_fwd.launches
        _, loss = model(x, fit_prior=True)
        _, zq, _ = model.backbone(x)
    flipped = int((zq.reshape(grid.shape) != grid).sum())
    res = {"bits": bits, "jax_bits": spec["bits"], "bits_rel_err": abs(bits / spec["bits"] - 1),
           "loss": float(loss), "jax_loss": spec["loss"], "loss_rel_err": abs(float(loss) / spec["loss"] - 1),
           "flipped_bins": flipped, "fwd_launches": launches}
    log(json.dumps({"prior_golden": res}))
    if launches != model.prior.n_layers:
        raise AssertionError(f"expected {model.prior.n_layers} K5 forward launches, got {launches}")
    if res["bits_rel_err"] > spec["bits_rtol"]:
        raise AssertionError(f"prior bits {bits} are not within {spec['bits_rtol']} of {spec['bits']}")
    if res["loss_rel_err"] > spec["loss_rtol"] or flipped > spec["max_flipped_bins"]:
        raise AssertionError(f"fit_prior loss or grid off the JAX golden: {res}")
    return res


# ------------------------------------------------------------ phase 9


def backbone_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items() if not k.startswith(PRIOR)}


@parity_mode()
def phase_prior_train_golden() -> dict:
    """Three prior-only Adam steps through ``Trainer`` on the kernels, f32,
    twice: losses and the prior's step-0 gradient norm against JAX's, the
    second run bit for bit the first, the backbone untouched."""
    gold = PRIOR_TRAIN_GOLDEN
    stored = state_from_checkpoint(str(CHECKPOINTS / PRIOR_GOLDENS["checkpoint"]))
    start = {k: v for k, v in stored.items() if not k.startswith(PRIOR)}
    runs = [prior_train_golden(str(CHECKPOINTS), device="cuda", impl="cuda") for _ in range(2)]
    (losses, norm, model), (losses2, norm2, model2) = runs
    repeats = losses == losses2 and norm == norm2 and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(), model2.state_dict().values())
    )
    after = backbone_state(model)
    frozen = start.keys() == after.keys() and all(torch.equal(start[k], after[k].cpu()) for k in start)
    loss_rel = [abs(a / b - 1) for a, b in zip(losses, gold["losses"])]
    res = {"losses": losses, "jax_losses": gold["losses"], "loss_rel_err": loss_rel, "grad_norm": norm,
           "grad_norm_rel_err": abs(norm / gold["grad_norm"] - 1), "repeats_bitwise": repeats,
           "backbone_bit_identical": frozen}
    log(json.dumps({"prior_train_golden": res}))
    if max(loss_rel) > gold["losses_rtol"] or res["grad_norm_rel_err"] > gold["grad_norm_rtol"]:
        raise AssertionError(f"prior-train golden off JAX's: {res}")
    if not (repeats and frozen):
        raise AssertionError(f"the prior-train golden does not repeat, or moved the backbone: {res}")
    return res


# ------------------------------------------------------------ phase 10


def prior_step_stage_ms(trainer, x: torch.Tensor, reps: int = 5) -> dict:
    """Device times of one prior-phase step, stage by stage, composed as
    ``Trainer._loss_fn`` and ``train_step`` compose it: the backbone
    forward without autograd, the prior's forward (bits and loss), the
    prior's backward and Adam. The composed loss must equal the trainer's.
    A spin kernel holds the stream while the host enqueues, as in
    ``stage_ms``. The timed steps do update the prior."""
    model, opt = trainer.model, trainer.optimizer
    names = ("backbone_forward", "prior_forward", "prior_backward", "adam")
    totals = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        opt.zero_grad(set_to_none=True)
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        with torch.no_grad():
            x_recon, zq, aux = model.backbone(x)
            recon = torch.mean((x_recon - x) ** 2)
        ev[1].record()
        loss = recon + (model.prior_bits(zq) + aux)
        ev[2].record()
        loss.backward()
        ev[3].record()
        if rep == 0:  # the first pass checks; the rest are timed and stepped
            torch.cuda.synchronize()
            whole, _ = trainer._loss_fn(x)
            if not torch.equal(loss.detach(), whole.detach()):
                raise AssertionError("the timed stages do not compose to the trainer's loss")
            continue
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        for a, name in enumerate(names):
            totals[name] += ev[a].elapsed_time(ev[a + 1]) / reps
    opt.zero_grad(set_to_none=True)
    return {**totals, "step_ms": sum(totals.values())}


def phase_prior_train_full_width() -> dict:
    """The prior phase at full width: ``ffhq_64_scaled`` with
    ``prior=Transformer`` and ``prior_start=-1`` from
    ``Transformer-FFHQ-64.msgpack``, batch 256, production path (kernels +
    bf16 conv stacks), 2 epochs through ``Trainer.fit`` on the synthetic
    FFHQ train split. Every kernel's count is set to 0 just before ``fit``
    and read just after: K5's three kernels 4 a step (one per layer), K1 3,
    K2 and K3 none, since the backbone runs without autograd. Then a save
    and a resume, and the per-stage device times of one step."""
    cfg = prior_config(prior_start=-1)
    torch.manual_seed(cfg.seed)
    counters = {**KERNEL_COUNTERS, **ATTENTION_COUNTERS}

    def fresh_model():
        model = HopVAE(cfg, impl="cuda", compute_dtype=torch.bfloat16, device="cuda")
        load_weights(model, str(CHECKPOINTS / PRIOR_GOLDENS["checkpoint"]))
        return model

    train_ds, _val, test_ds = get_datasets(cfg, None)
    steps = 2 * (len(train_ds) // cfg.batch_size)
    trainer = Trainer(fresh_model(), cfg)
    start = backbone_state(trainer.model)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        for fn in counters.values():
            fn.launches = 0
        trainer.fit(train_ds, test_ds, epochs=2, out_dir=out, eval_every=0, save_every=0)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        records = [json.loads(line) for line in open(Path(out) / "metrics.jsonl")]
        trainer.save(1, out)
        resumed = Trainer(fresh_model(), cfg)
        resumed.fit(train_ds, test_ds, epochs=2, out_dir=out, eval_every=0, save_every=0, resume=True)
    adam, adam_resumed = trainer.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    restored = {
        "phase": resumed.fit_prior and trainer.fit_prior,
        "step": resumed.schedule.last_epoch == trainer.schedule.last_epoch == steps,
        "lr": resumed.optimizer.param_groups[0]["lr"] == trainer.optimizer.param_groups[0]["lr"],
        "adam_state": adam.keys() == adam_resumed.keys() and all(
            torch.equal(adam[i][k], adam_resumed[i][k]) for i in adam for k in adam[i]
        ),
        "params": all(torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                                         trainer.model.state_dict().values())),
    }
    after = backbone_state(trainer.model)
    frozen = all(torch.equal(start[k], after[k]) for k in start)
    x = train_ds.images[: cfg.batch_size]
    stages = prior_step_stage_ms(trainer, torch.from_numpy(x).cuda())
    res = {
        "steps": steps, "launches": launches, "peak_gib": peak_gib,
        "epochs": [{k: r[k] for k in ("epoch", "fit_prior", "Train Reconstruction Error", "train_loss_per_batch",
                                      "epoch_seconds", "images_per_sec")} for r in records],
        "images_per_s_epoch_2": records[-1]["images_per_sec"],
        "stage_ms": stages, "resume_restores": restored, "backbone_bit_identical": frozen,
    }
    log(json.dumps({"prior_training": res}))
    layers = trainer.model.prior.n_layers
    want = {**dict.fromkeys(ATTENTION_COUNTERS, layers * steps), "hopfield_stream_fwd": 3 * steps,
            "hopfield_stream_bwd_dx": 0, "hopfield_stream_bwd_dku": 0}
    if launches != want:
        raise AssertionError(f"expected launches {want} over {steps} prior-phase steps, got {launches}")
    if len(records) != 2 or not all(r["fit_prior"] and math.isfinite(r["train_loss_per_batch"]) for r in records):
        raise AssertionError(f"prior-phase records are missing, not in the prior phase or not finite: {records}")
    if not (all(restored.values()) and frozen):
        raise AssertionError(f"the resume did not restore the trainer, or the backbone moved: {restored}")
    return res


# ------------------------------------------------------------ main


_MOSAIC = "jax/experimental/pallas/ops/tpu/flash_attention.py"
REPLACES = {
    "hopfield_stream_fwd": "hopvae_tpu/ops/hopfield_pallas.py:258 (_stream_fwd_kernel)",
    "hopfield_stream_bwd_dx": "hopvae_tpu/ops/hopfield_pallas.py:319 (_stream_bwd_dx_kernel)",
    "hopfield_stream_bwd_dku": "hopvae_tpu/ops/hopfield_pallas.py:367 (_stream_bwd_dku_kernel)",
    "causal_attention_fwd": f"{_MOSAIC}:331 (_flash_attention_kernel), via hopvae_tpu/ops/attention.py:172",
    "causal_attention_bwd_dkv": f"{_MOSAIC}:796 (_flash_attention_dkv_kernel), via hopvae_tpu/ops/attention.py:172",
    "causal_attention_bwd_dq": f"{_MOSAIC}:1146 (_flash_attention_dq_kernel), via hopvae_tpu/ops/attention.py:172",
}
SOURCES = {
    "causal_attention_fwd": "hopvae_torch/csrc/causal_attention_fwd.cu",
    "causal_attention_bwd_dkv": "hopvae_torch/csrc/causal_attention_bwd.cu",
    "causal_attention_bwd_dq": "hopvae_torch/csrc/causal_attention_bwd.cu",
}


def kernel_summary(name: str, rows: list[dict], launches: int, **extra) -> dict:
    """One kernel's entry. Times and bounds are those of one full-width
    batch-256 step: the sum over its three lookups. ``launches`` is the
    count from the training run."""
    full = [r for r in rows if r["shape"].startswith("ffhq64")]
    lib = [r["library_ms"] for r in full]
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCES.get(name, f"hopvae_torch/csrc/{name}.cu"),
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in full),
        "plain_ms": sum(r["plain_ms"] for r in full),
        "bound_ms": sum(r["bound_ms"] for r in full),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in full) else "bytes",
        "library_ms": None if None in lib else sum(lib),
        **extra,
        "shapes": rows,
    }


def attention_summary(name: str, rows: list[dict], launches: int) -> dict:
    """One K5 kernel's entry: times and bound of one launch at the prior's
    full width (one layer; a step launches it once per layer), errors over
    every shape, ``launches`` from the prior-phase run."""
    mine = [r for r in rows if r["kernel"] == name]
    full = next(r for r in mine if r["shape"].startswith("full"))
    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": full["ms"], "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
        "max_normwise_err": max(max(r["normwise_err"].values()) for r in mine),
        "library_fwd_bwd_ms": full["library_fwd_bwd_ms"], "library_backend": full["library_backend"],
        "shapes": mine,
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
    tables = folded_tables()
    rows = phase_kernel_vs_plain(env, tables)
    bwd_rows = phase_backward_vs_plain(env, tables)
    phase_mnist_golden()
    serving = phase_serving()
    phase_train_golden()
    training = phase_train_full_width()
    attn_rows = phase_attention_vs_plain(env)
    phase_prior_golden()
    phase_prior_train_golden()
    prior_training = phase_prior_train_full_width()
    launches, prior_launches = training["launches"], prior_training["launches"]
    kernels = [kernel_summary("hopfield_stream_fwd", rows, launches["hopfield_stream_fwd"],
                              launches_serving=serving["launches"],
                              launches_prior_phase=prior_launches["hopfield_stream_fwd"])]
    for name in ("hopfield_stream_bwd_dx", "hopfield_stream_bwd_dku"):
        kernels.append(kernel_summary(name, [r for r in bwd_rows if r["kernel"] == name], launches[name],
                                      max_normwise_err=max(max(r["normwise_err"].values())
                                                           for r in bwd_rows if r["kernel"] == name),
                                      launches_prior_phase=prior_launches[name]))
    kernels += [attention_summary(name, attn_rows, prior_launches[name]) for name in ATTENTION_COUNTERS]
    log(json.dumps({"kernels": kernels}))
    log(f"card: {smi('name,power.limit')}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
