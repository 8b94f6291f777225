#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``hopvae_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Twenty phases, each of which raises on failure:

1. Environment: versions, the card's name and power limit, and the build
   of every kernel in ``hopvae_torch/csrc`` (timed), with each instance's
   registers and any spill as ptxas reports them.
2. Each kernel against its plain torch version on the card, in f32 with
   TF32 off, at the shapes the serving and training paths give it: K1
   (the forward), then K2 and K3 (the backward, from K1's row stats and a
   seeded cotangent), each run twice to repeat bit for bit; kernel, plain
   and library-call times from CUDA events, and the bound of each shape
   (their products run on the tensor cores in three TF32 passes: the
   three-pass bound as ``bound_ms`` and the f32-core one as
   ``bound_f32_ms``; and each one's registers, shared bytes and blocks an
   SM). Then the same at widths no config uses, which the kernels take
   zero-padded: (32, 32), (64, 4), (128, 128), (256, 256) and (200, 3) at
   N 4,096, M 512, and a ragged (13, 100) and (130, 250) at N 37, M 300;
   and past 256, on the wide variants: (512, 512), (384, 384), (384, 3)
   and (3, 384) at N 4,096, M 512 (the last three phase 13's lookups at
   ``embedding_dim=384``), a ragged (300, 700), (1280, 3), (1280, 300)
   (the clusters with slices of 256; at (1280, 3) the narrow-side kernels
   in the cluster's order, K2's and K3's on split scores) and (300, 2304)
   (slices of 512) at N 37, M 300, (8320, 3)
   and (3, 8320) at N 37, M 64 and (8320, 300) at N 37, M 300 (past the
   widest cluster: the narrow-side kernels of K1, K2 and K3, K2's with
   its scores, its g Uᵀ or both split over the card first), (8320, 3) at
   N 4,096, M 64 (the split products' sums past 64 MiB: K2 and K3 split
   them slab after slab of tiles), at N 256, M 2,048 (one token tile's
   parts past 64 MiB: rounds of parts) and (8320, 8320) at N 256, M 256
   (K2's and K3's two products in slabs), K2's other windows, 16, 32, 64 and 128, at (16,
   384), (32, 384), (64, 384) and (100, 384), N 4,096, M 512 (nothing
   split: windows up to 32 walk 4 pattern tiles a group, wider ones 2)
   and at a ragged (13, 700), (30, 2304) and (50, 700), N 37, M 300 (g Uᵀ
   split: a tile at a time), and (384, 3) and
   (3, 384) at N 73,984, M 4,096, the lookups of a wide-embedding
   ffhq_64_scaled step, and (384, 3) at N 16,384, M 512 (an mnist_28
   batch of 256 at ``embedding_dim=384``) and at N 4,096, M 4,096, on
   random tables; K1 at (8320, 3), N 4,096 and N 256 and at those two
   (384, 3) shapes runs its score pass in slabs (its groups' sums past 64
   MiB); K2 and K3 at (384, 3) and at (300, 64), N 4,096, M 512 run
   their whole window (all of d_in in one block, each score computed once
   in registers). Past 256 each K1, K2 and K3 row
   names its route and plan as the built library gives it
   (``card_plan``: the cluster, or the narrow-side kernel with its
   window, its order or its splits and, where N leaves the card idle or
   every window would recompute them, its split products, or K2's and
   K3's whole window), its route held
   against ``hc.narrow_split``, the predicate the CPU tests read, K2's
   and K3's with their slabs and rounds (``hc.split_plan``, the scratch
   within 64 MiB), K1's with the slabs of its score pass, and, past 8192,
   a call's device ms in the split passes and in the window kernel
   (``torch.profiler``; on K1's slabs the query build, the score pass and
   the kernel); each K1
   row holds the rows of the attention rebuilt from its ``m`` and ``l``,
   the scores summed in K2's and K3's order, to sum to 1 within
   ``ROW_SUM_ATOL``; K1 (``PARENT_BITS``) at (3, 384), N 4,096 and (8320,
   3), N 37 gives the former window kernel's bits on hashed inputs, and at
   the four shapes of its slabs the one-pass walk's, and
   K2 (``K2_PARENT_BITS``) does so on every route and instance of its
   narrow-side kernel: at those two shapes and at each of the twelve other
   narrow-side cases above; K3 (``K3_PARENT_BITS``) gives its window
   walk's bits at (8320, 3), N 37, M 64 and N 4,096, M 64 and at the two
   new shapes; K2 and K3 at (384, 3), N 4,096 and 16,384, at (1280, 3), N
   37 and at (300, 64), N 4,096 give the bits their narrow-side kernels
   first gave there, in the cluster's order, when they left the cluster.
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
   prior gives them), at ``prior_heads=1`` (one head of 128), at one head
   of 256 (``prior_d_model=256``), at one head of 384 and one of 512 (the
   wide kernels: forward and backward on a thread-block cluster), and at
   small ragged shapes (one at 256; at 768, 1280, 2560 and 8192, the
   clusters' plans; past 8192 the window kernels, forward and backward,
   on scores split over the card within 64 MiB: at one head of 8320 at
   B 2, S 37, at B 1, S 400 (two slabs of query or key tiles) and at
   B 1, S 2100 (slabs of one tile, the depth chunks in two rounds), and
   at one head of 16384 at B 1, S 37, each row naming its route, slabs
   and rounds as the library plans them, and K5-fwd's ``out`` and
   ``lse`` held to the former window kernel's bits on hashed inputs at
   (2, 37, 1, 8320) and (1, 400, 1, 8320), ``K5_PARENT_BITS``; two with
   views off 16-byte alignment); each kernel, whose products run
   on the tensor cores in three TF32 passes, runs twice and must repeat
   bit for bit; kernel, plain and SDPA times, the three-pass TF32 bound
   (``bound_ms``, also ``bound_tc_ms``) and, for context, the bound of the
   same FLOPs on the f32 CUDA cores (``bound_f32_ms``), and each kernel's
   registers, shared bytes and blocks an SM per width (past 256 also the
   cluster: blocks, slice, clusters the card holds; K1's, K2's and
   K3's too, at each width of phase 2, and K4's at each of phase 12).
   Then a head of 48 through the zero padding to 64, forward and
   backward by autograd.
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
11. The full-width prior phase with one wide head: as phase 10 with
    ``prior_d_model=256, prior_heads=1``, the prior's leaves of another
    shape left fresh by the lenient load; K5 launches at head width 256,
    4 a step each; images/s, stage times, peak memory and a falling loss.
12. K4, the single-shot fused bottleneck forward, at the shapes the
    serving path gives the bottleneck (the encoder's tokens of a
    full-width ffhq_64_scaled batch of 256 with the trained tables; the
    MNIST golden digits; a ragged case) and at the bottleneck widths
    (d, di) = (32, 4), (256, 3), (384, 3), (64, 300) and (384, 300) with
    random tables (N 4,096, M 512; the last three on K1's wide route,
    stage by stage: the cluster or the narrow-side kernel, at (384, 300)
    the cluster for all three), and (384, 3) at N 16,384 (its second
    stage on K1's score pass in slabs):
    against its plain version and against the streaming bottleneck's
    three K1 launches, ``e`` and ``r`` within 1e-5, at most 1e-4 of the
    ``zq`` bins differing; one launch a call; the three-pass bound.
13. Training at other widths: ``mnist_28`` at ``embedding_dim=32,
    index_dim=4``, at ``embedding_dim=200, index_dim=3`` (K1 to K3 at
    their 256 instances) and at ``embedding_dim=384`` (their wide
    variants: K1 on its cluster at (384, 384), K2 and K3 also at (384,
    3); elsewhere the narrow-side kernels of K1, K2 and K3), three f32
    Adam steps each through
    ``Trainer`` on the kernels against the same steps on the CPU's plain
    versions, losses within 1e-3, K1, K2 and K3 3 launches a step, the
    device ms of each step on the card from CUDA events logged; and the
    prior phase of
    ``pixelcnn_mnist_28`` with ``prior=Transformer, prior_d_model=512,
    prior_heads=1, prior_attn=flash`` (K5's wide kernels at a head of 512,
    4 launches a step each; K1 3), three prior-only steps the same way;
    and with ``prior_d_model=8320, prior_heads=1, prior_layers=1`` (one
    layer of 830 M parameters, K5's window kernels) at batch 1, three
    prior-only steps on the card against the same steps from the same
    weights with ``prior_attn=blocked`` on the card, losses within 1e-3,
    K5-fwd, K5-dkv and K5-dq 1 launch a step each, K1 3.
14. Serving ``interpolate`` and ``sample`` at full width: ``ffhq_64_scaled``
    with ``Transformer-FFHQ-64.msgpack``, ``max_batch=256``, the
    production path, ``interpolate`` under ``prior=Transformer`` and
    ``sample`` under ``prior=None`` through ``InferenceEngine``, with every
    kernel's count read around the requests (K1 3 and K5-fwd 4 a call;
    K1 1 a call); images/s and stage times; then the f32 path against
    ``SERVING_GOLDENS``: the interpolation of the ``ffhq64_synthetic4``
    batch with its reverse (its grid's flipped bins counted) and the
    decode of the committed grid.
15. The Transformer prior's KV-cached decode and ``sample`` (``Transformer-
    FFHQ-64.msgpack``): (a) f32 with TF32 off, ``decode_logits`` of the
    committed grid (B 4, S 867) within 1e-5 normwise of ``forward``
    through K5 (and its logits outside rtol, atol 2e-5 counted), and its bits with f32, bf16, int8 and int4 caches within
    1e-4 (f32) or 1e-3 of ``DECODE_GOLDENS``; (b) ``sample(4, _gumbel=...)``
    on the CUDA graphs with the committed noise, f32 and int8 caches, draw
    for draw against JAX's grids (a diverging row only at a printed near
    tie, a top-two margin under 1e-4), every cache row written; (c) the
    graphs against the eager step at 256 samples, int8, bit for bit; (d)
    ``sample`` of 256 through ``InferenceEngine`` on the production path
    (int8 caches), three requests with every kernel's count read around
    each (K1 1 a call, the rest 0), samples/s, the stages' device times,
    each segment's step on its graph and eagerly with its parts (the
    prefix read back as f32, the two cache products), capture time and
    peak memory; the prior alone with bf16 and f32 caches; (e) ``ffhq_128``
    with ``Transformer-FFHQ-128.msgpack``, 64 samples, S 3267, once.
16. The PixelCNN prior: (a) the anchor (``PixelCNN-MNIST-28.msgpack``),
    f32, its bits on the committed grid within 1e-4 and
    ``forward(fit_prior=True)`` on the golden digits within 1e-3 of
    ``PIXELCNN_GOLDENS`` (at most 2 bins of its grid off the committed
    one), and the sampler's step, teacher-forced on a finished grid,
    within 1e-5 normwise of ``forward`` of it, on its graph and eagerly
    alike; (b) ``sample(4, _gumbel=...)`` on the CUDA graphs with the
    committed noise, draw for draw against JAX's grid (a diverging row
    only at a printed near tie), every cell of the grid written (a second
    run with the cells preset to -1 leaves none and draws the same); (c)
    the graphs against the eager step at 256 samples, bit for bit; (d)
    ``PIXELCNN_TRAIN_GOLDEN`` through ``Trainer`` twice, bit for bit, the
    backbone untouched; (e) ``ffhq_64_scaled`` with its own PixelCNN prior
    (fresh from the seed) and the FFHQ-64 checkpoint's backbone, batch
    256, production path: the prior phase as phase 10 (K1 3 a step, K2,
    K3 and K5 none, the loss falling), ``sample`` of 256 through
    ``InferenceEngine`` (three requests, K1 1 a call; samples/s, a pixel
    step's ms on the graph and eagerly, capture s, peak GiB, stage
    times) and ``interpolate`` of 256 pairs (three requests, K1 3 a
    call); (f) ``ffhq_128`` (r 33, 1,089 pixel steps), ``sample`` of 64
    once, draws in [0, 511], every cell written.
17. Data and the multi-GPU layer: (a) the reference's torch checkpoint:
    the MNIST backbone of ``PixelCNN-MNIST-28.msgpack`` under the
    reference's 61 names in a ``.ckpt`` through ``load_reference_checkpoint``,
    every tensor landing, bit for bit the ``.msgpack`` route's state, phase
    3's f32 golden held; (b) ``ffhq_64_scaled`` at batch 256 on the
    production path from 768 ``.npy`` images streamed by
    ``LazyImageFolder`` (prefetch 2), 2 epochs of 2 steps under a one-rank
    NCCL group (``parallel.mesh`` from a ``torchrun`` environment on
    127.0.0.1) with gradient watching, the NaN check and the profiler on:
    K1, K2 and K3 3 launches a step, counted and named in the trace, the
    losses bit for bit those of the in-memory dataset without a group,
    each ``grad_hist`` counting its module's parameters once a step, the
    checkpoint resuming; images/s of both paths and a decoded batch's host
    ms against a step's device ms logged; (c) the pattern-sharded lookup
    (``ShardedStreamLookup``) at 2 and 4 shards in one process on the three
    lookups of a full-width batch (N 73,984, M 4,096) and at 2 shards on
    the wide cluster route (512 -> 512, N 4,096, M 512): forward within
    1e-5 of the unsharded K1, the five gradients within 5e-5 normwise of
    the unsharded K2 and K3, one launch of each a shard.
18. Tooling and launch: (a) ``examples/torch_quickstart.py``'s ``main``
    at its defaults (``pixelcnn_mnist_28``, 512 rendered digits, 3
    epochs, the prior phase in the last; ``impl="cuda"``), K1, K2 and K3
    each launched at least once in it (counted), its three grids written,
    its epoch losses and its recon MSE and aux finite, its seconds logged;
    (b) ``tools/torch_convert_checkpoint.py``: the quickstart's ``.pt`` to
    ``.msgpack``, read back through ``load_msgpack`` and
    ``params_from_jax`` as the ``.pt``'s model state bit for bit, with its
    epoch in ``MNIST-28.meta.json``; and phase 17a's reference ``.ckpt``
    to ``.msgpack``, its 61 tensors bit for bit; (c) ``deploy/torch_job.sh``
    run for real with ``NPROC=1`` on ``mnist_28`` (torchrun, one NCCL rank,
    the production path), one epoch at batch 256 through the extra
    arguments: exit 0, its ``.pt`` written, its epoch's loss finite; the
    phase's wall time logged.
19. The graphed epoch (``Trainer.epoch_step``: the step captured once in
    a CUDA graph a phase and replayed): ``fit`` on data staged on the card,
    2 epochs, against the eager ``train_step`` loop over the same batches
    in the same order, every step's loss, recon and aux (and ``grad_hist``
    and gradient norms where watched), the final parameters, Adam's state
    and the learning rate bit for bit, one capture, the counts read around
    ``fit`` (through the replays): (a) ``mnist_28`` from the golden
    backbone at batch 256 (16 steps an epoch), f32 with TF32 off, K1 to K3
    3 a step; (b) ``ffhq_64_scaled`` at batch 256 on the production path
    with ``watch_gradients``, K1 to K3 3 a step (where two eager runs
    differed, the graph would be held to their spread instead, and the
    record says so); (c) phase 10's Transformer prior phase, K5 4 a step
    each, K1 3; (d) phase 16e's PixelCNN prior phase, K1 3 a step; peak
    GiB of each; (e) logged, no limit: images/s of the graphed and the
    eager epoch, the step's device seconds from
    ``utils.benchmark.device_seconds_per_iter`` and the MFU of each from
    ``utils.flops.train_flops_per_image`` at ``ffhq_64_scaled`` 256 and at
    phase 13's ``mnist_28`` with ``embedding_dim=384`` (batch 256), beside
    the card's name and power limit.
20. The run's wall time (the build included), the kernel summary as one
    JSON line, the card line, and last ``{"ok": true, "device": {...}}``.

Phases 6, 10, 11, 16e, 17b (its in-memory run) and 18a train through the
graphed epoch too (``fit`` on staged data); their limits are unchanged.
The bounds (``bound_ms``) come from ``hopvae_torch/utils/flops.py``.

It imports nothing of JAX or of ``hopvae_tpu``; it exits non-zero, and
prints no result, without a CUDA card or outside the repository.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from hopvae_torch.config import load_config
from hopvae_torch.data import (DECODE_GOLDENS, GOLDENS, PIXELCNN_GOLDENS, PIXELCNN_TRAIN_GOLDEN, PRIOR_GOLDENS,
                               PRIOR_TRAIN_GOLDEN, SERVING_GOLDENS, TRAIN_GOLDEN, get_datasets, golden_grid,
                               golden_input, gumbel_noise, image_stats, interp_grid, pixelcnn_grid, pixelcnn_noise,
                               pixelcnn_sample_grid, sample_grid, synthetic_images, _normalize)
from hopvae_torch.models.hopvae import PRIOR, HopVAE
from hopvae_torch.ops import attention_cuda as ac
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.ops.attention import kernel_causal_attention
from hopvae_torch.ops.bottleneck import LAYERS, streaming_bottleneck
from hopvae_torch.ops.conv import full_f32
from hopvae_torch.ops.hopfield import HopfieldLookup
from hopvae_torch.ops.ste import straight_through_round
from hopvae_torch.parallel import mesh as mesh_lib
from hopvae_torch.serving import InferenceEngine, state_from_checkpoint
from hopvae_torch.train import (Trainer, load_weights, prior_has_parameters, prior_train_golden, profiled,
                                train_golden)
from hopvae_torch.utils import nvcc
from hopvae_torch.utils.benchmark import device_seconds_per_iter
from hopvae_torch.utils.flops import (PEAKS_CARD, SFU_PER_CLOCK_PER_SM, attention_bound, bound, bound_bwd, fused_bound,
                                     mfu, train_flops_per_image)
from hopvae_torch.utils.checkpoint import load_msgpack, load_reference_checkpoint, params_from_jax

ROOT = Path(__file__).resolve().parent
CHECKPOINTS = ROOT / "checkpoints"

OUT_ATOL = 1e-4  # out: f32 sums in another order than cuBLAS's
STAT_RTOL = 1e-5  # m (floored at |m| = 1: it enters only as exp(sc - m)) and l
# |row sum - 1| of the attention rebuilt from the wide K1's m and l with
# torch's exp (rebuilt_rows_err). l sums the kernels' __expf, whose error
# torch's exp does not share: sound builds read 2.4e-7 to 1.05e-6 on an
# H100, the former window kernel among them (PERF.md); l without a tile of
# 32 patterns, or without a rank's sums, reads about 0.1 (the CPU
# emulation at 512 -> 512). The CPU tests hold the emulated kernels, one
# exp on both sides, to 1.5e-7 (tests/test_torch_wide.py).
ROW_SUM_ATOL = 2e-6
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
# forward, three-pass TF32 products summed over up to 867 keys in another
# order than cuBLAS's; dQ, dK and dV of the backward, which also carry the
# cancellation in dP - delta
ATTN_FWD_NORMWISE = 1e-5
ATTN_BWD_NORMWISE = 5e-5
# K4 against its plain version and the streaming bottleneck: e and r max
# abs (r over the tokens whose zq agree), and the share of zq bins that
# differ (a logit on a rounding edge may flip a bin)
FUSED_ATOL = 1e-5
FUSED_ZQ_SHARE = 1e-4
# the pattern-sharded lookup's merged output against the unsharded K1, max
# abs (its backward is held to BWD_NORMWISE)
SHARDED_FWD_ATOL = 1e-5


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


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by name
    (``torch.profiler``, the mean of ``reps`` calls after a warm-up): past
    256, for example, the query build, the split passes, the kernel and
    its finishing sums."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:120]: e.device_time_total / 1e3 / reps for e in prof.key_averages() if e.device_time_total > 0}


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
    log(f"built {stems} in {build_s:.1f} s; each source's nvcc, all started together, in s: "
        f"{json.dumps({stem: round(sec, 1) for stem, sec in nvcc.build_seconds.items()})}")
    for stem in stems:
        entry = ""
        for line in nvcc.build_logs.get(stem, "").splitlines():
            if "Compiling entry function" in line:  # the mangled name carries the template widths
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                log(f"  ptxas {stem} {entry}: {line.strip()}")
    return {"card": card, "build_s": build_s, "exp_per_s": exp_per_s()}


def exp_per_s() -> float:
    """The card's exp rate on the special-function units at its max SM clock."""
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    log(f"{props.multi_processor_count} SMs, max SM clock {clock_hz / 1e6:.0f} MHz")
    return props.multi_processor_count * SFU_PER_CLOCK_PER_SM * clock_hz


# ------------------------------------------------------------ phase 2


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


# (label, N, M, d_in, d_out): widths no config uses, which the CPU tests
# hold against JAX and the kernels take zero-padded to a built instance,
# and a ragged case with neither width a multiple of 8; then widths past
# 256, on the wide variants (on a cluster up to 8192, K1 with both widths
# past 128: 1280 takes slices of 256, 2304 slices of 512; 8320 the window
# kernels); the last two, after the cases before them so as to leave those
# their random tables and inputs, take K1's score pass in slabs (as do
# (8320, 3) at N 4,096, M 64 and at N 256, M 2,048)
WIDTH_CASES = (
    ("width 32x32", 4096, 512, 32, 32),
    ("width 64x4", 4096, 512, 64, 4),
    ("width 128x128", 4096, 512, 128, 128),
    ("width ragged 13x100", 37, 300, 13, 100),
    ("width 256x256", 4096, 512, 256, 256),
    ("width 200x3", 4096, 512, 200, 3),
    ("width ragged 130x250", 37, 300, 130, 250),
    ("wide 512x512", 4096, 512, 512, 512),
    ("wide 384x384", 4096, 512, 384, 384),
    ("wide 384x3", 4096, 512, 384, 3),
    ("wide 3x384", 4096, 512, 3, 384),
    ("wide ragged 300x700", 37, 300, 300, 700),
    ("wide ragged 1280x3", 37, 300, 1280, 3),
    ("wide ragged 1280x300", 37, 300, 1280, 300),
    ("wide ragged 300x2304", 37, 300, 300, 2304),
    ("wide ragged 8320x3", 37, 64, 8320, 3),
    ("wide ragged 3x8320", 37, 64, 3, 8320),
    ("wide ragged 8320x300", 37, 300, 8320, 300),
    ("wide 8320x3 over the cap", 4096, 64, 8320, 3),
    ("wide 8320x3 rounds", 256, 2048, 8320, 3),
    ("wide 8320x8320 over the cap", 256, 256, 8320, 8320),
    ("wide 16x384", 4096, 512, 16, 384),
    ("wide ragged 13x700", 37, 300, 13, 700),
    ("wide 32x384", 4096, 512, 32, 384),
    ("wide ragged 30x2304", 37, 300, 30, 2304),
    ("wide ragged 50x700", 37, 300, 50, 700),
    ("wide 64x384", 4096, 512, 64, 384),
    ("wide 100x384", 4096, 512, 100, 384),
    ("wide full 384x3", 73984, 4096, 384, 3),
    ("wide full 3x384", 73984, 4096, 3, 384),
    ("wide 384x3 over the cap", 16384, 512, 384, 3),
    ("wide 384x3 4096 patterns", 4096, 4096, 384, 3),
    ("wide 300x64", 4096, 512, 300, 64),
)


def kernel_cases(tables: dict) -> list[tuple]:
    """``(label, n, (K, U, s, t), d_in, d_out)`` at the shapes the main
    paths give the kernels: a full-width ffhq_64_scaled batch of 256, an
    MNIST batch of 64, and a ragged case; then the width cases."""
    cases = []
    for tag, n, name in (("ffhq64 b256", 73984, "ffhq"), ("mnist b64", 4096, "mnist"), ("ragged", 37, "ragged")):
        for layer, (d_in, d_out) in zip(("L1", "L2", "L3"), hc.SUPPORTED):
            cases.append((f"{tag} {layer}", n, tables[name][layer], d_in, d_out))
    for label, n, _m, d_in, d_out in WIDTH_CASES:
        cases.append((label, n, tables["widths"][label], d_in, d_out))
    return cases


def case_input(n: int, d_in: int, g: torch.Generator) -> torch.Tensor:
    if d_in == 3:  # the quantized grid zq / (L - 1) that the third lookup reads
        return torch.randint(0, 512, (n, d_in), device="cuda", generator=g).float() / 511
    return torch.randn(n, d_in, device="cuda", generator=g)


def state_query(x, s, t) -> torch.Tensor:
    """``LN(x) * s + t`` in f32: the library call's query."""
    xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    return (xhat * s + t).contiguous()


def lookup_route(d_in: int, d_out: int) -> str:
    """K1's route at these widths: a built instance, the cluster or the
    narrow-side kernel (``hc.kernel_route``, ``hc.on_cluster``)."""
    if hc.kernel_route(d_in, d_out) == "instance":
        return "instance"
    return "cluster" if hc.on_cluster(d_in, d_out) else "narrow"


PLAN_ROUTES = ("instance", "cluster", "narrow", "narrow, split scores", "narrow, split g Uᵀ",
               "narrow, split scores and g Uᵀ", "narrow, score pass in slabs", "narrow, whole window")
SPLITS = {None: "narrow", "scores": "narrow, split scores", "gu": "narrow, split g Uᵀ",
          "scores+gu": "narrow, split scores and g Uᵀ", "slabs": "narrow, score pass in slabs",
          "whole": "narrow, whole window"}


def card_plan(kernel: str, n: int, m: int, d_in: int, d_out: int) -> dict:
    """K1's (``kernel="fwd"``), K2's (``"dx"``) or K3's (``"dku"``) plan at
    these sizes as the built library gives it (its ``_plan`` entry): the
    route, held against ``hc.narrow_split`` (the predicate the CPU tests
    read), and on the narrow-side kernel the card's window (K2's and K3's
    whole window: its staged depth), K1's order and groups, K2's splits of
    the pattern axis and their tiles, K3's chunks of the token tiles, and
    K2's and K3's slabs and rounds of their split
    products and K1's slabs of its score pass (``hc.split_plan``), whose
    scratch (K1's split's too) must fit 64 MiB."""
    stem = {"fwd": "hopfield_stream_fwd", "dx": "hopfield_stream_bwd_dx", "dku": "hopfield_stream_bwd_dku"}[kernel]
    out = (ctypes.c_int * 11)()
    err = getattr(nvcc.load_library(stem), f"{stem}_plan")(n, m, d_in, d_out, out)
    if err != 0:
        raise RuntimeError(f"{stem}_plan{(n, m, d_in, d_out)} failed: cudaError {err}")
    plan = {"route": PLAN_ROUTES[out[0]]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if out[0] >= 2 and kernel == "fwd":
        plan |= {"window": out[1], "group": out[2], "trunc": bool(out[3])}
    elif out[0] >= 2 and kernel == "dx":
        plan |= {"window": out[1], "splits": out[2], "per": out[3]}
    elif out[0] >= 2:
        plan |= {"window": out[1], "dk_tiles": out[2], "dk_chunks": out[3], "du_tiles": out[4], "du_chunks": out[5]}
    if 3 <= out[0] <= 6:
        split = hc.split_plan(kernel, n, m, d_in, d_out)
        slabbed = kernel != "fwd" or out[0] == 6  # K1's split of the scores runs in one piece
        if slabbed:
            plan |= {key: val for key, val in split.items() if key != "scratch_floats"}
        plan["split_mib"] = split["scratch_floats"] * 4 / 2**20
        if not 0 < plan["split_mib"] <= 64 or slabbed and split["slabs"] < 1:
            raise AssertionError(f"{stem}'s split at {(n, m, d_in, d_out)} passes 64 MiB: {plan}")
    if hc.kernel_route(d_in, d_out) == "instance":
        want = "instance"
    elif hc.on_cluster(d_in, d_out):
        want = "cluster"
    else:
        want = SPLITS[hc.narrow_split(kernel, n, m, d_in, d_out, sms)]
    if plan["route"] != want:
        raise AssertionError(f"{stem}'s route at {(n, m, d_in, d_out)} is {plan['route']}, the mirror's {want}")
    return plan


def hashed(shape: tuple, seed: int) -> torch.Tensor:
    """f32 values of about unit variance from an integer hash of their
    index, on the card: the same bits on any machine and any torch."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device="cuda")
    h = (i * 2654435761 + seed * 40503) & 0xFFFFFFFF
    h = ((h ^ (h >> 15)) * 0x45D9F3B) & 0xFFFFFFFF
    h = (h ^ (h >> 13)) & 0xFFFFFF
    return ((h.double() / (1 << 24) - 0.5) * 3.4641016151377544).float().reshape(shape)


# K1 where the narrow-side kernel keeps the former window kernel's order (its depth in the
# window kernels' parts, K2's and K3's order at these widths) and so its
# bits: sha256 of out, m and l on hashed inputs, as the former window kernel
# gave them on an H100 (tools/torch_hopfield_bwd_variants.py with the
# parent's build; PERF.md); at the last four shapes, where the score pass
# in slabs runs, as the one-pass walk it replaced gave them (the variants
# tool, --bits, on the parent's build, which walked there)
PARENT_BITS = {
    (4096, 512, 3, 384): "305634550e59b1f2e95e01495ff99fd80e12b45d73be7340058c108919c2d62c",
    (37, 64, 8320, 3): "856b258606e64cf24d4cde2cd8cc7c5ec3410f8503803e137c4d2a2940bca000",
    (4096, 64, 8320, 3): "675e455d5c2103ee4239a08b6bbc0aaf248e2fe0085dffb8e2ea7ccfe56edd77",
    (256, 2048, 8320, 3): "3e2bb705be0bcd4a036139132342f625289ce69c4d6d8eed9e2007a0a0d94832",
    (16384, 512, 384, 3): "3df1590c1c529b38b25197148b8e1975f08e37d5e112edd8c1104b2558c014ec",
    (4096, 4096, 384, 3): "216486942237db95746c8b651fbd07c345261a27c28c630d1fb7b758caa8fc7f",
}
# K2 and K5-fwd where their narrow-side and split-score kernels keep the former window
# kernels' order: sha256 of K2's (dx, ds, dt) (``backward_bits_args``) and of K5-fwd's
# (out, lse) (``attention_bits_inputs``, scale 1/sqrt(dh)) as the window kernels gave
# them on an H100 (tools/torch_hopfield_bwd_variants.py and
# tools/torch_attention_fwd_variants.py, --bits, on the parent's build; PERF.md); in
# K2's and K3's tables, the last four cases (past a d_in of 256 with d_out at most 128,
# where they left the cluster) as their narrow-side kernels first gave them on an H100,
# the whole window at (384, 3) and (300, 64) and the split scores at (1280, 3), in the
# cluster's order (the variants tool, --bits, on that build; PERF.md)
K2_PARENT_BITS = {
    (4096, 512, 3, 384): "f9337a73088039005b11b77c8029e194d74aae39ab258ca62a324e0649efc61f",
    (37, 64, 8320, 3): "a94c4182956eae7244b909f8fe2995acd33249152c62ab3842222e3bcefe7155",
    (37, 64, 3, 8320): "262b1310388edb42fd6c0259dee6459479ad3bdc514cbb628ed9e75e7ad07da6",
    (37, 300, 8320, 300): "895ca9f22ae8aabc9ef9db281832646dbe434870e396ed09abfd253a78c3481e",
    (4096, 64, 8320, 3): "b7eb2195009d4a49c66c29e387ce3b869942ec8800a5a479e24c3a080ccc7ba2",
    (4096, 512, 16, 384): "a5b966750733b5e6be62a579d43509cf90c3f2b2419482eba868e2eb1f941211",
    (37, 300, 13, 700): "2057f6949a5becc5c55dd9b83f37938cbd0de7757cefdabf6a08b34208845832",
    (4096, 512, 32, 384): "18c505e6c2ac9392043d2570e7807839970aceeca7b7ebd8dd09c900762728ff",
    (37, 300, 30, 2304): "7f57672988ab64d92554f9d3286c8da1ca475cdaf513d7b69efe4f753f09580e",
    (37, 300, 50, 700): "4d1683284c52b5ec15fe9c91dd180a1e130611aea73a8b7735b9ebf06b76c6c6",
    (4096, 512, 64, 384): "09a207cc49eaf550a7fe806a92209450d29ceaf09dafe6b783aa8b6522804ce4",
    (4096, 512, 100, 384): "bfbc720020b5d7924835c222ef913c07553d3007c04933067e0e0266deca97a5",
    (256, 2048, 8320, 3): "624bbc3514f20cd6193ba031e588345479b875f9919096fe223abbac23b2764d",
    (256, 256, 8320, 8320): "f5372df3ac5dfccd48a35d6da5c2307db136f5c4cb0c5b38c9671138ce9f52b6",
    (4096, 512, 384, 3): "444556b8f0e4e1b5bdcb3d315d46c30c246e9d87f9b9ebb03e1daa1a4e18ea52",
    (16384, 512, 384, 3): "bb888e638e137cba8dfb746c5a123a716920133fecd78abab87d477a1b8878ca",
    (37, 300, 1280, 3): "2a9d35ef90e34ef045d29d1403c43ee872ff35704ab1508c28282caeefdb7dd3",
    (4096, 512, 300, 64): "7a928f3680597fd8a90aff9097cb30c18c456c02369f75e1cf7fdb0260592f8a",
}
# K3 where its split products keep its window walk's order (K3's own orientation, K q^T
# and U g^T, and the walk's chunks of the token axis): sha256 of (dK, dU) on
# ``backward_bits_args`` as the former walk gave them on an H100: at (4096, 64, 8320, 3)
# and (256, 2048, 8320, 3) the parent's build, which walked there (its split scratch past
# 64 MiB); at (37, 64, 8320, 3) and (256, 256, 8320, 8320) the parent's build with its
# split turned off (``SPLIT_BYTES`` 0), whose own split summed q K^T in the other
# orientation (tools/torch_hopfield_bwd_variants.py --bits; PERF.md); the last four as
# K2's last four
K3_PARENT_BITS = {
    (37, 64, 8320, 3): "f12b6f5b1ba5ef7c1788602ace06c3785e3bc737add3e5672bfc82936d2526e7",
    (4096, 64, 8320, 3): "ffab8c4fa56e6c5786db1d306ed1ad9e86d257b505f27ec02766f0f2dc1edf27",
    (256, 2048, 8320, 3): "22f336521df9a1ea080dabe73f8e9d6666670721c6e86efbd22141e551c52118",
    (256, 256, 8320, 8320): "71a92141d186f47271d3f1902825cd261ab03ad68dd28370347dcc5db32ad3fe",
    (4096, 512, 384, 3): "b3151cd0fae42878a5962e4786dd313fc445741cfaaa7165b7b32bebc468996a",
    (16384, 512, 384, 3): "2d064b3df6b639d95da08c83bdbfb20ba8680bf7e9b39f6e7601256765240ffc",
    (37, 300, 1280, 3): "aef41d09e376430699a77d322035e2d434e186fd3b125bfa6a09a44f74818abf",
    (4096, 512, 300, 64): "384fdc4fffffa5b45963c4339143490ee2857a754a5b4d255bef29e46d8d688f",
}
K5_PARENT_BITS = {(2, 37, 1, 8320): "f061f702f318bea0f7bc62bf99f6522a3797a0c27e7ca36c01c63f6641cd4ded",
                  (1, 400, 1, 8320): "83aae70c5162a11f7bf8dd59671a3f10d06465cabb97f9548c51ad0764e867d6"}


def parent_bits_inputs(n: int, m: int, d_in: int, d_out: int) -> tuple:
    """``(x, K, U, s, t)`` of a ``PARENT_BITS`` case, from ``hashed``."""
    x, k, u = hashed((n, d_in), 1), hashed((m, d_in), 2), hashed((m, d_out), 3)
    return x, k, u, 1 + 0.2 * hashed((d_in,), 4), 0.2 * hashed((d_in,), 5)


def backward_bits_args(n: int, m: int, d_in: int, d_out: int) -> tuple:
    """K2's and K3's arguments of a ``K2_PARENT_BITS`` or ``K3_PARENT_BITS`` case: ``parent_bits_inputs``,
    a hashed cotangent, and K1's ``m``, ``l`` and ``delta`` from them."""
    x, k, u, s, t = parent_bits_inputs(n, m, d_in, d_out)
    g = hashed((n, d_out), 6)
    out, m_stat, l_stat = hc.stream_lookup_fwd(x, k, u, s, t)
    return x, k, u, s, t, g, m_stat, l_stat, (g * out).sum(-1, keepdim=True)


def attention_bits_inputs(b: int, s: int, h: int, dh: int) -> tuple:
    """q, k, v of a ``K5_PARENT_BITS`` case, from ``hashed``."""
    return tuple(hashed((b, s, h, dh), seed) for seed in (11, 12, 13))


def lookup_digest(outs) -> str:
    """sha256 of the bytes of a kernel's outputs: K1's ``(out, m, l)``,
    K2's ``(dx, ds, dt)``, K3's ``(dK, dU)``, K5-fwd's ``(out, lse)``."""
    h = hashlib.sha256()
    for a in outs:
        h.update(a.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def tf32(x: torch.Tensor, trunc: bool = False) -> torch.Tensor:
    """f32 values as TF32: rounded as ``cvt.rna`` rounds, or truncated (the
    top 19 bits, as the tensor cores read a small part passed whole)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits if trunc else bits + 0x1000) & -0x2000).view(torch.float32)


def scores_in_order(q: torch.Tensor, k: torch.Tensor, group: int, trunc: bool) -> torch.Tensor:
    """``q Kᵀ`` as the wide kernels sum it: three TF32 passes a k-step of
    8 (small·big, big·small, big·big), each part of 64 columns in a fresh
    sum, the parts of a group of ``group`` columns added in order, the
    groups in order (the cluster's groups are its ranks' slices, the
    window kernels' their chunks of 64); ``trunc``: the small parts
    truncated (the clusters), else rounded."""
    kt = k.T.contiguous()
    qb, kb = tf32(q), tf32(kt)
    qs, ks = tf32(q - qb, trunc), tf32(kt - kb, trunc)
    d = q.shape[1]
    total = None
    for g0 in range(0, d, group):
        rank_sum = None
        for p0 in range(g0, min(g0 + group, d), 64):
            part = torch.zeros(q.shape[0], kt.shape[1], device=q.device)
            for k0 in range(p0, min(p0 + 64, d), 8):
                at = slice(k0, k0 + 8)
                part = part + qs[:, at] @ kb[at]
                part = part + qb[:, at] @ ks[at]
                part = part + qb[:, at] @ kb[at]
            rank_sum = part if rank_sum is None else rank_sum + part
        total = rank_sum if total is None else total + rank_sum
    return total


def rebuilt_rows_err(x, k, s, t, m, l, d_out: int) -> float:
    """max |row sum - 1| of the attention ``exp(beta s - m) / l`` rebuilt
    from K1's ``m`` and ``l`` with the scores summed in K2's and K3's order
    (``hc.score_order``: the cluster's slices, or the window kernels' chunks
    of 64, whatever their routes), in f32 as the CPU tests rebuild it, with
    torch's ``exp``."""
    d_in = x.shape[1]
    q = hc._query(hc._state_ln(x)[0], s, t)
    group, trunc = hc.score_order(d_in, d_out)
    sc = scores_in_order(q, k, hc.PART * group, trunc=trunc)
    a = torch.exp(sc * (1.0 / math.sqrt(d_in)) - m) / l
    return float((a.double().sum(-1) - 1).abs().max())


@parity_mode()
def phase_kernel_vs_plain(env: dict, tables: dict) -> list[dict]:
    """K1 against its plain version at every case, run twice to repeat bit
    for bit. Each row's ``bound_ms`` is the bound of the three TF32 passes
    it runs on the tensor cores; ``bound_f32_ms``, the same FLOPs at the
    f32 rate of the CUDA cores, is context. Each row also carries K1's
    route and build at its widths (past 256 with the cluster where it
    runs) and, past 256, ``rebuilt_rows_err`` of its stats."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, n, (k, u, s, t), d_in, d_out in kernel_cases(tables):
        route = lookup_route(d_in, d_out)
        x = case_input(n, d_in, g)
        with torch.inference_mode():
            out, m, l = hc.stream_lookup_fwd(x, k, u, s, t)
            again = hc.stream_lookup_fwd(x, k, u, s, t)
            torch.cuda.synchronize()
            repeats = all(torch.equal(a, b) for a, b in zip((out, m, l), again))
            ref_out, ref_m, ref_l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
            err = (out - ref_out).abs().max().item()
            m_err = ((m - ref_m).abs() / ref_m.abs().clamp_min(1.0)).max().item()
            l_err = ((l - ref_l).abs() / ref_l).max().item()
            rows_err = rebuilt_rows_err(x, k, s, t, m, l, d_out) if route != "instance" else None
            big = n * k.shape[0] > 1e8
            reps = 10 if big else 50
            call_ms = cuda_ms(lambda: hc.stream_lookup_fwd(x, k, u, s, t), reps)
            plain_ms = cuda_ms(lambda: hc.stream_lookup_fwd_reference(x, k, u, s, t), 3 if big else 20)
            lib_ms, backend = library_ms(state_query(x, s, t), k, u, reps)
            plan = card_plan("fwd", n, k.shape[0], d_in, d_out)
            parts = kernel_ms(lambda: hc.stream_lookup_fwd(x, k, u, s, t), 5) if plan.get("slabs") else {}
        b_ms, b_by = bound(n, k.shape[0], d_in, d_out, env["exp_per_s"], tensor_cores=True)
        f32_ms, f32_by = bound(n, k.shape[0], d_in, d_out, env["exp_per_s"])
        row = {
            "shape": label, "n": n, "m": k.shape[0], "d_in": d_in, "d_out": d_out, "route": route,
            "max_abs_err": err, "m_rel_err": m_err, "l_rel_err": l_err, "rebuilt_row_sum_err": rows_err,
            "repeats_bitwise": repeats,
            "ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "library_backend": backend,
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
            "build": hc.forward_attributes(d_in, d_out), "plan": plan,
        }
        if parts:  # a call's device ms in the query build, the score pass and the kernel
            for key, name in (("query_ms", "build_queries"), ("split_ms", "slab_scores"),
                              ("window_ms", "narrow_kernel")):
                row[key] = sum(ms for kn, ms in parts.items() if name in kn)
        log(json.dumps(row))
        rows.append(row)
        if not (err <= OUT_ATOL and m_err <= STAT_RTOL and l_err <= STAT_RTOL and repeats):
            raise AssertionError(f"kernel disagrees with its plain version at {label}: {row}")
        if rows_err is not None and not rows_err <= ROW_SUM_ATOL:
            raise AssertionError(f"the attention rebuilt from K1's stats does not sum to 1 at {label}: {row}")
    for sizes, want in PARENT_BITS.items():
        with torch.inference_mode():
            got = lookup_digest(hc.stream_lookup_fwd(*parent_bits_inputs(*sizes)))
        log(json.dumps({"parent_bits": sizes, "plan": card_plan("fwd", *sizes), "sha256": got, "held": got == want}))
        if got != want:
            raise AssertionError(f"K1 at {sizes} (N, M, d_in, d_out) lost the former window kernel's bits: {got}, not {want}")
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
    twice and must repeat bit for bit. Each row's ``bound_ms`` is the bound
    of the three TF32 passes the kernels run on the tensor cores;
    ``bound_f32_ms``, the same FLOPs at the f32 rate of the CUDA cores, is
    context. Each row also carries the kernel's build at its widths and
    its plan; where that splits its products past 8192, a call's device ms
    in the split passes (``split_ms``) and the window kernel
    (``window_ms``). Then K2 and K3 on hashed inputs against the digests of
    their former kernels (``K2_PARENT_BITS``, ``K3_PARENT_BITS``)."""
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
            calls = {"dx": hc.stream_bwd_dx, "dku": hc.stream_bwd_dku}
            plains = {"dx": hc.stream_bwd_dx_reference, "dku": hc.stream_bwd_dku_reference}
            times = {kn: (cuda_ms(lambda: calls[kn](*args), reps), cuda_ms(lambda: plains[kn](*args), plain_reps))
                     for kn in calls}
            plans = {kn: card_plan(kn, n, k.shape[0], d_in, d_out) for kn in calls}
            parts = {kn: kernel_ms(lambda: calls[kn](*args), 5) for kn in calls
                     if plans[kn].get("slabs") and max(d_in, d_out) > hc.CLUSTER_MAX}
        lib_ms, backend = library_bwd_ms(state_query(x, s, t), k, u, g, reps)
        for kernel in ("dx", "dku"):
            errs = {nm: normwise(a, b) for nm, a, b in zip(names[kernel], got[kernel], want[kernel])}
            abs_err = max((a - b).abs().max().item() for a, b in zip(got[kernel], want[kernel]))
            repeats = all(torch.equal(a, b) for a, b in zip(got[kernel], again[kernel]))
            b_ms, b_by = bound_bwd(kernel, n, k.shape[0], d_in, d_out, env["exp_per_s"], tensor_cores=True)
            f32_ms, f32_by = bound_bwd(kernel, n, k.shape[0], d_in, d_out, env["exp_per_s"])
            row = {
                "kernel": f"hopfield_stream_bwd_{kernel}", "shape": label, "n": n, "m": k.shape[0],
                "d_in": d_in, "d_out": d_out, "normwise_err": errs, "max_abs_err": abs_err,
                "repeats_bitwise": repeats, "ms": times[kernel][0], "plain_ms": times[kernel][1],
                "library_ms": lib_ms, "library_backend": backend, "bound_ms": b_ms, "bound_by": b_by,
                "bound_f32_ms": f32_ms, "bound_f32_by": f32_by, "build": hc.backward_attributes(kernel, d_in, d_out),
                "plan": plans[kernel],
            }
            if kernel in parts:  # a call's device ms in the split passes and in the window kernel
                row["split_ms"] = sum(ms for name, ms in parts[kernel].items() if "partial_scores" in name or
                                      "sum_groups" in name)
                row["window_ms"] = sum(ms for name, ms in parts[kernel].items() if "narrow_kernel" in name)
            log(json.dumps(row))
            rows.append(row)
            if not (max(errs.values()) <= BWD_NORMWISE and repeats):
                raise AssertionError(f"{row['kernel']} disagrees with its plain version at {label}: {row}")
    for sizes, want in K2_PARENT_BITS.items():
        with torch.inference_mode():
            got = lookup_digest(hc.stream_bwd_dx(*backward_bits_args(*sizes)))
        log(json.dumps({"k2_parent_bits": sizes, "plan": card_plan("dx", *sizes), "sha256": got, "held": got == want}))
        if got != want:
            raise AssertionError(f"K2 at {sizes} (N, M, d_in, d_out) lost its recorded bits: {got}, not {want}")
    for sizes, want in K3_PARENT_BITS.items():
        with torch.inference_mode():
            got = lookup_digest(hc.stream_bwd_dku(*backward_bits_args(*sizes)))
        log(json.dumps({"k3_parent_bits": sizes, "plan": card_plan("dku", *sizes), "sha256": got, "held": got == want}))
        if got != want:
            raise AssertionError(f"K3 at {sizes} (N, M, d_in, d_out) lost its recorded bits: {got}, not {want}")
    return rows


# ------------------------------------------------------------ phase 3


def engine_for(golden: str, **kw) -> InferenceEngine:
    """A reconstruct and encode engine for one entry of ``GOLDENS``."""
    spec = GOLDENS[golden]
    state = state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"]))
    return InferenceEngine(load_config(spec["config"]), state, ops=("reconstruct", "encode"), **kw)


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
        "lr": float(resumed.optimizer.param_groups[0]["lr"]) == float(trainer.optimizer.param_groups[0]["lr"]),
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
        "lr_after": float(trainer.optimizer.param_groups[0]["lr"]),
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
# (label, B, S, heads, dh): the prior at full width, at prior_heads=1, at
# one head of 256, 384 and 512, and small ragged shapes (S a multiple of no
# tile, of one tile, below one) at each of the forward's tile
# configurations (dh up to 64, 128, 256) and at each cluster plan of the
# wide kernels past 256, forward and backward (slices of 128, 256 and 512;
# 16 blocks, a non-portable cluster, at 8192); past 8192 the window kernels
# on scores split over the card (at S 400 in two slabs; at S 2100 each
# slab one query or key tile, its depth chunks in two rounds); "misaligned"
# views take the 4-byte copies
ATTENTION_CASES = (
    ("full B256 S867 h4 dh32", 256, 867, 4, 32),
    ("heads1 B256 S867 h1 dh128", 256, 867, 1, 128),
    ("wide B256 S867 h1 dh256", 256, 867, 1, 256),
    ("wide384 B256 S867 h1 dh384", 256, 867, 1, 384),
    ("wide512 B256 S867 h1 dh512", 256, 867, 1, 512),
    ("ragged S5", 2, 5, 2, 8),
    ("ragged S37", 2, 37, 2, 8),
    ("ragged S48", 2, 48, 2, 8),
    ("ragged S5 dh16", 2, 5, 2, 16),
    ("ragged S37 dh64", 2, 37, 2, 64),
    ("ragged S37 dh256", 2, 37, 1, 256),
    ("ragged S37 dh768", 2, 37, 1, 768),
    ("ragged S37 dh1280", 2, 37, 1, 1280),
    ("ragged S37 dh2560", 2, 37, 1, 2560),
    ("ragged S37 dh8192", 2, 37, 1, 8192),
    ("ragged S37 dh8320", 2, 37, 1, 8320),
    ("ragged S400 dh8320 slabs", 1, 400, 1, 8320),
    ("ragged S37 dh16384", 1, 37, 1, 16384),
    ("ragged S2100 dh8320 rounds", 1, 2100, 1, 8320),
    ("ragged S37 dh384 misaligned", 2, 37, 1, 384),
    ("ragged S37 dh32 misaligned", 2, 37, 2, 32),
)
PADDED_CASE = ("padded B4 S867 h4 dh48", 4, 867, 4, 48)  # prior_d_model=192, 4 heads


ATTENTION_KERNELS = ("fwd", "dkv", "dq")


def attention_inputs(b, s, h, dh, g: torch.Generator, offset: int = 0):
    """q, k, v as strided views of one ``(B, S, 3·h·dh)`` projection, as
    the prior's split gives them, and a contiguous cotangent. ``offset``
    floats before q (and as many more in the row stride) leave the views
    off the 16-byte alignment the backward's 16-byte copies need."""
    qkv = torch.randn(b, s, 3 * h * dh + offset, device="cuda", generator=g)
    q, k, v = (qkv[..., offset + i * h * dh : offset + (i + 1) * h * dh].view(b, s, h, dh) for i in range(3))
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
    inputs, the backward from the kernel's own lse; each kernel runs twice
    and must repeat bit for bit. Each row's ``bound_ms`` (also
    ``bound_tc_ms``) is the bound of the three TF32 passes the kernels run
    on the tensor cores; ``bound_f32_ms``, the same FLOPs at the f32 rate of
    the CUDA cores, is context. Each row also carries the kernel's
    registers, shared bytes and blocks an SM at that width as the card
    reports them."""
    log(json.dumps({"k5_builds": {dh: {kn: ac.forward_attributes(dh) if kn == "fwd" else ac.backward_attributes(kn, dh)
                                       for kn in ATTENTION_KERNELS}
                                  for dh in sorted({*ac.HEAD_DIMS, *(c[4] for c in ATTENTION_CASES)})}}))
    widths = [*hc.SUPPORTED, *((d_in, d_out) for _l, _n, _m, d_in, d_out in WIDTH_CASES)]
    log(json.dumps({"k2_k3_builds": {f"{d_in}x{d_out}": {kn: hc.backward_attributes(kn, d_in, d_out)
                                                          for kn in ("dx", "dku")}
                                     for d_in, d_out in widths}}))
    log(json.dumps({"k1_builds": {f"{d_in}x{d_out}": hc.forward_attributes(d_in, d_out) for d_in, d_out in widths},
                    "k4_builds": {f"{d}x{di}": hc.fused_attributes(d, di) for d, di in FUSED_WIDTHS}}))
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, b, s, h, dh in ATTENTION_CASES:
        q, k, v, g = attention_inputs(b, s, h, dh, gen, offset=1 if "misaligned" in label else 0)
        scale = 1.0 / math.sqrt(dh)
        big = b * h * s * s > 1e8
        reps, plain_reps = (10, 3) if big else (50, 20)
        with torch.inference_mode():
            out, lse = ac.causal_attention_fwd(q, k, v, scale)
            delta = ac.attention_delta(out, g)
            args = (q, k, v, g, lse, delta, scale)
            calls = {"fwd": (lambda: ac.causal_attention_fwd(q, k, v, scale),
                             lambda: ac.causal_attention_fwd_reference(q, k, v, scale)),
                     "dkv": (lambda: ac.causal_attention_bwd_dkv(*args),
                             lambda: ac.causal_attention_bwd_dkv_reference(*args)),
                     "dq": (lambda: (ac.causal_attention_bwd_dq(*args),),
                            lambda: (ac.causal_attention_bwd_dq_reference(*args),))}
            got = {kn: (out, lse) if kn == "fwd" else calls[kn][0]() for kn in ATTENTION_KERNELS}
            again = {kn: calls[kn][0]() for kn in ATTENTION_KERNELS}
            torch.cuda.synchronize()
            repeats = {kn: all(torch.equal(a, c) for a, c in zip(got[kn], again[kn])) for kn in ATTENTION_KERNELS}
            want = {kn: calls[kn][1]() for kn in ATTENTION_KERNELS}
            errs = {kn: [normwise(a, w) for a, w in zip(got[kn], want[kn])] for kn in got}
            abs_errs = {kn: max((a - w).abs().max().item() for a, w in zip(got[kn], want[kn])) for kn in got}
            del want, got, again
            times = {kn: (cuda_ms(calls[kn][0], reps), cuda_ms(calls[kn][1], plain_reps)) for kn in ATTENTION_KERNELS}
            parts = {kn: kernel_ms(calls[kn][0], 5) for kn in ATTENTION_KERNELS} if dh > ac.BWD_WIDE_MAX else {}
        lib = sdpa_causal_ms(q, k, v, g, reps)
        for kn, names in (("fwd", ("out", "lse")), ("dkv", ("dK", "dV")), ("dq", ("dQ",))):
            f32_ms, f32_by = attention_bound(kn, b, s, h, dh, env["exp_per_s"])
            b_ms, b_by = attention_bound(kn, b, s, h, dh, env["exp_per_s"], tensor_cores=True)
            row = {
                "kernel": f"causal_attention_{'fwd' if kn == 'fwd' else 'bwd_' + kn}", "shape": label,
                "b": b, "s": s, "h": h, "dh": dh, "normwise_err": dict(zip(names, errs[kn])),
                "max_abs_err": abs_errs[kn], "repeats_bitwise": repeats[kn],
                "ms": times[kn][0], "plain_ms": times[kn][1],
                "library_ms": lib["fwd_ms"] if kn == "fwd" else lib["bwd_ms"],
                "library_fwd_bwd_ms": lib["fwd_bwd_ms"], "library_backend": lib["backend"],
                "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_f32_ms": f32_ms,
                "bound_f32_by": f32_by,
            }
            row["build"] = ac.forward_attributes(dh) if kn == "fwd" else ac.backward_attributes(kn, dh)
            if dh > ac.BWD_WIDE_MAX:  # the route, and a call's device ms in the split passes and the window kernel
                row["route"] = window_route(kn, b, s, h, dh)
                row["split_ms"] = sum(ms for name, ms in parts[kn].items() if "split_" in name)
                row["window_ms"] = sum(ms for name, ms in parts[kn].items() if "window_kernel" in name)
            log(json.dumps(row))
            rows.append(row)
            limit = ATTN_FWD_NORMWISE if kn == "fwd" else ATTN_BWD_NORMWISE
            if not (max(errs[kn]) <= limit and row["repeats_bitwise"]):
                raise AssertionError(f"{row['kernel']} disagrees with its plain version at {label}: {row}")
        del q, k, v, g, out, lse, delta, args, calls
        torch.cuda.empty_cache()
    for sizes, want in K5_PARENT_BITS.items():
        with torch.inference_mode():
            got = lookup_digest(ac.causal_attention_fwd(*attention_bits_inputs(*sizes), 1 / math.sqrt(sizes[3])))
        log(json.dumps({"k5_fwd_parent_bits": sizes, "route": window_route("fwd", *sizes), "sha256": got,
                        "held": got == want}))
        if got != want:
            raise AssertionError(f"K5-fwd at {sizes} (B, S, heads, dh) lost the former window kernel's bits: {got}, "
                                 f"not {want}")
    rows.append(padded_attention_vs_plain(gen))
    return rows


def window_route(kernel: str, b: int, s: int, h: int, dh: int) -> dict:
    """K5-fwd's, K5-dkv's or K5-dq's route past ``BWD_WIDE_MAX`` as the
    built library plans it: the window kernel on scores split over the card
    first, its slabs and rounds of depth chunks (``ac.split_plan``) and the
    scratch the wrapper allocates (at most 64 MiB)."""
    floats = (ac.forward_workspace(b, s, h, dh) if kernel == "fwd"
              else ac.backward_workspace(b, s, h, dh, kernel))
    route = {"route": "window, split scores", **ac.split_plan(kernel, b, s, h, dh), "scratch_mib": floats * 4 / 2**20}
    if not 0 < route["scratch_mib"] <= 64:
        raise AssertionError(f"K5-{kernel} at {(b, s, h, dh)}: split scratch of {route['scratch_mib']} MiB")
    return route


def padded_attention_vs_plain(gen: torch.Generator) -> dict:
    """A head width the kernels are not built for (48) through the route
    the prior takes on the card: zero-padded to 64, the kernels, the output
    sliced back, the gradients by autograd through the pad and the slice;
    against the plain versions at 48, the backward twice bit for bit."""
    label, b, s, h, dh = PADDED_CASE
    q, k, v, g = attention_inputs(b, s, h, dh, gen)
    scale = 1.0 / math.sqrt(dh)
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    before = ac.causal_attention_fwd.launches
    out = kernel_causal_attention(*leaves, scale)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    again = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    with torch.no_grad():
        want_out, want_lse = ac.causal_attention_fwd_reference(q, k, v, scale)
        want = ac.causal_attention_bwd_reference(q, k, v, want_out, want_lse, g, scale)
    errs = {"out": normwise(out.detach(), want_out), **{n: normwise(a, w) for n, a, w in zip(("dQ", "dK", "dV"), grads, want)}}
    row = {"kernel": "causal_attention (padded 48 -> 64)", "shape": label, "b": b, "s": s, "h": h, "dh": dh,
           "normwise_err": errs, "max_abs_err": max((a - w).abs().max().item() for a, w in zip(grads, want)),
           "repeats_bitwise": all(torch.equal(a, c) for a, c in zip(grads, again)),
           "fwd_launches": ac.causal_attention_fwd.launches - before}
    log(json.dumps(row))
    if not (errs["out"] <= ATTN_FWD_NORMWISE and max(errs.values()) <= ATTN_BWD_NORMWISE and row["repeats_bitwise"]
            and row["fwd_launches"] == 1):
        raise AssertionError(f"the padded route disagrees with the plain versions at {label}: {row}")
    return row


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
    ``stage_ms``. The timed steps do update the prior. Per timed
    repetition it also records the step's device ms, the spin's device ms
    and the host's ms from the spin's launch to the last enqueue: where
    the host takes longer than the spin, the device waits for it inside
    the stages. The host enqueues a step in 13 to 25 ms, but the first
    timed repetition has taken up to 194 ms on an H100's host (and one
    run's stage means imply about 340), so the spin runs about 500 ms."""
    model, opt = trainer.model, trainer.optimizer
    names = ("backbone_forward", "prior_forward", "prior_backward", "adam")
    totals = dict.fromkeys(names, 0.0)
    per_rep = {"step_ms": [], "spin_ms": [], "host_ms": []}
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 2)]
        opt.zero_grad(set_to_none=True)
        ev[-1].record()
        torch.cuda._sleep(1_000_000_000)
        t0 = time.perf_counter()
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
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        for a, name in enumerate(names):
            totals[name] += ev[a].elapsed_time(ev[a + 1]) / reps
        per_rep["step_ms"].append(ev[0].elapsed_time(ev[4]))
        per_rep["spin_ms"].append(ev[-1].elapsed_time(ev[0]))
        per_rep["host_ms"].append(host_ms)
    opt.zero_grad(set_to_none=True)
    return {**totals, "step_ms": sum(totals.values()), "per_rep": per_rep}


def phase_prior_train_full_width(label: str = "prior_training", **over) -> dict:
    """The prior phase at full width: ``ffhq_64_scaled`` with
    ``prior=Transformer`` and ``prior_start=-1`` from
    ``Transformer-FFHQ-64.msgpack``, batch 256, production path (kernels +
    bf16 conv stacks), 2 epochs through ``Trainer.fit`` on the synthetic
    FFHQ train split. Every kernel's count is set to 0 just before ``fit``
    and read just after: K5's three kernels 4 a step (one per layer; none
    under the PixelCNN prior), K1 3, K2 and K3 none, since the backbone
    runs without autograd. Then a save and a resume, and the per-stage
    device times of one step. ``over`` sets prior keys (phase 11:
    ``prior_d_model=256, prior_heads=1``; phase 16: ``prior="PixelCNN"``,
    fresh from the seed), whose prior the checkpoint does not fit: its
    loss must fall from epoch 1 to epoch 2."""
    cfg = prior_config(prior_start=-1, **over)
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
        "lr": float(resumed.optimizer.param_groups[0]["lr"]) == float(trainer.optimizer.param_groups[0]["lr"]),
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
    prior = trainer.model.prior
    if cfg.prior == "Transformer":
        res["prior"] = {"d_model": prior.d, "heads": prior.heads, "head_width": prior.d // prior.heads}
        layers = prior.n_layers
    else:
        res["prior"] = {"features": prior.features, "res_blocks": prior.n_res}
        layers = 0
    res["prior"]["parameters"] = sum(p.numel() for p in prior.parameters())
    log(json.dumps({label: res}))
    want = {**dict.fromkeys(ATTENTION_COUNTERS, layers * steps), "hopfield_stream_fwd": 3 * steps,
            "hopfield_stream_bwd_dx": 0, "hopfield_stream_bwd_dku": 0}
    if launches != want:
        raise AssertionError(f"expected launches {want} over {steps} prior-phase steps, got {launches}")
    if len(records) != 2 or not all(r["fit_prior"] and math.isfinite(r["train_loss_per_batch"]) for r in records):
        raise AssertionError(f"prior-phase records are missing, not in the prior phase or not finite: {records}")
    if not (all(restored.values()) and frozen):
        raise AssertionError(f"the resume did not restore the trainer, or the backbone moved: {restored}")
    if over and not records[1]["train_loss_per_batch"] < records[0]["train_loss_per_batch"]:
        raise AssertionError(f"the fresh prior's loss did not fall from epoch 1 to epoch 2: {records}")
    return res


# ------------------------------------------------------------ phase 12


# (d, di) of K4's cases: the configs' bottleneck, two widths no config
# uses, which K4 takes zero-padded, and three past 256 (K1's wide route;
# at (384, 300) every stage on the cluster)
FUSED_WIDTHS = ((64, 3), (32, 4), (256, 3), (384, 3), (64, 300), (384, 300))


def fused_cases() -> list[tuple]:
    """``(label, layers, x, num_levels)``: the encoder's tokens of a
    full-width ffhq_64_scaled batch of 256 with the trained tables (N =
    73,984, M = 4096), the MNIST golden digits with the trained MNIST
    tables (N = 3,136, M = 512), random tables of M = 300 on 37 tokens,
    random tables of M = 512 on 4,096 tokens at each other width of
    ``FUSED_WIDTHS``, and the (384, 3) tables on 16,384 tokens."""
    cases = []
    for label, golden, batch in (("ffhq64 b256", "ffhq64_synthetic4", 256), ("mnist b64", "mnist_digits", None)):
        spec = GOLDENS[golden]
        cfg = load_config(spec["config"])
        x = (golden_input(golden) if batch is None
             else _normalize(synthetic_images(batch, cfg.image_size, seed=10), cfg.data_set))
        model = HopVAE(cfg, device="cuda")
        model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"])))
        with torch.inference_mode():
            z = model._encode_to_tokens(torch.from_numpy(x).cuda())
        cases.append((label, model.bottleneck_layers(), z, model.num_levels))
    g = torch.Generator(device="cuda").manual_seed(5)
    layers = {}
    for name, (d_in, d_out) in zip(LAYERS, hc.SUPPORTED):
        layers[name] = HopfieldLookup(d_in, d_out, 300, device="cuda")
        layers[name].reset_parameters(generator=g)
    cases.append(("ragged", layers, torch.randn(37, 64, device="cuda", generator=g), 512))
    tables = {}
    for d, di in FUSED_WIDTHS[1:]:
        tables[d, di] = layers = {}
        for name, (d_in, d_out) in zip(LAYERS, ((d, d), (d, di), (di, d))):
            layers[name] = HopfieldLookup(d_in, d_out, 512, device="cuda")
            layers[name].reset_parameters(generator=g)
        cases.append((f"width {d}x{di}", layers, torch.randn(4096, d, device="cuda", generator=g), 512))
    # (384, 3) again at N 16,384: its second stage, (384, 3), takes K1's score pass in slabs
    cases.append(("width 384x3 over the cap", tables[384, 3], torch.randn(16384, 384, device="cuda", generator=g),
                  512))
    return cases


def bins_and_errors(got, want) -> dict:
    """zq bins that differ, and e's and r's max abs error (r over the
    tokens whose zq agree: a flipped bin moves that token's r)."""
    (e, zq, r), (e_w, zq_w, r_w) = got, want
    same = (zq == zq_w).all(-1)
    return {"zq_bins_differing": int((zq != zq_w).sum()), "zq_share_differing": float((zq != zq_w).float().mean()),
            "tokens_with_a_flipped_bin": int((~same).sum()), "e_max_abs_err": (e - e_w).abs().max().item(),
            "r_max_abs_err": (r - r_w)[same].abs().max().item()}


@parity_mode()
def phase_fused_bottleneck(env: dict) -> list[dict]:
    """K4 against its plain version and the streaming bottleneck (three K1
    launches and the steps between them) on the same tables and tokens;
    one launch a call. At full width the count is set to 0 just before
    the call and read just after: no entry point routes to K4, so this
    call is its path."""
    rows = []
    for label, layers, x, levels in fused_cases():
        args = (*(layers[name] for name in LAYERS), x, levels)
        with torch.inference_mode():
            hc.bottleneck_fused_fwd.launches = 0
            got = hc.bottleneck_fused_fwd(*args)
            torch.cuda.synchronize()
            launches = hc.bottleneck_fused_fwd.launches
            want = hc.bottleneck_fused_fwd_reference(*args)
            stream = streaming_bottleneck(layers, x, levels, impl="cuda")
            vs_plain, vs_stream = bins_and_errors(got, want), bins_and_errors(got, stream)
            again = hc.bottleneck_fused_fwd(*args)
            repeats = all(torch.equal(a, b) for a, b in zip(got, again))
            big = x.numel() > 1e6
            reps, plain_reps = (10, 3) if big else (50, 20)
            times = {"ms": cuda_ms(lambda: hc.bottleneck_fused_fwd(*args), reps),
                     "plain_ms": cuda_ms(lambda: hc.bottleneck_fused_fwd_reference(*args), plain_reps),
                     "three_k1_ms": cuda_ms(lambda: streaming_bottleneck(layers, x, levels, impl="cuda"), reps)}
        d, di = hc.fused_widths([layers[name] for name in LAYERS])
        n = x.numel() // d
        b_ms, b_by = fused_bound(n, [layers[name] for name in LAYERS], env["exp_per_s"], tensor_cores=True)
        f32_ms, f32_by = fused_bound(n, [layers[name] for name in LAYERS], env["exp_per_s"])
        row = {"kernel": "hopfield_bottleneck_fused", "shape": label, "n": n, "d": d, "di": di,
               "m": layers["hopfield"].lookup_weights.shape[0], "launches": launches, "vs_plain": vs_plain,
               "vs_three_k1": vs_stream, "repeats_bitwise": repeats, **times, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
               "build": hc.fused_attributes(d, di),
               "max_abs_err": max(vs_plain["e_max_abs_err"], vs_plain["r_max_abs_err"])}
        log(json.dumps(row))
        rows.append(row)
        for name, cmp in (("its plain version", vs_plain), ("the three-K1 bottleneck", vs_stream)):
            if not (cmp["e_max_abs_err"] <= FUSED_ATOL and cmp["r_max_abs_err"] <= FUSED_ATOL
                    and cmp["zq_share_differing"] <= FUSED_ZQ_SHARE):
                raise AssertionError(f"K4 disagrees with {name} at {label}: {row}")
        if launches != 1 or not repeats:
            raise AssertionError(f"expected one K4 launch a call, repeating bit for bit: {row}")
    return rows


# ------------------------------------------------------------ phase 13


# (config, overrides, prior phase): the lookups (32, 32), (32, 4), (4, 32);
# (200, 200), (200, 3), (3, 200) at the 256 instances; (384, 384),
# (384, 3), (3, 384) on the wide variants; and the prior phase with one
# head of 512 (K5's wide kernels; S = 8 * 8 * 3 = 192 takes flash only
# when asked)
WIDTH_RUNS = (
    ("mnist_28", {"embedding_dim": 32, "index_dim": 4}, False),
    ("mnist_28", {"embedding_dim": 200, "index_dim": 3}, False),
    ("mnist_28", {"embedding_dim": 384}, False),
    ("pixelcnn_mnist_28", {"prior": "Transformer", "prior_d_model": 512, "prior_heads": 1, "prior_attn": "flash"},
     True),
)
WIDTH_STEPS = 3
WIDTH_LOSS_RTOL = 1e-3  # three f32 Adam steps on the card against the CPU's: the train golden lands within 1.3e-4


def width_steps(model, cfg, x: torch.Tensor, fit_prior: bool) -> tuple[list[float], list[float]]:
    """The loss of each of ``WIDTH_STEPS`` Adam steps through ``Trainer``,
    of the backbone or, with ``fit_prior``, of the prior alone; and, for
    inputs on the card, each step's device ms from CUDA events (the first
    includes the kernels' first launches)."""
    trainer = Trainer(model, cfg)
    trainer.build_optimizer(1, fit_prior=fit_prior)
    losses, ms = [], []
    for _ in range(WIDTH_STEPS):
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        out = trainer.train_step(x)
        if x.is_cuda:
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        losses.append(float(out["loss"]))
    return losses, ms


@parity_mode()
def phase_width_training(config: str, over: dict, fit_prior: bool) -> dict:
    """``config`` with the keys of ``over``, widths no config uses: the
    backbone's lookups at other widths, or a prior with one wide head.
    Random weights from the config's seed, made on the CPU and copied to
    the card; three f32 Adam steps (constant learning rate) on the 64
    committed digits through ``Trainer`` with ``impl="cuda"``, against the
    same steps on CPU tensors through the plain versions (``impl="torch"``).
    The counts are set to 0 just before the card's steps and read just
    after: K1, K2 and K3 launch 3 times a step; in the prior phase K1 3
    times and K5's three kernels once a layer. Each card step's device ms
    is logged (``step_ms``, from CUDA events): a reading, with no limit."""
    cfg = load_config(config)
    for key, val in over.items():
        setattr(cfg, key, val)
    cfg.gamma = 1.0
    torch.manual_seed(cfg.seed)
    cpu = HopVAE(cfg, impl="torch", device="cpu")
    card = HopVAE(cfg, impl="cuda", device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(golden_input("mnist_digits"))
    counters = {**KERNEL_COUNTERS, **ATTENTION_COUNTERS}
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = width_steps(card, cfg, x.cuda(), fit_prior)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    plain, _ = width_steps(cpu, cfg, x, fit_prior)
    rel = [abs(a / b - 1) for a, b in zip(losses, plain)]
    widths = {name: (layer.d_in, layer.out_proj.weight.shape[0]) for name, layer in card.bottleneck_layers().items()}
    res = {"config": {"name": config, **over}, "prior_phase": fit_prior, "lookup_widths": widths, "losses": losses,
           "plain_losses": plain, "loss_rel_err": rel, "launches": launches, "step_ms": step_ms}
    log(json.dumps({"width_training": res}))
    a_step = dict.fromkeys(KERNEL_COUNTERS, 3) | dict.fromkeys(ATTENTION_COUNTERS, 0)
    if fit_prior:
        a_step |= {"hopfield_stream_bwd_dx": 0, "hopfield_stream_bwd_dku": 0}
        a_step |= dict.fromkeys(ATTENTION_COUNTERS, card.prior.n_layers)
    if launches != {name: n * WIDTH_STEPS for name, n in a_step.items()}:
        raise AssertionError(f"expected {a_step} launches a step over {WIDTH_STEPS} steps: {launches}")
    if not all(math.isfinite(v) for v in losses) or max(rel) > WIDTH_LOSS_RTOL:
        raise AssertionError(f"the card's losses {losses} are not within {WIDTH_LOSS_RTOL} of the CPU's {plain}")
    return res


# the prior phase at one head past BWD_WIDE_MAX: an 830 M-parameter layer, held on the card
# against the same steps through the plain attention (prior_attn=blocked), at batch 1
WINDOW_HEAD_RUN = ("pixelcnn_mnist_28", {"prior": "Transformer", "prior_d_model": 8320, "prior_heads": 1,
                                         "prior_layers": 1, "prior_attn": "flash"})
WINDOW_HEAD_BATCH = 1


@parity_mode()
def phase_window_head_prior() -> dict:
    """``WINDOW_HEAD_RUN``: three prior-only f32 Adam steps on the first
    ``WINDOW_HEAD_BATCH`` committed digits through ``Trainer`` with
    ``impl="cuda"``, K5 on its window kernels past ``BWD_WIDE_MAX``; the
    counts set to 0 just before the steps and read just after (K5-fwd,
    K5-dkv and K5-dq once a step, K1 3, K2 and K3 none). Then the same
    steps from the same weights with ``prior_attn=blocked`` on the card
    (K5's plain route; the CPU would hold the layer in host memory): the
    losses within ``WIDTH_LOSS_RTOL``. Each step's device ms logged."""
    config, over = WINDOW_HEAD_RUN
    x = torch.from_numpy(golden_input("mnist_digits"))[:WINDOW_HEAD_BATCH].cuda()
    runs, state = {}, None
    for attn in ("flash", "blocked"):
        cfg = load_config(config)
        for key, val in {**over, "prior_attn": attn}.items():
            setattr(cfg, key, val)
        cfg.gamma = 1.0
        torch.manual_seed(cfg.seed)
        model = HopVAE(cfg, impl="cuda", device="cuda")
        seq = model.prior.seq
        if state is None:
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
            state = None
        for fn in {**KERNEL_COUNTERS, **ATTENTION_COUNTERS}.values():
            fn.launches = 0
        losses, step_ms = width_steps(model, cfg, x, fit_prior=True)
        torch.cuda.synchronize()
        runs[attn] = {"losses": losses, "step_ms": step_ms,
                      "launches": {name: fn.launches for name, fn in {**KERNEL_COUNTERS, **ATTENTION_COUNTERS}.items()}}
        del model
        torch.cuda.empty_cache()
    rel = [abs(a / b - 1) for a, b in zip(runs["flash"]["losses"], runs["blocked"]["losses"])]
    res = {"config": {"name": config, **over}, "batch": WINDOW_HEAD_BATCH, "seq": seq, "losses": runs["flash"]["losses"],
           "blocked_losses": runs["blocked"]["losses"], "loss_rel_err": rel, "launches": runs["flash"]["launches"],
           "step_ms": runs["flash"]["step_ms"], "blocked_step_ms": runs["blocked"]["step_ms"],
           "routes": {kn: window_route(kn, WINDOW_HEAD_BATCH, seq, 1, over["prior_d_model"]) for kn in ATTENTION_KERNELS}}
    log(json.dumps({"window_head_prior": res}))
    a_step = dict.fromkeys(KERNEL_COUNTERS, 3) | dict.fromkeys(ATTENTION_COUNTERS, 1)
    a_step |= {"hopfield_stream_bwd_dx": 0, "hopfield_stream_bwd_dku": 0}
    if res["launches"] != {name: n * WIDTH_STEPS for name, n in a_step.items()}:
        raise AssertionError(f"expected {a_step} launches a step over {WIDTH_STEPS} steps: {res['launches']}")
    if not all(math.isfinite(v) for v in res["losses"]) or max(rel) > WIDTH_LOSS_RTOL:
        raise AssertionError(f"the window kernels' losses {res['losses']} are not within {WIDTH_LOSS_RTOL} of the "
                             f"plain attention's {res['blocked_losses']}")
    return res


# ------------------------------------------------------------ phase 14


def serving_config(prior: str):
    """``ffhq_64_scaled`` with the given prior, for ``PRIOR_GOLDENS``' checkpoint."""
    cfg = load_config(PRIOR_GOLDENS["config"])
    cfg.prior = prior
    return cfg


def spin_and_time(stages, reps: int = 5) -> dict:
    """Device ms of each named stage of ``stages`` (``(name, fn)`` pairs, each
    taking the previous one's result), mean of ``reps`` after one untimed
    pass; a spin kernel of about 200 ms holds the stream while the host
    enqueues, so the events bracket the device work. Returns the times and
    the last stage's result of the untimed pass."""
    totals = dict.fromkeys((name for name, _ in stages), 0.0)
    first = None
    with torch.inference_mode():
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            torch.cuda._sleep(400_000_000)
            ev[0].record()
            val = None
            for a, (_name, fn) in enumerate(stages):
                val = fn(val)
                ev[a + 1].record()
            torch.cuda.synchronize()
            if rep == 0:
                first = val
                continue
            for a, (name, _fn) in enumerate(stages):
                totals[name] += ev[a].elapsed_time(ev[a + 1]) / reps
    return {"stage_ms": totals, "result": first}


def interpolate_stages(model, x, y) -> list:
    """``HopVAE.interpolate`` as timed stages: both encodes, the two
    lookups with the clamp and the round, the prior's reconstruct, the
    third lookup and the decoder."""
    b, r, di, top = x.shape[0], model.representation_dim, model.index_dim, model.num_levels - 1
    return [
        ("encode", lambda _: (model._encode_to_tokens(x) + model._encode_to_tokens(y)) / 2),
        ("lookup_1", lambda z: model._lookup("hopfield", z)),
        ("lookup_2", lambda e: straight_through_round(
            (1.0 - F.relu(1.0 - F.relu(model._lookup("embedding_to_index", e)))) * top)),
        ("prior", lambda zq: model.prior.reconstruct(zq.reshape(b, r, r, di))),
        ("lookup_3", lambda grid: model._lookup("index_to_embedding", (grid / top).reshape(b, r * r, di))),
        ("decoder", model._tokens_to_image),
    ]


def sample_stages(model, n: int, seed: int) -> list:
    """``HopVAE.sample`` as timed stages: the prior's draw, the third
    lookup of ``int(grid) / (L - 1)`` and the decoder."""
    r, di, top = model.representation_dim, model.index_dim, model.num_levels - 1
    gen = torch.Generator(device="cuda")
    return [
        ("prior", lambda _: model.prior.sample(n, generator=gen.manual_seed(seed), device=model.device)),
        ("lookup_3", lambda grid: model._lookup(
            "index_to_embedding", (grid.to(torch.int32).float() / top).reshape(n, r * r, di))),
        ("decoder", model._tokens_to_image),
    ]


def counted(fn):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after: ``(result, ms on the host clock, launches)``."""
    counters = {**KERNEL_COUNTERS, **ATTENTION_COUNTERS, "hopfield_bottleneck_fused": hc.bottleneck_fused_fwd}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, ms, {name: c.launches for name, c in counters.items()}


def phase_serving_modes() -> dict:
    """``interpolate`` (prior=Transformer) and ``sample`` (prior=None)
    through ``InferenceEngine`` at ``max_batch=256`` on the production path,
    with ``Transformer-FFHQ-64.msgpack`` (its prior subtree dropped with a
    lenient-load warning under prior=None): requests of 256, 256 and 100
    pairs, and three seeds of 256 samples, each with the kernels' counts
    read around it; images/s; stage times at 256. Then the f32 path
    against ``SERVING_GOLDENS``."""
    state = state_from_checkpoint(str(CHECKPOINTS / PRIOR_GOLDENS["checkpoint"]))
    cfg_t, cfg_n = serving_config("Transformer"), serving_config("None")
    interp = InferenceEngine(cfg_t, state, max_batch=256, ops=("interpolate",))
    sampler = InferenceEngine(cfg_n, state, max_batch=256, n_sample=256, ops=("sample",))
    n_layers = interp.model.prior.n_layers
    want_interp = {**dict.fromkeys((*KERNEL_COUNTERS, *ATTENTION_COUNTERS, "hopfield_bottleneck_fused"), 0),
                   "hopfield_stream_fwd": 3, "causal_attention_fwd": n_layers}
    want_sample = {**dict.fromkeys(want_interp, 0), "hopfield_stream_fwd": 1}
    requests, wall = [], {"interpolate": 0.0, "sample": 0.0}
    for j, b in enumerate((256, 256, 100)):
        x, y = (_normalize(synthetic_images(b, cfg_t.image_size, seed=s), cfg_t.data_set) for s in (20 + j, 40 + j))
        out, ms, launches = counted(lambda: interp.interpolate(x, y))
        wall["interpolate"] += ms
        requests.append({"op": "interpolate", "batch": b, "ms": ms, "launches": launches,
                         "finite": bool(np.isfinite(out).all()), "shape_ok": out.shape == x.shape})
    for seed in range(3):
        out, ms, launches = counted(lambda: sampler.sample(seed))
        wall["sample"] += ms
        requests.append({"op": "sample", "batch": 256, "seed": seed, "ms": ms, "launches": launches,
                         "finite": bool(np.isfinite(out).all()), "shape_ok": out.shape == (256, 64, 64, 3)})
    x, y = (torch.from_numpy(_normalize(synthetic_images(256, 64, seed=s), "FFHQ")).cuda() for s in (20, 40))
    i_stages = spin_and_time(interpolate_stages(interp.model, x, y))
    s_stages = spin_and_time(sample_stages(sampler.model, 256, 0))
    with torch.inference_mode():
        i_same = torch.equal(i_stages.pop("result"), interp.model.interpolate(x, y))
        s_same = torch.equal(s_stages.pop("result"),
                             sampler.model.sample(256, generator=torch.Generator(device="cuda").manual_seed(0)))
    res = {
        "requests": requests,
        "interpolate_pairs_per_s": 612e3 / wall["interpolate"],
        "samples_per_s": 768e3 / wall["sample"],
        "interpolate_b256": {**i_stages, "composes": i_same},
        "sample_b256": {**s_stages, "composes": s_same},
        "launches_interpolate": requests[0]["launches"], "launches_sample": requests[3]["launches"],
    }
    # the f32 path (kernels, f32 convs) against the JAX goldens
    spec = SERVING_GOLDENS
    x4 = golden_input("ffhq64_synthetic4")
    y4 = x4[::-1].copy()
    with parity_mode():
        f32 = InferenceEngine(cfg_t, state, max_batch=4, compute_dtype=None, ops=("interpolate",))
        f32s = InferenceEngine(cfg_n, state, max_batch=4, n_sample=4, compute_dtype=None, ops=("sample",))
        with torch.inference_mode():
            grid = f32.model.interpolation_grid(torch.from_numpy(x4).cuda(), torch.from_numpy(y4).cuda())
            decoded = f32s.model.decode_grid(torch.from_numpy(golden_grid()).cuda()).cpu().numpy()
        out4 = f32.interpolate(x4, y4)
        sampled = f32s.sample(0)
    flipped = int((grid.cpu().numpy() != interp_grid()).sum())
    i_rel = np.abs(image_stats(out4) / np.asarray(spec["interpolate"]["stats"]) - 1).max()
    d_rel = np.abs(image_stats(decoded) / np.asarray(spec["decode"]["stats"]) - 1).max()
    res["f32_goldens"] = {"interpolate_flipped_bins": flipped, "interpolate_bins": int(grid.numel()),
                          "interpolate_stats_rel_err": float(i_rel), "decode_stats_rel_err": float(d_rel),
                          "sample_finite": bool(np.isfinite(sampled).all())}
    log(json.dumps({"serving_modes": res}))
    bad = [r for r in requests
           if r["launches"] != (want_interp if r["op"] == "interpolate" else want_sample)
           or not (r["finite"] and r["shape_ok"])]
    if bad:
        raise AssertionError(f"expected {want_interp} launches an interpolate and {want_sample} a sample, "
                             f"finite outputs of the request's shape: {bad}")
    if not (i_same and s_same):
        raise AssertionError("the timed stages do not compose to HopVAE.interpolate and HopVAE.sample")
    gold = res["f32_goldens"]
    if flipped > spec["interpolate"]["max_flipped_bins"] or max(i_rel, d_rel) > spec["stats_rtol"]:
        raise AssertionError(f"the f32 path is off SERVING_GOLDENS: {gold}")
    if not gold["sample_finite"]:
        raise AssertionError("the f32 samples are not finite")
    return res


# ------------------------------------------------------------ phase 15


# decode_logits (f32 caches) against forward: JAX's own gate at its tiny
# test sizes is rtol and atol 2e-5 elementwise (tests/test_torch_decode.py
# holds the port to it there); at full width on the trained checkpoint JAX's
# own decode misses it on the CPU (10 of 1.78 M logits, worst 1.6 times the
# bound: a logit near 0 carries the f32 error of hidden states of order 1),
# so the card is held normwise, max|decode - forward| / max|forward|, to
# K5's forward limit (JAX's own is 3.4e-6), and the elementwise count is
# reported beside it
DECODE_TOL = 2e-5
DECODE_NORMWISE = ATTN_FWD_NORMWISE
DECODE_DTYPES = ("float32", "bfloat16", "int8", "int4")


def decode_prior(cache_dtype: str | None = None, config: str = PRIOR_GOLDENS["config"],
                 checkpoint: str = PRIOR_GOLDENS["checkpoint"], **kw) -> HopVAE:
    """A ``HopVAE`` with the Transformer prior and the checkpoint's weights,
    its ``prior_cache_dtype`` as given (else the auto rule)."""
    cfg = load_config(config)
    cfg.prior = "Transformer"
    if cache_dtype is not None:
        cfg.prior_cache_dtype = cache_dtype
    model = HopVAE(cfg, device="cuda", **kw)
    model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / checkpoint)))
    return model.eval()


def graphed(prior, mode: str, b: int, cache_dtype: str):
    """The prior's captured decoder for (mode, batch, cache dtype)."""
    return next(dec for key, dec in prior._graphed.items() if key[:3] == (mode, b, cache_dtype))


def grid_bits(logits: torch.Tensor, grid: torch.Tensor) -> float:
    logp = F.log_softmax(logits.float(), dim=-1)
    return float(-torch.gather(logp, -1, grid.long()[..., None]).mean()) * math.log2(math.e)


def caches_written(dec) -> bool:
    """Every position of every layer's caches holds a row (a step index
    frozen into a graph would write one position and leave the rest 0)."""
    for cache in dec.caches:
        if "ks" in cache and not bool((cache["ks"] > 0).all() and (cache["vs"] > 0).all()):
            return False
        if not all(bool((cache[n].float().abs().amax(dim=-1) > 0).all()) for n in ("k", "v")):
            return False
    return True


def draw_check(prior, noise: torch.Tensor, want: np.ndarray, cache_dtype: str) -> dict:
    """The graph path's draws with ``noise`` against JAX's grid ``want``: rows
    that differ, each with its first differing step and the top-two margin
    of ``logits + noise`` there (teacher-forced on JAX's grid)."""
    got = prior.sample(want.shape[0], _gumbel=noise).cpu().numpy()
    b = want.shape[0]
    rows = []
    for row in np.nonzero((got != want).reshape(b, -1).any(axis=1))[0]:
        t = int(np.argmax(got[row].reshape(-1) != want[row].reshape(-1)))
        logits = prior.decode_logits(torch.from_numpy(want).cuda(), cache_dtype).reshape(b, prior.seq, -1)
        top2 = torch.topk(logits[row, t] + noise[t, row], 2).values
        rows.append({"row": int(row), "first_step": t, "margin": float(top2[0] - top2[1])})
    return {"draws": int(got.size), "differ": int((got != want).sum()), "diverging_rows": rows}


def step_times(dec, reps: int = 12) -> list[dict]:
    """Device ms of one step of each segment: replayed from its graph, run
    eagerly, and its parts over the layers (the caches' prefix read back as
    f32, the two cache products), from CUDA events; the caches are zeroed
    first (the times do not depend on their values)."""
    out = []
    b, prior = dec.batch, dec.prior
    kv, g, dh = prior.kv_heads, prior.heads // prior.kv_heads, prior.d // prior.heads
    for k, (start, stop) in enumerate(dec.segments):
        n = min(reps, stop - start)

        def run(fn):
            dec.reset(start)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(n):
                fn()
            ev[1].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]) / n

        graph_ms = run(dec.graphs[k].replay)
        eager_ms = run(lambda: dec.step(k))
        keys = [c["k"][:, :, :stop].float() for c in dec.caches]
        values = [c["v"][:, :, :stop].float() for c in dec.caches]
        q = torch.randn(b, kv, g, dh, device="cuda")
        att = torch.softmax(torch.randn(b, kv, g, stop, device="cuda"), dim=-1)
        dequant = cuda_ms(lambda: [c[name][:, :, :stop].float() for c in dec.caches for name in ("k", "v")],
                          reps=10)
        qk = cuda_ms(lambda: [torch.matmul(q, kk.transpose(-1, -2)) for kk in keys], reps=10)
        av = cuda_ms(lambda: [torch.matmul(att, vv) for vv in values], reps=10)
        out.append({"segment": k, "positions": stop - start, "prefix": stop, "graph_ms": graph_ms,
                    "eager_ms": eager_ms, "dequant_ms": dequant, "qk_ms": qk, "av_ms": av,
                    "rest_ms": graph_ms - dequant - qk - av})
    return out


def mean_step(steps: list[dict], key: str) -> float:
    """A key of ``step_times`` averaged over the positions (each segment
    weighs its count)."""
    return sum(r[key] * r["positions"] for r in steps) / sum(r["positions"] for r in steps)


def decode_serving(label: str, config: str, checkpoint: str, n: int, requests: int, want: dict) -> dict:
    """``InferenceEngine(ops=("sample",))`` under the Transformer prior on
    the production path (caches ``auto``): its build with the graphs'
    capture, ``requests`` seeded calls with every kernel's count read
    around each, samples/s on the host clock, each segment's step times,
    the draws' range, the caches' rows and the peak memory."""
    cfg = load_config(config)
    cfg.prior = "Transformer"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, state_from_checkpoint(str(CHECKPOINTS / checkpoint)), max_batch=1, n_sample=n,
                          ops=("sample",))
    build_s = time.perf_counter() - t0
    prior = eng.model.prior
    dec = graphed(prior, "sample", n, prior.cache_dtype)
    calls, wall = [], 0.0
    for seed in range(requests):
        out, ms, launches = counted(lambda: eng.sample(seed))
        wall += ms
        calls.append({"seed": seed, "ms": ms, "launches": launches, "finite": bool(np.isfinite(out).all()),
                      "shape_ok": out.shape == (n, cfg.image_size, cfg.image_size, cfg.num_channels)})
    draws_in_range = bool((dec.out >= 0).all() and (dec.out < prior.num_levels).all())
    written = caches_written(dec)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        steps = step_times(dec)
    res = {"config": config, "checkpoint": checkpoint, "batch": n, "seq": prior.seq, "cache_dtype": prior.cache_dtype,
           "segments": len(dec.segments), "engine_build_s": build_s, "capture_s": dec.capture_s,
           "samples_per_s": 1e3 * n * requests / wall, "requests": calls, "draws_in_range": draws_in_range,
           "caches_written": written, "peak_gib": peak / 2**30,
           "step_graph_ms": mean_step(steps, "graph_ms"), "step_eager_ms": mean_step(steps, "eager_ms"),
           "steps": steps}
    bad = [c for c in calls if c["launches"] != want or not (c["finite"] and c["shape_ok"])]
    if bad or not (draws_in_range and written):
        raise AssertionError(f"{label}: expected {want} launches a sample, finite images, draws in range and "
                             f"every cache row written: {bad}, {draws_in_range}, {written}")
    res["engine"] = eng
    return res


@parity_mode()
def phase_decode_checks() -> dict:
    """The Transformer prior's KV-cached decode on the card, f32 with TF32
    off: (a) teacher-forced ``decode_logits`` against ``forward`` through K5,
    and the bits of each cache dtype against ``DECODE_GOLDENS``; (b) the
    graph path's draws with the committed noise against JAX's grids, and
    the caches' rows; (c) graph against eager at batch 256."""
    spec = DECODE_GOLDENS
    res = {}
    prior = decode_prior("float32").prior
    grid = torch.from_numpy(golden_grid()).cuda()
    # (a)
    with torch.inference_mode():
        fwd, _, fwd_launches = counted(lambda: prior(grid))
        dec_logits, _, dec_launches = counted(lambda: prior.decode_logits(grid))
    ratio = (dec_logits - fwd).abs() / (DECODE_TOL + DECODE_TOL * fwd.abs())
    bits = {cdt: grid_bits(prior.decode_logits(grid, cdt), grid) for cdt in DECODE_DTYPES}
    res["teacher_forced"] = {
        "max_abs_err": float((dec_logits - fwd).abs().max()), "normwise_err": normwise(dec_logits, fwd),
        "outside_rtol_atol_2e-5": int((ratio > 1).sum()), "worst_ratio_to_2e-5": float(ratio.max()),
        "logits": dec_logits.numel(), "forward_k5_fwd_launches": fwd_launches["causal_attention_fwd"],
        "decode_launches": {k: v for k, v in dec_launches.items() if v},
        "bits": bits, "jax_bits": spec["bits"],
        "bits_err": {cdt: abs(bits[cdt] - spec["bits"][cdt]) for cdt in DECODE_DTYPES},
    }
    # (b)
    noise = torch.from_numpy(gumbel_noise()).cuda()
    draws = {}
    for cdt in ("float32", "int8"):
        prior.cache_dtype = cdt
        draws[cdt] = draw_check(prior, noise, sample_grid(cdt), cdt)
        draws[cdt]["caches_written"] = caches_written(graphed(prior, "sample", 4, cdt))
    res["draws_vs_jax"] = draws
    # (c)
    prior.cache_dtype = "int8"
    graph_grid = prior.sample(256, generator=torch.Generator(device="cuda").manual_seed(7))
    t0 = time.perf_counter()
    eager_grid = prior.sample(256, generator=torch.Generator(device="cuda").manual_seed(7), eager=True)
    torch.cuda.synchronize()
    res["graph_vs_eager"] = {"batch": 256, "cache_dtype": "int8", "equal": bool(torch.equal(graph_grid, eager_grid)),
                             "eager_s": time.perf_counter() - t0}
    log(json.dumps({"decode_checks": res}))
    tf = res["teacher_forced"]
    if tf["normwise_err"] > DECODE_NORMWISE or tf["forward_k5_fwd_launches"] != 4 or tf["decode_launches"]:
        raise AssertionError(f"decode_logits is off forward through K5 (normwise {DECODE_NORMWISE}), or the "
                             f"launches are not K5-fwd 4 for forward and none for the decode: {tf}")
    off = {cdt: e for cdt, e in tf["bits_err"].items() if e > spec["bits_atol"][cdt]}
    if off:
        raise AssertionError(f"decode bits off DECODE_GOLDENS: {off}")
    for cdt, d in draws.items():
        ties = [r for r in d["diverging_rows"] if r["margin"] >= spec["near_tie"]]
        if ties or not d["caches_written"]:
            raise AssertionError(f"{cdt} draws off JAX's grid away from a near tie, or cache rows unwritten: {d}")
    if not res["graph_vs_eager"]["equal"]:
        raise AssertionError("the graph path's draws differ from the eager path's")
    return res


def phase_decode_serving() -> dict:
    """``sample`` under the Transformer prior on the production path (bf16
    convs, K1; matmuls in f32, torch's default): (d) ffhq_64_scaled at 256
    samples a call through ``InferenceEngine`` (int8 caches, auto), three
    requests with every kernel's count read around each, the stages' device
    times, each segment's step; then the prior alone with bf16 and f32
    caches; (e) ffhq_128 with ``Transformer-FFHQ-128.msgpack`` at 64 a
    call, S 3267, once."""
    want = {**dict.fromkeys((*KERNEL_COUNTERS, *ATTENTION_COUNTERS, "hopfield_bottleneck_fused"), 0),
            "hopfield_stream_fwd": 1}
    serving = decode_serving("ffhq_64_scaled sample", PRIOR_GOLDENS["config"], PRIOR_GOLDENS["checkpoint"], 256, 3,
                             want)
    eng = serving.pop("engine")
    stages = spin_and_time(sample_stages(eng.model, 256, 0), reps=2)
    with torch.inference_mode():
        same = torch.equal(stages.pop("result"),
                           eng.model.sample(256, generator=torch.Generator(device="cuda").manual_seed(0)))
    serving["stage_ms"], serving["stages_compose"] = stages["stage_ms"], same
    del eng
    by_dtype = {}
    for cdt in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats()
        prior = decode_prior(cdt).prior
        gen = torch.Generator(device="cuda")
        prior.sample(256, generator=gen.manual_seed(0))  # captures the graphs
        torch.cuda.synchronize()  # sample returns before its replays end
        t0 = time.perf_counter()
        prior.sample(256, generator=gen.manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dec = graphed(prior, "sample", 256, cdt)
        with torch.inference_mode():
            steps = step_times(dec)
        by_dtype[cdt] = {"prior_samples_per_s": 256 / wall, "capture_s": dec.capture_s,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "step_graph_ms": mean_step(steps, "graph_ms"), "step_eager_ms": mean_step(steps, "eager_ms"),
                         "steps": steps}
        del prior, dec
    serving["prior_only"] = by_dtype
    log(json.dumps({"decode_serving": serving}))
    if not same:
        raise AssertionError("the timed stages do not compose to HopVAE.sample")
    large = decode_serving("ffhq_128 sample", "ffhq_128", "Transformer-FFHQ-128.msgpack", 64, 1, want)
    del large["engine"]
    log(json.dumps({"decode_ffhq128": large}))
    return {"serving": serving, "ffhq128": large, "launches_sample": serving["requests"][0]["launches"]}


# ------------------------------------------------------------ phase 16


# the sampler's teacher-forced logits (its step on a finished grid) against
# forward of that grid, max|a - b| / max|b|: the invariant that makes the
# column-incremental sampler exact (tests/test_pixelcnn_fast_sampler.py
# pins it for JAX); the CPU port lands 6e-8 absolute
PIXELCNN_STEP_NORMWISE = 1e-5


def pixelcnn_anchor(**kw) -> HopVAE:
    """The anchor: ``pixelcnn_mnist_28`` with ``PixelCNN-MNIST-28.msgpack``."""
    spec = PIXELCNN_GOLDENS
    model = HopVAE(load_config(spec["config"]), device="cuda", **kw)
    model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"])))
    return model.eval()


def written(prior, mode: str, b: int, run) -> dict:
    """Run ``run()`` again with the grid's cells preset to -1 by the
    captured sampler of (``mode``, ``b``)'s reset: every cell must be
    overwritten (a pixel index frozen into the graph would leave cells at
    -1), and the result must equal the first run's (the preset reaches no
    logit). Also the step index after the run, which must be r², and
    whether both cache planes of every block hold a vector at every
    column."""
    sampler = prior._samplers[(mode, b)]
    r = prior.representation_dim
    first = run().clone()
    reset = sampler.reset

    def preset():
        reset()
        sampler.grid[:, 3:, 3 : r + 3].fill_(-1.0)

    sampler.reset = preset  # the instance's, over the class's method
    try:
        again = run().clone()
    finally:
        del sampler.reset
    cells = sampler.grid[:, 3:, 3 : r + 3]
    return {"cells_written": bool((cells >= 0).all()), "preset_reaches_nothing": bool(torch.equal(first, again)),
            "steps": int(sampler.s), "caches_filled": all(bool((hb[:, :, 1 : r + 1].abs().amax(-1) > 0).all())
                                                          for hb in sampler.hbufs)}


def pixel_step_ms(sampler, reps: int = 2) -> dict:
    """Device ms of one pixel step, replayed from its graph and run eagerly,
    each over the r² steps of a grid (the noise is whatever the buffer
    holds: the times do not depend on it), mean of ``reps``."""
    r = sampler.prior.representation_dim

    def run(fn):
        total = 0.0
        for _ in range(reps):
            sampler.reset()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(r * r):
                fn()
            ev[1].record()
            torch.cuda.synchronize()
            total += ev[0].elapsed_time(ev[1]) / (r * r) / reps
        return total

    with torch.inference_mode(), full_f32():
        return {"graph_ms": run(sampler.graph.replay), "eager_ms": run(sampler.step)}


@parity_mode()
def phase_pixelcnn_checks() -> dict:
    """The PixelCNN anchor on the card, f32 with TF32 off: (a) its bits on
    the committed grid and ``forward(fit_prior=True)`` on the golden digits
    against ``PIXELCNN_GOLDENS``, and the sampler's step, teacher-forced on
    a finished grid, against ``forward`` of it; (b) ``sample(4)`` with the
    committed noise on the graphs against JAX's draws, every cell written;
    (c) the graphs against the eager step at 256 samples; (d) the
    prior-train golden twice."""
    spec = PIXELCNN_GOLDENS
    res = {}
    model = pixelcnn_anchor(impl="cuda")
    prior = model.prior
    grid = torch.from_numpy(pixelcnn_grid()).cuda()
    x = torch.from_numpy(golden_input(spec["input"])).cuda()
    # (a)
    with torch.inference_mode():
        bits, _, bits_launches = counted(lambda: float(model.prior_bits(grid.reshape(len(grid), -1, grid.shape[-1]))))
        (_, loss), _, loss_launches = counted(lambda: model(x, fit_prior=True))
        _, zq, _ = model.backbone(x)
        finished = prior.sample(4, generator=torch.Generator(device="cuda").manual_seed(3))
        fwd = prior(finished)
        steps = prior.step_logits(finished)
        eager_steps = prior.step_logits(finished, eager=True)
    flipped = int((zq.reshape(grid.shape) != grid).sum())
    res["anchor"] = {
        "bits": bits, "jax_bits": spec["bits"], "bits_rel_err": abs(bits / spec["bits"] - 1),
        "loss": float(loss), "jax_loss": spec["loss"], "loss_rel_err": abs(float(loss) / spec["loss"] - 1),
        "flipped_bins": flipped, "bits_launches": {k: v for k, v in bits_launches.items() if v},
        "fit_prior_launches": {k: v for k, v in loss_launches.items() if v},
        "step_logits_normwise_err": normwise(steps, fwd), "step_logits_max_abs_err": float((steps - fwd).abs().max()),
        "step_logits_graph_equals_eager": bool(torch.equal(steps, eager_steps)),
    }
    # (b)
    noise = torch.from_numpy(pixelcnn_noise()).cuda()
    want = pixelcnn_sample_grid()
    got = prior.sample(4, _gumbel=noise).cpu().numpy()
    rows = []
    if (got != want).any():
        with torch.inference_mode():
            logits = prior.step_logits(torch.from_numpy(want).cuda())  # (B, r, r, C, L)
        r, c = prior.representation_dim, prior.index_dim
        for row in np.nonzero((got != want).reshape(4, -1).any(axis=1))[0]:
            t = int(np.argmax(got[row].reshape(-1) != want[row].reshape(-1)))
            pix, ch = divmod(t, c)
            y = logits[row].reshape(r * r, c, -1)[pix, ch] + noise[pix, ch, row]
            top2 = torch.topk(y, 2).values
            rows.append({"row": int(row), "first_draw": t, "margin": float(top2[0] - top2[1])})
    res["draws_vs_jax"] = {"draws": int(got.size), "differ": int((got != want).sum()), "diverging_rows": rows,
                           **written(prior, "sample", 4, lambda: prior.sample(4, _gumbel=noise))}
    # (c)
    gen = torch.Generator(device="cuda")
    graph_grid = prior.sample(256, generator=gen.manual_seed(7))
    t0 = time.perf_counter()
    eager_grid = prior.sample(256, generator=gen.manual_seed(7), eager=True)
    torch.cuda.synchronize()
    res["graph_vs_eager"] = {"batch": 256, "equal": bool(torch.equal(graph_grid, eager_grid)),
                             "eager_s": time.perf_counter() - t0}
    # (d)
    gold = PIXELCNN_TRAIN_GOLDEN
    stored = state_from_checkpoint(str(CHECKPOINTS / gold["checkpoint"]))
    start = {k: v for k, v in stored.items() if not k.startswith(PRIOR)}
    runs = [prior_train_golden(str(CHECKPOINTS), device="cuda", impl="cuda", gold=gold) for _ in range(2)]
    (losses, norm, trained), (losses2, norm2, trained2) = runs
    repeats = losses == losses2 and norm == norm2 and all(
        torch.equal(a, b) for a, b in zip(trained.state_dict().values(), trained2.state_dict().values()))
    after = backbone_state(trained)
    frozen = start.keys() == after.keys() and all(torch.equal(start[k], after[k].cpu()) for k in start)
    loss_rel = [abs(a / b - 1) for a, b in zip(losses, gold["losses"])]
    res["train_golden"] = {"losses": losses, "jax_losses": gold["losses"], "loss_rel_err": loss_rel,
                           "grad_norm": norm, "grad_norm_rel_err": abs(norm / gold["grad_norm"] - 1),
                           "repeats_bitwise": repeats, "backbone_bit_identical": frozen}
    log(json.dumps({"pixelcnn_checks": res}))
    a = res["anchor"]
    if a["bits_rel_err"] > spec["bits_rtol"] or a["bits_launches"]:
        raise AssertionError(f"the anchor's bits are off PIXELCNN_GOLDENS, or the prior launched a kernel: {a}")
    if a["loss_rel_err"] > spec["loss_rtol"] or flipped > spec["max_flipped_bins"]:
        raise AssertionError(f"the fit_prior loss or the grid is off PIXELCNN_GOLDENS: {a}")
    if a["fit_prior_launches"] != {"hopfield_stream_fwd": 3}:
        raise AssertionError(f"expected K1 3 launches in forward(fit_prior=True) and no other: {a}")
    if a["step_logits_normwise_err"] > PIXELCNN_STEP_NORMWISE or not a["step_logits_graph_equals_eager"]:
        raise AssertionError(f"the sampler's step logits are off forward (normwise {PIXELCNN_STEP_NORMWISE}), "
                             f"or its graph off its eager step: {a}")
    d = res["draws_vs_jax"]
    ties = [r for r in d["diverging_rows"] if r["margin"] >= spec["near_tie"]]
    r2 = prior.representation_dim**2
    if ties or not (d["cells_written"] and d["preset_reaches_nothing"] and d["caches_filled"] and d["steps"] == r2):
        raise AssertionError(f"draws off JAX's grid away from a near tie, or cells unwritten: {d}")
    if not res["graph_vs_eager"]["equal"]:
        raise AssertionError("the graph path's draws differ from the eager path's")
    t = res["train_golden"]
    if loss_rel[0] > gold["loss0_rtol"] or max(loss_rel) > gold["losses_rtol"] \
            or t["grad_norm_rel_err"] > gold["grad_norm_rtol"]:
        raise AssertionError(f"the PixelCNN prior-train golden is off JAX's: {t}")
    if not (repeats and frozen):
        raise AssertionError(f"the PixelCNN prior-train golden does not repeat, or moved the backbone: {t}")
    return res


def pixelcnn_sampling(label: str, config: str, checkpoint: str, n: int, requests: int) -> dict:
    """``InferenceEngine(ops=("sample",))`` under the config's PixelCNN prior,
    fresh from the config's seed (the checkpoint's backbone; its Transformer
    prior is dropped with a lenient-load warning), production path: its
    build with the graph's capture, ``requests`` seeded calls with every
    kernel's count read around each (K1 1 a call, the rest 0), samples/s on
    the host clock, the draws' range, every cell written, a pixel step's
    device ms on its graph and eagerly, peak memory."""
    cfg = load_config(config)
    torch.manual_seed(cfg.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, state_from_checkpoint(str(CHECKPOINTS / checkpoint)), max_batch=1, n_sample=n,
                          ops=("sample",))
    build_s = time.perf_counter() - t0
    prior = eng.model.prior
    sampler = prior._samplers[("sample", n)]
    want = {**dict.fromkeys((*KERNEL_COUNTERS, *ATTENTION_COUNTERS, "hopfield_bottleneck_fused"), 0),
            "hopfield_stream_fwd": 1}
    calls, wall = [], 0.0
    for seed in range(requests):
        out, ms, launches = counted(lambda: eng.sample(seed))
        wall += ms
        calls.append({"seed": seed, "ms": ms, "launches": launches, "finite": bool(np.isfinite(out).all()),
                      "shape_ok": out.shape == (n, cfg.image_size, cfg.image_size, cfg.num_channels)})
    drawn = sampler.grid[:, 3:, 3 : prior.representation_dim + 3]
    in_range = bool((drawn >= 0).all() and (drawn < prior.num_levels).all())
    gen = torch.Generator(device="cuda")
    check = written(prior, "sample", n, lambda: prior.sample(n, generator=gen.manual_seed(0)))
    peak = torch.cuda.max_memory_allocated()
    res = {"config": config, "batch": n, "pixel_steps": prior.representation_dim**2,
           "features": prior.features, "res_blocks": prior.n_res, "engine_build_s": build_s,
           "capture_s": sampler.capture_s, "samples_per_s": 1e3 * n * requests / wall, "requests": calls,
           "draws_in_range": in_range, **check, "peak_gib": peak / 2**30, **pixel_step_ms(sampler)}
    bad = [c for c in calls if c["launches"] != want or not (c["finite"] and c["shape_ok"])]
    if bad or not (in_range and check["cells_written"] and check["preset_reaches_nothing"]
                   and check["caches_filled"] and check["steps"] == prior.representation_dim**2):
        raise AssertionError(f"{label}: expected {want} launches a sample, finite images, draws in range and every "
                             f"cell written: {bad}, {res}")
    res["engine"] = eng
    return res


def phase_pixelcnn_full_width() -> dict:
    """(e) ffhq_64_scaled with its own PixelCNN prior (96 features, 4
    blocks, fresh from the seed) and the FFHQ-64 checkpoint's backbone,
    batch 256, the production path: the prior phase (2 epochs of
    ``Trainer.fit``, as phase 10: K1 3 a step, K2, K3 and K5 none, the loss
    falling), ``sample`` of 256 through ``InferenceEngine`` (three
    requests, K1 1 a call) with its stages' device times, and
    ``interpolate`` of 256 pairs (three requests, K1 3 a call); (f)
    ``ffhq_128`` (r 33, 1,089 pixel steps), ``sample`` of 64 once."""
    training = phase_prior_train_full_width("pixelcnn_prior_training", prior="PixelCNN")
    serving = pixelcnn_sampling("ffhq_64_scaled sample", "ffhq_64_scaled", GOLDENS["ffhq64_synthetic4"]["checkpoint"],
                                256, 3)
    eng = serving.pop("engine")
    stages = spin_and_time(sample_stages(eng.model, 256, 0), reps=2)
    with torch.inference_mode():
        same = torch.equal(stages.pop("result"),
                           eng.model.sample(256, generator=torch.Generator(device="cuda").manual_seed(0)))
    serving["stage_ms"], serving["stages_compose"] = stages["stage_ms"], same
    state = {k: v for k, v in eng.model.state_dict().items()}
    del eng
    cfg = load_config("ffhq_64_scaled")
    interp = InferenceEngine(cfg, state, max_batch=256, ops=("interpolate",))
    want = {**dict.fromkeys((*KERNEL_COUNTERS, *ATTENTION_COUNTERS, "hopfield_bottleneck_fused"), 0),
            "hopfield_stream_fwd": 3}
    calls, wall = [], 0.0
    for j in range(3):
        x, y = (_normalize(synthetic_images(256, cfg.image_size, seed=s), cfg.data_set) for s in (60 + j, 80 + j))
        out, ms, launches = counted(lambda: interp.interpolate(x, y))
        wall += ms
        calls.append({"batch": 256, "ms": ms, "launches": launches, "finite": bool(np.isfinite(out).all()),
                      "shape_ok": out.shape == x.shape})
    interpolate = {"requests": calls, "pairs_per_s": 768e3 / wall}
    del interp
    large = pixelcnn_sampling("ffhq_128 sample", "ffhq_128", "Transformer-FFHQ-128.msgpack", 64, 1)
    del large["engine"]
    res = {"prior_phase": training, "sample": serving, "interpolate": interpolate, "ffhq128": large}
    log(json.dumps({"pixelcnn_full_width": {k: v for k, v in res.items() if k != "prior_phase"}}))
    bad = [c for c in calls if c["launches"] != want or not (c["finite"] and c["shape_ok"])]
    if bad:
        raise AssertionError(f"expected {want} launches an interpolate and finite images: {bad}")
    if not same:
        raise AssertionError("the timed stages do not compose to HopVAE.sample")
    return {"launches_prior_phase": training["launches"], "launches_sample": serving["requests"][0]["launches"],
            "launches_interpolate": calls[0]["launches"], "steps": training["steps"]}

# ------------------------------------------------------------ phase 17


def reference_key(name: str) -> str:
    """The reference HopVAE's ``state_dict`` name of one of the port's
    backbone tensors: the inverse of ``checkpoint.reference_name``."""
    if m := re.match(r"^(encoder|decoder)\.residual_stack\.layers\.(\d+)\.conv_([ab])\.weight$", name):
        return f"{m[1]}.residual_stack._layers.{m[2]}._block.{1 if m[3] == 'a' else 3}.weight"
    lookup, _, rest = name.partition(".")
    if lookup in LAYERS and rest != "lookup_weights":
        module, _, param = rest.partition(".")
        if module in ("in_proj", "out_proj"):
            return (f"{lookup}.hopfield.association_core.in_proj_{param}" if module == "in_proj"
                    else f"{lookup}.hopfield.association_core.out_proj.{param}")
        norm = {"norm_stored": "norm_stored_pattern", "norm_state": "norm_state_pattern",
                "norm_proj": "norm_pattern_projection"}[module]
        return f"{lookup}.hopfield.{norm}.{param}"
    return name


def write_reference_ckpt(path: Path) -> dict:
    """Write the MNIST backbone of ``PixelCNN-MNIST-28.msgpack`` under the
    reference's 61 names (``lookup_weights`` with its leading axis of 1)
    to ``path``; returns it under the port's names."""
    msgpack = str(CHECKPOINTS / GOLDENS["mnist_digits"]["checkpoint"])
    backbone = {k: v for k, v in state_from_checkpoint(msgpack).items() if not k.startswith(PRIOR)}
    torch.save({reference_key(k): v[None] if k.endswith("lookup_weights") else v for k, v in backbone.items()}, path)
    return backbone


@parity_mode()
def phase_reference_checkpoint(out: Path) -> dict:
    """(a) The reference's torch checkpoint (fault F2): the MNIST backbone
    of ``PixelCNN-MNIST-28.msgpack`` written under the reference's 61 names
    (``lookup_weights`` with its leading axis of 1) to a ``.ckpt``, loaded
    through ``load_reference_checkpoint`` into a fresh ``mnist_28`` model:
    every tensor lands, the state equals the ``.msgpack`` route's bit for
    bit, and the f32 forward holds phase 3's golden."""
    spec = GOLDENS["mnist_digits"]
    msgpack = str(CHECKPOINTS / spec["checkpoint"])
    ckpt = out / "MNIST-28.ckpt"
    backbone = write_reference_ckpt(ckpt)
    cfg = load_config("mnist_28")
    models = []
    for path in (str(ckpt), msgpack):
        torch.manual_seed(cfg.seed)
        model = HopVAE(cfg, impl="cuda", device="cuda")
        models.append((model, load_reference_checkpoint(model, path)))
    (model, dropped), (model_msg, _) = models
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), model_msg.state_dict().values()))
    x = torch.from_numpy(golden_input("mnist_digits")).cuda()
    with torch.inference_mode():
        x_recon, aux = model(x)
    mse, aux = float(torch.mean((x_recon - x) ** 2)), float(aux)
    res = {"tensors": len(backbone), "dropped": dropped, "equals_msgpack_route": same, "recon_mse_f32": mse,
           "aux_f32": aux, "golden": spec["recon_mse"], "golden_aux": spec["aux"]}
    log(json.dumps({"reference_checkpoint": res}))
    if len(backbone) != 61 or dropped or not same:
        raise AssertionError(f"the reference checkpoint did not load as the .msgpack does: {res}")
    if abs(mse / spec["recon_mse"] - 1) > 1e-3 or abs(aux / spec["aux"] - 1) > 2e-2:
        raise AssertionError(f"the reference checkpoint misses the MNIST golden: {res}")
    return res


@contextlib.contextmanager
def torchrun_env():
    """A one-rank ``torchrun`` environment on 127.0.0.1 and a free port,
    the process group joined through ``mesh.init_distributed`` and left,
    and the environment restored, when the block ends."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh_lib.init_distributed()
        try:
            yield mesh_lib.make_mesh()
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class StepMetricsTrainer(Trainer):
    """A ``Trainer`` that keeps each step's metrics (on the device), from
    ``train_step`` and from ``epoch_step`` alike."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.steps = []

    def train_step(self, x):
        out = super().train_step(x)
        self.steps.append(out)
        return out

    def epoch_step(self, fit_prior):
        run = super().epoch_step(fit_prior)

        def recorded(data, rows):
            out = run(data, rows)
            self.steps += [{k: v[i] for k, v in out.items()} for i in range(len(rows))]
            return out

        return recorded

    @property
    def losses(self) -> list:
        return [m["loss"] for m in self.steps]


# the kernels' main launches by name in a torch.profiler trace (K2 and K3
# each also launch a helper: the dx finish, the query build)
TRACE_KERNELS = {"hopfield_stream_fwd": "stream_fwd_kernel", "hopfield_stream_bwd_dx": "stream_bwd_dq_kernel",
                 "hopfield_stream_bwd_dku": "stream_bwd_dku_kernel"}
STREAM_IMAGES = 768  # 537 training files: 2 steps an epoch at batch 256


def trace_kernel_counts(path: Path) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(sym in n for n in names) for k, sym in TRACE_KERNELS.items()}


def phase_streaming_training(out: Path) -> dict:
    """(b) ``ffhq_64_scaled`` at batch 256 on the production path, from a
    folder of ``.npy`` images (``synthetic_images``) streamed by
    ``LazyImageFolder``, 2 epochs of 2 steps under a one-rank NCCL group,
    with ``watch_gradients``, ``debug_nans`` and the profiler on: K1, K2 and
    K3 3 launches a step (counted, and named in the trace); the losses
    equal, bit for bit, those of the same steps without a group on the
    in-memory ``ArrayDataset`` of the same files; each ``grad_hist``
    counts every parameter of its module once a step; the checkpoint rank
    0 wrote resumes. Logged: images/s of the streaming (without the debug
    aids) and the in-memory path, and a decoded batch's host ms against a
    step's device ms."""
    cfg = load_config("ffhq_64_scaled")
    folder = out / "images"
    folder.mkdir()
    for i, img in enumerate(synthetic_images(STREAM_IMAGES, cfg.image_size, seed=cfg.seed)):
        np.save(folder / f"{i:05d}.npy", img)

    def fresh(mesh=None, aids=False):
        torch.manual_seed(cfg.seed)
        model = HopVAE(cfg, impl="cuda", compute_dtype=torch.bfloat16, device="cuda")
        load_weights(model, str(CHECKPOINTS / GOLDENS["ffhq64_synthetic4"]["checkpoint"]))
        trainer = StepMetricsTrainer(model, cfg, mesh)
        trainer.watch_gradients = trainer.debug_nans = aids
        return trainer

    def records(run: Path) -> list:
        return [json.loads(line) for line in open(run / "metrics.jsonl")]

    train_s, _val, test_s = get_datasets(cfg, str(folder), streaming=True)
    train_m, _val, test_m = get_datasets(cfg, str(folder), streaming=False)
    steps = 2 * (len(train_s) // cfg.batch_size)
    with torchrun_env() as mesh:
        checked = fresh(mesh, aids=True)
        for fn in KERNEL_COUNTERS.values():
            fn.launches = 0
        with profiled(str(out / "checked"), cuda=True):
            checked.fit(train_s, test_s, epochs=2, out_dir=str(out / "checked"), eval_every=0, save_every=1)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
        resumed = fresh(mesh)
        resumed.fit(train_s, test_s, epochs=2, out_dir=str(out / "checked"), eval_every=0, save_every=0, resume=True)
        plain = fresh(mesh)
        plain.fit(train_s, test_s, epochs=2, out_dir=str(out / "plain"), eval_every=0, save_every=0)
        x = torch.from_numpy(train_m.images[: cfg.batch_size]).cuda()
        step_ms = cuda_ms(lambda: plain.train_step(x), reps=5)
        idx = np.arange(len(train_s))
        decode_ms = []
        for rep in range(5):
            t0 = time.perf_counter()
            train_s.gather(np.roll(idx, rep * cfg.batch_size)[: cfg.batch_size])
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    memory = fresh()
    memory.fit(train_m, test_m, epochs=2, out_dir=str(out / "memory"), eval_every=0, save_every=0)
    train_s.close()
    traced = trace_kernel_counts(out / "checked" / "trace" / "rank0.trace.json")
    rec = records(out / "checked")
    sizes = {k: sum(p.numel() for p in m.parameters()) for k, m in checked.model.named_children()}
    hist_counts = {k[len("grad_hist/"):]: sum(v) for r in rec for k, v in r.items() if k.startswith("grad_hist/")}
    per_epoch = steps // 2
    hists_ok = set(hist_counts) == {k for k, n in sizes.items() if n} and all(
        sum(r[f"grad_hist/{k}"]) == n * per_epoch for r in rec for k, n in sizes.items() if n)
    same_losses = torch.equal(torch.stack(checked.losses), torch.stack(memory.losses))
    adam, adam_resumed = checked.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    restored = resumed.schedule.last_epoch == checked.schedule.last_epoch == steps and all(
        torch.equal(adam[i][k], adam_resumed[i][k]) for i in adam for k in adam[i]) and all(
        torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(), checked.model.state_dict().values()))
    res = {
        "files": STREAM_IMAGES, "train_files": len(train_s), "steps": steps, "launches": launches,
        "trace_launches": traced, "losses": [float(v) for v in checked.losses],
        "losses_equal_in_memory_bitwise": same_losses, "grad_hist_counts_ok": hists_ok,
        "grad_norm_epochs": [r["grad_norm"] for r in rec], "resume_restores": restored,
        "images_per_s_streaming_epoch_2": records(out / "plain")[-1]["images_per_sec"],
        "images_per_s_in_memory_epoch_2": records(out / "memory")[-1]["images_per_sec"],
        "host_decode_ms_per_batch": decode_ms, "device_step_ms": step_ms, "card": smi("name,power.limit"),
    }
    log(json.dumps({"streaming_training": res}))
    want = dict.fromkeys(KERNEL_COUNTERS, 3 * steps)
    if launches != want or traced != want:
        raise AssertionError(f"expected 3 launches of each kernel a step, counted and traced: {launches}, {traced}")
    if not same_losses:
        raise AssertionError("the streamed steps under the process group do not repeat the in-memory ones bit for bit")
    if not hists_ok:
        raise AssertionError(f"a grad_hist does not count its module's parameters once a step: {hist_counts}, {sizes}")
    if not restored:
        raise AssertionError("the checkpoint rank 0 wrote does not resume")
    return res


# (label, N, tables, d_in, d_out, shard counts): the three lookups of an
# ffhq_64_scaled batch of 256 with the trained tables (M 4,096), and one
# lookup on the wide cluster route (512 -> 512, M 512)
def sharded_cases(tables: dict) -> list[tuple]:
    cases = [(f"ffhq64 b256 {layer}", 73984, tables["ffhq"][layer], d_in, d_out, (2, 4))
             for layer, (d_in, d_out) in zip(("L1", "L2", "L3"), hc.SUPPORTED)]
    cases.append(("wide 512x512", 4096, tables["widths"]["wide 512x512"], 512, 512, (2,)))
    return cases


@parity_mode()
def phase_sharded_lookup(tables: dict) -> list[dict]:
    """(c) The pattern-sharded lookup on one card: ``ShardedStreamLookup``
    over ``LocalShards`` (the model group's reductions over a stacked shard
    axis), K1 on each shard and the merge; the backward K2 and K3 on each
    shard fed the merged stats. Forward within 1e-5 max abs of the
    unsharded K1; ``dx``, ``dK``, ``dU``, ``ds``, ``dt`` within phase 2's
    backward limit (normwise) of the unsharded backward; one launch of K1,
    K2 and K3 a shard."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, n, (k, u, s, t), d_in, d_out, splits in sharded_cases(tables):
        x = case_input(n, d_in, gen)
        g = torch.randn(n, d_out, device="cuda", generator=gen)

        def run(group):
            leaves = [a.detach().clone().requires_grad_() for a in (x, k, u, s, t)]
            y = hc.stream_lookup(*leaves) if group is None else hc.ShardedStreamLookup.apply(*leaves, group)
            y.backward(g)
            torch.cuda.synchronize()
            return y.detach(), [a.grad for a in leaves]

        want, want_grads = run(None)
        for n_shards in splits:
            for fn in KERNEL_COUNTERS.values():
                fn.launches = 0
            got, grads = run(hc.LocalShards(n_shards))
            launches = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
            row = {"shape": label, "n": n, "m": k.shape[0], "d_in": d_in, "d_out": d_out, "shards": n_shards,
                   "route": lookup_route(d_in, d_out), "fwd_max_abs_err": (got - want).abs().max().item(),
                   "bwd_normwise_err": {nm: normwise(a, b) for nm, a, b in
                                        zip(("dx", "dK", "dU", "ds", "dt"), grads, want_grads)},
                   "launches": launches}
            log(json.dumps({"sharded_lookup": row}))
            rows.append(row)
            if row["fwd_max_abs_err"] > SHARDED_FWD_ATOL or max(row["bwd_normwise_err"].values()) > BWD_NORMWISE:
                raise AssertionError(f"the sharded lookup disagrees with the unsharded one: {row}")
            if launches != dict.fromkeys(KERNEL_COUNTERS, n_shards):
                raise AssertionError(f"expected one launch of K1, K2 and K3 a shard: {row}")
    return rows


def phase_parallel_and_data(tables: dict) -> dict:
    """Phase 17: (a), (b) and (c) above, in a scratch directory."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        ref = phase_reference_checkpoint(out)
        streaming = phase_streaming_training(out)
    return {"reference_checkpoint": ref, "streaming": streaming, "sharded": phase_sharded_lookup(tables)}


# ------------------------------------------------------------ phase 18


def script_module(path: Path):
    """A script of the checkout (``examples/``, ``tools/``) as a module: its
    ``main`` is called as the script would call it."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def epoch_records(run: Path) -> list:
    return [r for r in map(json.loads, open(run / "metrics.jsonl")) if "Train Reconstruction Error" in r]


def phase_quickstart(out: Path) -> dict:
    """(a) The quickstart's ``main`` at its defaults, K1 to K3 counted
    around it."""
    quickstart = script_module(ROOT / "examples" / "torch_quickstart.py")
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run = quickstart.main(["--out", str(out / "quickstart")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
    records = epoch_records(out / "quickstart")
    losses = [r["Train Reconstruction Error"] for r in records]
    res = {"seconds": seconds, "launches": launches, "epoch_losses": losses,
           "prior_phase": [bool(r["fit_prior"]) for r in records], "recon_mse": run["recon_mse"], "aux": run["aux"],
           "grids": [os.path.basename(g) for g in run["grids"] if os.path.getsize(g) > 0]}
    log(json.dumps({"quickstart": res}))
    if min(launches.values()) < 1:
        raise AssertionError(f"the quickstart did not run every lookup kernel: {launches}")
    if len(res["grids"]) != 3:
        raise AssertionError(f"the quickstart did not write its three grids: {run['grids']}")
    if res["prior_phase"] != [False, False, True]:
        raise AssertionError(f"the quickstart's prior phase is not its last epoch: {res['prior_phase']}")
    if not all(math.isfinite(v) for v in (*losses, run["recon_mse"], run["aux"])):
        raise AssertionError(f"the quickstart's losses are not finite: {res}")
    return {**res, "checkpoint": run["checkpoint"]}


def phase_convert(out: Path, trained: str) -> dict:
    """(b) The converter: the quickstart's trainer ``.pt`` and the reference
    ``.ckpt`` to ``.msgpack``, read back bit for bit."""
    converter = script_module(ROOT / "tools" / "torch_convert_checkpoint.py")
    t0 = time.perf_counter()
    jax_dir = out / "jax"
    converter.main(["--config", "pixelcnn_mnist_28", "--input", trained,
                    "--output", str(jax_dir / "MNIST-28.ckpt.msgpack")])
    pt = torch.load(trained, map_location="cpu")
    back = params_from_jax(load_msgpack(str(jax_dir / "MNIST-28.ckpt.msgpack")))
    trained_same = back.keys() == pt["model"].keys() and all(torch.equal(back[k], v) for k, v in pt["model"].items())
    meta = json.loads((jax_dir / "MNIST-28.meta.json").read_text())
    backbone = write_reference_ckpt(out / "MNIST-28.ckpt")
    converter.main(["--config", "mnist_28", "--input", str(out / "MNIST-28.ckpt"),
                    "--output", str(out / "MNIST-28.msgpack")])
    ref = params_from_jax(load_msgpack(str(out / "MNIST-28.msgpack")))
    ref_same = ref.keys() == backbone.keys() and all(torch.equal(ref[k], v) for k, v in backbone.items())
    res = {"seconds": time.perf_counter() - t0, "trained_tensors": len(back), "trained_bit_for_bit": trained_same,
           "meta": meta, "epoch": pt["epoch"], "reference_tensors": len(ref), "reference_bit_for_bit": ref_same}
    log(json.dumps({"convert": res}))
    if not trained_same or meta != {"epoch": pt["epoch"]}:
        raise AssertionError(f"the trainer's .pt did not come back from .msgpack bit for bit: {res}")
    if len(ref) != 61 or not ref_same:
        raise AssertionError(f"the reference .ckpt did not come back from .msgpack as its 61 tensors: {res}")
    return res


def run_group(cmd: list, env: dict, timeout: float) -> subprocess.CompletedProcess:
    """Run ``cmd`` in a session of its own; on the timeout kill the whole
    group (torchrun and its ranks), so no process outlives the call."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


LAUNCH_TIMEOUT_S = 300


def phase_launch(out: Path) -> dict:
    """(c) ``deploy/torch_job.sh`` for real: one rank on this card, one epoch
    of ``mnist_28`` at batch 256 on the production path."""
    (out / "mnist").mkdir()  # no MNIST files: the rendered digits
    run = out / "launch"
    cmd = ["bash", str(ROOT / "deploy" / "torch_job.sh"), str(out / "mnist"), "mnist_28", "--",
           "--epochs", "1", "--set", "batch_size=256", "--out", str(run)]
    t0 = time.perf_counter()
    proc = run_group(cmd, {**os.environ, "NPROC": "1"}, LAUNCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    records = epoch_records(run) if (run / "metrics.jsonl").exists() else []
    res = {"seconds": seconds, "returncode": proc.returncode,
           "torchrun": shutil.which("torchrun"),
           "checkpoint": (run / "MNIST-28.pt").exists(), "epochs": len(records),
           "loss": records[-1]["Train Reconstruction Error"] if records else None}
    log(json.dumps({"launch": res}))
    if proc.returncode != 0 or not res["checkpoint"] or res["epochs"] != 1 or not math.isfinite(res["loss"]):
        raise AssertionError(f"deploy/torch_job.sh failed: {res}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return res


def phase_tooling() -> dict:
    """Phase 18: (a), (b) and (c) above, in a scratch directory."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        quickstart = phase_quickstart(out)
        convert = phase_convert(out, quickstart["checkpoint"])
        launch = phase_launch(out)
    res = {"quickstart": quickstart, "convert": convert, "launch": launch, "seconds": time.perf_counter() - t0,
           "card": smi("name,power.limit")}
    log(f"phase 18 (tooling and launch) passed in {res['seconds']:.1f} s on {res['card']}")
    return res



# ------------------------------------------------------------ phase 19


def step_tensors(trainer: Trainer) -> dict:
    """Every step's metrics, the model's state, Adam's state and the
    learning rate, by name: what a graphed and an eager run must agree on."""
    out = {f"step{i}.{k}": v for i, m in enumerate(trainer.steps) for k, v in m.items()}
    out.update({f"model.{k}": v for k, v in trainer.model.state_dict().items()})
    out.update({f"adam.{i}.{k}": v for i, st in trainer.optimizer.state_dict()["state"].items() for k, v in st.items()})
    out["lr"] = trainer.optimizer.param_groups[0]["lr"]
    return out


def diffs(a: dict, b: dict) -> dict:
    """``{name: max |a - b|}`` of the tensors of two ``step_tensors`` that
    are not bit for bit the same (NaNs in the same places count as equal),
    in step order; ``{"names or shapes": inf}`` where those differ."""
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        return {"names or shapes": math.inf}
    out = {}
    for k, x in a.items():
        y = b[k]
        if torch.equal(x, y):
            continue
        d = (x.double() - y.double()).abs()
        if x.is_floating_point():
            d = torch.where(x.isnan() & y.isnan(), 0.0, d.nan_to_num(math.inf))
        if float(d.max()):
            out[k] = float(d.max())
    return out


def eager_epochs(trainer: Trainer, ds, epochs: int, fit_prior: bool) -> list[float]:
    """``fit``'s epochs without ``fit``: a fresh optimizer, then
    ``train_step`` over ``epoch_batches`` (the staged gather, in fit's
    order); the host seconds of each epoch, ended by a synchronize."""
    trainer.build_optimizer(max(len(ds) // trainer.config.batch_size, 1), fit_prior=fit_prior)
    seconds = []
    for epoch in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in trainer.epoch_batches(ds, epoch):
            trainer.train_step(x)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def graphed_fit(trainer: Trainer, ds, counters: dict) -> dict:
    """2 epochs of ``fit`` (no eval, no save), the counts set to 0 just
    before and read just after; its records and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        for fn in counters.values():
            fn.launches = 0
        trainer.fit(ds, ds, epochs=2, out_dir=out, eval_every=0, save_every=0)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        records = [json.loads(line) for line in open(Path(out) / "metrics.jsonl")]
    return {"launches": launches, "records": records, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def graphed_vs_eager(label: str, cfg, make_model, ds, *, watch: bool = False, spread: bool = False) -> dict:
    """``fit`` on the staged ``ds`` (2 epochs through ``epoch_step``, one
    CUDA graph) against the eager ``train_step`` loop over the same batches
    in the same order, each from ``make_model()``: every step's metrics,
    the parameters, Adam's state and the learning rate bit for bit; one
    capture; the kernels' launches a step, counted through the replays.
    ``spread``: where the graph and eager runs differ, a second eager run
    gives the eager path's own spread, and the graph must stay within it."""
    fit_prior = cfg.prior_start < 0 and prior_has_parameters(cfg)
    counters = {**KERNEL_COUNTERS, **ATTENTION_COUNTERS}
    steps = 2 * (len(ds) // cfg.batch_size)
    graphed = StepMetricsTrainer(make_model(), cfg)
    graphed.watch_gradients = watch
    run = graphed_fit(graphed, ds, counters)
    eager = StepMetricsTrainer(make_model(), cfg)
    eager.watch_gradients = watch
    eager_s = eager_epochs(eager, ds, 2, fit_prior)
    ours, theirs = step_tensors(graphed), step_tensors(eager)
    apart = diffs(ours, theirs)
    diff = max(apart.values(), default=0.0)
    res = {"config": label, "steps": steps, "captures": graphed.captures, "launches": run["launches"],
           "watch": watch, "max_diff": diff, "bitwise": diff == 0.0, "first_diffs": dict(list(apart.items())[:6]),
           "tensors_apart": len(apart), "peak_gib": run["peak_gib"],
           "schedule_steps": [graphed.schedule.last_epoch, eager.schedule.last_epoch],
           "images_per_s_graphed": [r["images_per_sec"] for r in run["records"]],
           "images_per_s_eager": [len(ds) // cfg.batch_size * cfg.batch_size / t for t in eager_s],
           "losses": [float(m["loss"]) for m in graphed.steps]}
    if diff:  # the eager path's own spread, for the record (and the limit where ``spread``)
        again = StepMetricsTrainer(make_model(), cfg)
        again.watch_gradients = watch
        eager_epochs(again, ds, 2, fit_prior)
        res["eager_spread"] = max(diffs(theirs, step_tensors(again)).values(), default=0.0)
    log(json.dumps({f"graphed_epoch {label}": res}))
    layers = graphed.model.prior.n_layers if fit_prior and cfg.prior == "Transformer" else 0
    a_step = {"hopfield_stream_fwd": 3, "hopfield_stream_bwd_dx": 0 if fit_prior else 3,
              "hopfield_stream_bwd_dku": 0 if fit_prior else 3, **dict.fromkeys(ATTENTION_COUNTERS, layers)}
    if run["launches"] != {k: n * steps for k, n in a_step.items()}:
        raise AssertionError(f"{label}: expected {a_step} launches a step over {steps} steps: {run['launches']}")
    if graphed.captures != 1 or len(graphed.steps) != steps or graphed.schedule.last_epoch != steps:
        raise AssertionError(f"{label}: expected one capture and {steps} steps: {res}")
    if diff and not (spread and diff <= res["eager_spread"]):
        raise AssertionError(f"{label}: the graphed epochs differ from the eager steps by {diff} "
                             f"(eager spread {res.get('eager_spread')})")
    if not all(math.isfinite(r["train_loss_per_batch"]) for r in run["records"]) or len(run["records"]) != 2:
        raise AssertionError(f"{label}: the graphed fit's records are missing or not finite: {run['records']}")
    return res


def ffhq_production(cfg, checkpoint: str = GOLDENS["ffhq64_synthetic4"]["checkpoint"]):
    """A maker of ``cfg``'s model on the production path (kernels, bf16 conv
    stacks), seeded, warm-started from ``checkpoint``."""
    def make():
        torch.manual_seed(cfg.seed)
        model = HopVAE(cfg, impl="cuda", compute_dtype=torch.bfloat16, device="cuda")
        load_weights(model, str(CHECKPOINTS / checkpoint))
        return model

    return make


def throughput(label: str, cfg, make_model, ds) -> dict:
    """(e) The graphed and the eager epoch's images/s (epoch 2 of 2), the
    step's device seconds from ``utils.benchmark.device_seconds_per_iter``
    (the body of a step chained over one batch, on CUDA graphs of 10 and
    20 steps) and the MFU of each from ``utils.flops.train_flops_per_image``
    against the dense bf16 peak; beside the card's name and power limit.
    Logged, no limit."""
    graphed = Trainer(make_model(), cfg)
    run = graphed_fit(graphed, ds, {})
    eager = Trainer(make_model(), cfg)
    eager_s = eager_epochs(eager, ds, 2, False)
    timed = Trainer(make_model(), cfg)
    timed.build_optimizer(len(ds) // cfg.batch_size)
    x = torch.from_numpy(ds.images[: cfg.batch_size]).cuda()

    def step(x):
        timed._step_core(x)
        return x

    device_s = device_seconds_per_iter(step, x, iters=10, repeats=3)
    per_image = train_flops_per_image(cfg)
    graphed_ips = run["records"][-1]["images_per_sec"]
    eager_ips = len(ds) // cfg.batch_size * cfg.batch_size / eager_s[-1]
    res = {"config": label, "batch": cfg.batch_size, "images_per_s_graphed": graphed_ips,
           "images_per_s_eager": eager_ips, "device_s_per_step": device_s,
           "images_per_s_device": cfg.batch_size / device_s, "train_flops_per_image": per_image,
           "mfu_graphed": mfu(per_image, graphed_ips), "mfu_eager": mfu(per_image, eager_ips),
           "mfu_device": mfu(per_image, cfg.batch_size / device_s), "mfu_peak": PEAKS_CARD,
           "card": smi("name,power.limit")}
    log(json.dumps({f"graphed_epoch_throughput {label}": res}))
    return res


def phase_graphed_epoch() -> dict:
    """Phase 19: the graphed epoch (``Trainer.epoch_step``) against the
    eager steps, then its throughput."""
    t0 = time.perf_counter()
    mnist = load_config("mnist_28")
    mnist.batch_size = 256
    mnist_ds = get_datasets(mnist, None)[0]

    def mnist_golden():
        model = HopVAE(mnist, impl="cuda", device="cuda")
        model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / GOLDENS["mnist_digits"]["checkpoint"])))
        return model

    ffhq = load_config("ffhq_64_scaled")
    ffhq_ds = get_datasets(ffhq, None)[0]
    with parity_mode():
        backbone_f32 = graphed_vs_eager("mnist_28 f32", mnist, mnist_golden, mnist_ds)
    backbone = graphed_vs_eager("ffhq_64_scaled production watch", ffhq, ffhq_production(ffhq), ffhq_ds,
                                watch=True, spread=True)
    transformer = prior_config(prior_start=-1)
    transformer_prior = graphed_vs_eager("ffhq_64_scaled transformer prior", transformer,
                                         ffhq_production(transformer, PRIOR_GOLDENS["checkpoint"]), ffhq_ds)
    pixelcnn = prior_config(prior_start=-1, prior="PixelCNN")
    pixelcnn_prior = graphed_vs_eager("ffhq_64_scaled pixelcnn prior", pixelcnn,
                                      ffhq_production(pixelcnn, PRIOR_GOLDENS["checkpoint"]), ffhq_ds)
    wide = load_config("mnist_28")
    wide.batch_size, wide.embedding_dim = 256, 384

    def wide_model():
        torch.manual_seed(wide.seed)
        return HopVAE(wide, impl="cuda", device="cuda")

    rates = [throughput("ffhq_64_scaled production", ffhq, ffhq_production(ffhq), ffhq_ds),
             throughput("mnist_28 embedding_dim=384 f32", wide, wide_model, mnist_ds)]
    res = {"backbone_f32": backbone_f32, "backbone_production": backbone, "transformer_prior": transformer_prior,
           "pixelcnn_prior": pixelcnn_prior, "throughput": rates, "seconds": time.perf_counter() - t0}
    log(f"phase 19 (the graphed epoch) passed in {res['seconds']:.1f} s on {smi('name,power.limit')}")
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
    "hopfield_bottleneck_fused": "hopvae_tpu/ops/hopfield_pallas.py:115 (_kernel), via _bottleneck_fwd_pallas:185",
}
SOURCES = {
    "causal_attention_fwd": "hopvae_torch/csrc/causal_attention_fwd.cu",
    "causal_attention_bwd_dkv": "hopvae_torch/csrc/causal_attention_bwd.cu",
    "causal_attention_bwd_dq": "hopvae_torch/csrc/causal_attention_bwd.cu",
}
WIDE_HEAD = 256  # phase 11's head width: its own K5 entries in the kernel line


def kernel_summary(name: str, rows: list[dict], launches: int, prefix: str = "ffhq64", **extra) -> dict:
    """One kernel's entry. Times and bounds are those of the rows whose
    shape starts with ``prefix``, summed: by default one full-width
    batch-256 step, its three lookups (``launches`` the count from the
    training run); ``prefix="wide"`` gives the entry of the wide variant,
    its rows past 256 alone, timed at (512, 512), N 4,096."""
    if prefix == "wide":
        rows = [r for r in rows if r["shape"].startswith("wide")]
        prefix = "wide 512x512"
    full = [r for r in rows if r["shape"].startswith(prefix)]
    lib = [r["library_ms"] for r in full]
    return {
        "name": name if prefix.startswith("ffhq64") else f"{name}_wide",
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


def attention_summary(name: str, rows: list[dict], launches: int, group: str = "narrow") -> dict:
    """One K5 kernel's entry: times and bound of one launch at the prior's
    full width (one layer; a step launches it once per layer), errors over
    every shape of its group, ``launches`` from the run that is its path.
    ``group``: ``"narrow"`` the widths up to 128 (the prior-phase run);
    ``"dh256"`` the head width 256 (32-row tiles; phase 11's prior);
    ``"wide"`` the cluster kernels past 256 up to ``BWD_WIDE_MAX``, timed at
    one head of 512 (phase 13's prior), the head of 384 in ``by_width``;
    ``"window"`` the window kernels past it, timed at B 1, S 400, one head
    of 8320 (phase 13's prior of one head of 8320 launches them), each
    shape's route in ``routes``."""
    in_group = {"narrow": lambda dh: dh <= 128, "dh256": lambda dh: dh == WIDE_HEAD,
                "wide": lambda dh: WIDE_HEAD < dh <= ac.BWD_WIDE_MAX, "window": lambda dh: dh > ac.BWD_WIDE_MAX}
    mine = [r for r in rows if r["kernel"] == name and in_group[group](r["dh"])]
    head = {"narrow": "full", "dh256": "wide B256", "wide": "wide512", "window": "ragged S400"}[group]
    full = next(r for r in mine if r["shape"].startswith(head))
    extra = {}
    if group == "wide":
        extra["by_width"] = {r["dh"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "build")}
                             for r in mine if r["b"] == 256}
    if group == "window":
        extra["routes"] = {r["shape"]: r["route"] for r in mine}
    return {
        "name": {"narrow": name, "dh256": f"{name}_dh{WIDE_HEAD}", "wide": f"{name}_wide",
                 "window": f"{name}_window"}[group], "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": full["ms"], "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"], "bound_tc_ms": full["bound_tc_ms"], "bound_f32_ms": full["bound_f32_ms"],
        "build": full["build"],
        "max_normwise_err": max(max(r["normwise_err"].values()) for r in mine),
        "library_fwd_bwd_ms": full["library_fwd_bwd_ms"], "library_backend": full["library_backend"],
        **extra,
        "shapes": mine,
    }


def folded_tables() -> dict:
    """The folded tables ``(K, U, s, t)`` of each lookup: the trained
    FFHQ-64 and MNIST checkpoints, random ones with M = 3000 for the ragged
    case, and random ones for each of ``WIDTH_CASES`` (by its label)."""
    out = {}
    for name, golden in (("ffhq", "ffhq64_synthetic4"), ("mnist", "mnist_digits")):
        spec = GOLDENS[golden]
        model = HopVAE(load_config(spec["config"]), device="cuda")
        model.load_state_dict(state_from_checkpoint(str(CHECKPOINTS / spec["checkpoint"])))
        out[name] = model.bottleneck_layers()
    g = torch.Generator(device="cuda").manual_seed(1)

    def random_layer(d_in, d_out, m):
        layer = HopfieldLookup(d_in, d_out, m, device="cuda")
        layer.reset_parameters(generator=g)
        return layer

    out["ragged"] = {j: random_layer(d_in, d_out, 3000) for j, (d_in, d_out) in enumerate(hc.SUPPORTED)}
    widths = {label: random_layer(d_in, d_out, m) for label, _n, m, d_in, d_out in WIDTH_CASES}
    with torch.inference_mode():
        tables = {
            name: {f"L{j + 1}": tuple(a.contiguous() for a in (k, u, s, t))
                   for j, (k, u, _b, s, t) in enumerate(map(hc.fold_layer, layers.values()))}
            for name, layers in out.items()
        }
        tables["widths"] = {label: tuple(a.contiguous() for i, a in enumerate(hc.fold_layer(layer)) if i != 2)
                            for label, layer in widths.items()}
    return tables


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    wide_training = phase_prior_train_full_width("prior_training_d256_h1", prior_d_model=256, prior_heads=1)
    fused_rows = phase_fused_bottleneck(env)
    width_results = [phase_width_training(*run) for run in WIDTH_RUNS]
    window_head = phase_window_head_prior()
    width_runs = [res["launches"] for res in width_results]
    width_launches = {name: [run[name] for run in width_runs] for name in KERNEL_COUNTERS}
    serving_modes = phase_serving_modes()
    phase_decode_checks()
    decode = phase_decode_serving()
    phase_pixelcnn_checks()
    pixelcnn = phase_pixelcnn_full_width()
    parallel = phase_parallel_and_data(tables)
    phase_tooling()
    graphed = phase_graphed_epoch()
    graph_runs = {k: graphed[k]["launches"] for k in ("backbone_f32", "backbone_production", "transformer_prior",
                                                       "pixelcnn_prior")}
    streamed = parallel["streaming"]["launches"]
    sharded = {f"{r['shape']} x{r['shards']}": r["launches"] for r in parallel["sharded"]}
    modes = {"launches_serving_interpolate": serving_modes["launches_interpolate"],
             "launches_serving_sample": serving_modes["launches_sample"],
             "launches_serving_sample_transformer": decode["launches_sample"],
             "launches_serving_sample_pixelcnn": pixelcnn["launches_sample"],
             "launches_serving_interpolate_pixelcnn": pixelcnn["launches_interpolate"]}
    launches, prior_launches = training["launches"], prior_training["launches"]
    wide_lookup_run, wide_prior_run = width_runs[2], width_runs[3]  # embedding_dim=384; a prior head of 512
    kernels = [kernel_summary("hopfield_stream_fwd", [r for r in rows if not r["shape"].startswith("wide")],
                              launches["hopfield_stream_fwd"],
                              launches_serving=serving["launches"],
                              launches_prior_phase=prior_launches["hopfield_stream_fwd"],
                              launches_pixelcnn_prior_phase=pixelcnn["launches_prior_phase"]["hopfield_stream_fwd"],
                              launches_width_phase=width_launches["hopfield_stream_fwd"],
                              launches_serving_modes={k: v["hopfield_stream_fwd"] for k, v in modes.items()},
                              launches_streaming_training=streamed["hopfield_stream_fwd"],
                              launches_sharded_lookup={k: v["hopfield_stream_fwd"] for k, v in sharded.items()},
                              launches_graphed_epoch={k: v["hopfield_stream_fwd"] for k, v in graph_runs.items()},
                              bound_f32_ms=sum(r["bound_f32_ms"] for r in rows if r["shape"].startswith("ffhq64")),
                              builds={r["shape"]: r["build"] for r in rows if r["shape"].startswith("ffhq64")})]
    kernels.append(kernel_summary("hopfield_stream_fwd", rows, wide_lookup_run["hopfield_stream_fwd"], prefix="wide",
                                  note="launches: phase 13 at embedding_dim=384 (its lookups' routes: phase13_routes)",
                                  routes={r["shape"]: r["route"] for r in rows if r["shape"].startswith("wide")},
                                  phase13_routes={f"{a}x{b}": lookup_route(a, b)
                                                  for a, b in width_results[2]["lookup_widths"].values()},
                                  cluster=hc.forward_attributes(512, 512),
                                  builds={r["shape"]: r["build"] for r in rows if r["shape"].startswith("wide")}))
    for name in ("hopfield_stream_bwd_dx", "hopfield_stream_bwd_dku"):
        mine = [r for r in bwd_rows if r["kernel"] == name]
        narrow = [r for r in mine if not r["shape"].startswith("wide")]
        kernels.append(kernel_summary(name, narrow, launches[name],
                                      max_normwise_err=max(max(r["normwise_err"].values()) for r in narrow),
                                      bound_f32_ms=sum(r["bound_f32_ms"] for r in mine if r["shape"].startswith("ffhq64")),
                                      builds={r["shape"]: r["build"] for r in mine if r["shape"].startswith("ffhq64")},
                                      launches_prior_phase=prior_launches[name],
                                      launches_width_phase=width_launches[name],
                                      launches_streaming_training=streamed[name],
                                      launches_sharded_lookup={k: v[name] for k, v in sharded.items()},
                                      launches_graphed_epoch={k: v[name] for k, v in graph_runs.items()}))
        kernels.append(kernel_summary(name, mine, wide_lookup_run[name], prefix="wide",
                                      note="launches: phase 13 at embedding_dim=384",
                                      max_normwise_err=max(max(r["normwise_err"].values()) for r in mine
                                                           if r["shape"].startswith("wide")),
                                      builds={r["shape"]: r["build"] for r in mine if r["shape"].startswith("wide")}))
    narrow_k5 = [attention_summary(name, attn_rows, prior_launches[name]) for name in ATTENTION_COUNTERS]
    for entry, name in zip(narrow_k5, ATTENTION_COUNTERS):
        entry["launches_graphed_epoch"] = {k: v[name] for k, v in graph_runs.items()}
    narrow_k5[0]["launches_serving_interpolate"] = modes["launches_serving_interpolate"]["causal_attention_fwd"]
    kernels += narrow_k5
    kernels += [attention_summary(name, attn_rows, wide_training["launches"][name], group="dh256")
                for name in ATTENTION_COUNTERS]
    kernels += [attention_summary(name, attn_rows, wide_prior_run[name], group="wide") for name in ATTENTION_COUNTERS]
    kernels += [attention_summary(name, attn_rows, window_head["launches"][name], group="window")
                for name in ATTENTION_COUNTERS]
    for full in (fused_rows[0], next(r for r in fused_rows if r["shape"] == "width 384x3")):
        wide = full["d"] > hc.BUILT_WIDTH
        mine = [r for r in fused_rows if (max(r["d"], r["di"]) > hc.BUILT_WIDTH) == wide]
        kernels.append({
            "name": "hopfield_bottleneck_fused_wide" if wide else "hopfield_bottleneck_fused", "route": "cuda",
            "source": "hopvae_torch/csrc/hopfield_bottleneck_fused.cu",
            "replaces": REPLACES["hopfield_bottleneck_fused"], "launches": full["launches"],
            "note": ("no entry point routes to K4, as in the JAX package; launches counts phase 12's call at "
                     f"{full['shape']}"),
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"], "library_ms": None,
            "bound_f32_ms": full["bound_f32_ms"], "build": full["build"],
            "three_k1_ms": full["three_k1_ms"], "shapes": mine,
        })
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels of a path were launched no time in its run: {missing}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {smi('name,power.limit')}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
