"""Compare builds of the streaming Hopfield kernels K1, K2 and K3 on the card.

    python3 tools/torch_hopfield_bwd_variants.py [--bits] [--shapes LABEL,...] [--no-steps]
        [--full D_INxD_OUT,...] [NAME=CSRC_DIR[:-DFLAG,...] ...]

Builds ``hopfield_stream_fwd.cu``, ``hopfield_stream_bwd_dx.cu`` and
``hopfield_stream_bwd_dku.cu`` from ``hopvae_torch/csrc`` (as ``change``)
and from each ``NAME=CSRC_DIR`` (a copy of that directory elsewhere, for
example a parent commit unpacked with ``git archive``; ``-D`` flags after a
colon) with the port's nvcc flags, prints each build's ptxas registers and
spills, and runs every build twice, in turns, at the shapes of phase 2 of
``chip_smoke.py`` (the trained FFHQ-64 and MNIST tables, a ragged case,
and its width cases, among them (384, 3) and (3, 384) at the full scale
of ffhq_64_scaled) and at 512 -> 512 with random tables at that scale (N
73,984, M 4,096), and at each ``--full`` width pair at that scale (random
tables, labelled ``wide full D_INxD_OUT``), on the same inputs, the row
stats from the plain forward. Per build and shape, one JSON line: K1's and
the backward's normwise errors against the plain versions, whether a
second launch repeats the first bit for bit, whether the outputs equal the
``change`` build's, and each kernel's time (CUDA events) at the large
shapes and every shape past 256 (K1 there through its wide entry, the
query build included), where SDPA's forward on the built q with scale
beta (the library's K1) and one ``torch.autograd.grad`` through SDPA with
the same cotangent (the library's K2 + K3) are timed too, and K1's plain
version (``stream_lookup_fwd_reference``); past 256, below full scale,
each kernel's row also times each kernel its entry launches by name
(``kernel_ms``, ``torch.profiler``; K2's at full scale too). Past 256 (but
at full scale) K1's row also reads ``rebuilt_row_sum_err``, phase 2's
row sums of the attention rebuilt from its ``m`` and ``l``. A build that
refuses a width (cudaErrorInvalidValue) is reported as refusing it. Last, phase 13's
``mnist_28`` at ``embedding_dim=384`` on each build's K1 to K3, in turns,
three rounds: three f32 Adam steps from the same weights, the losses,
each step's ms between CUDA events (host gaps included) and the device's
busy ms a step (``torch.profiler``: every kernel, and the lookups' K1 to
K3 with their passes alone), one JSON line a run. First, and alone with
``--bits``, the sha256 of each build's K2 ``(dx, ds, dt)`` at the cases of
``chip_smoke.K2_PARENT_BITS`` and of its K3 ``(dK, dU)`` at those of
``chip_smoke.K3_PARENT_BITS`` (hashed inputs, K1's stats from the port's
K1), the digests that phase 2 holds the port's K2 and K3 to, after the
sha256 of each build's K1 ``(out, m, l)`` at the cases of
``chip_smoke.PARENT_BITS``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hopvae_torch.ops import hopfield_cuda as hc  # noqa: E402
from hopvae_torch.utils import nvcc  # noqa: E402

STEMS = ("hopfield_stream_fwd", "hopfield_stream_bwd_dx", "hopfield_stream_bwd_dku")
FULL_CASE = ("wide full 512x512", 73984, 4096, 512, 512)  # (label, N, M, d_in, d_out), random tables
WIDTH_ROUNDS = 3  # rounds of phase 13's run on every build, in turns (its steps take the host 10 to 20 ms)


def build(name: str, csrc: Path, flags: list[str], out_dir: str) -> dict:
    libs = {}
    for stem in STEMS:
        out = f"{out_dir}/lib_{name}_{stem}.so"
        proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, *flags, "-o", out, str(csrc / f"{stem}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name} {stem}: nvcc failed\n{proc.stderr[-3000:]}")
        log = (proc.stdout + proc.stderr).splitlines()
        for i, line in enumerate(log):
            if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                entry = next((log[j] for j in range(i, -1, -1) if "Compiling entry" in log[j]), "")
                print(f"{name} {stem}: {entry.strip()[-90:]} | {line.strip()}", flush=True)
        libs[stem] = ctypes.CDLL(out)
    return libs


def call(lib, entry: str, ptrs, ints) -> int:
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    return fn(*(a.data_ptr() for a in ptrs), *ints, torch.cuda.current_stream().cuda_stream)


def fwd_entry(d_in: int, d_out: int) -> str:
    """K1's entry at these widths: past 256 its wide route, which builds q
    into the workspace first."""
    return f"{STEMS[0]}_wide" if hc.kernel_route(d_in, d_out) == "wide" else STEMS[0]


def fwd_ptrs(x, k, u, s, t, outs, work) -> tuple:
    """K1's pointer arguments: past 256 the workspace after the outputs."""
    wide = hc.kernel_route(x.shape[1], u.shape[1]) == "wide"
    return (x, k, u, s, t, *outs, work) if wide else (x, k, u, s, t, *outs)


def run(libs, args, work):
    """K1, K2 and K3 of one build: ``{kernel: outputs}``, or None where the
    build refuses the widths."""
    x, k, u, s, t, g, m, l, delta = args
    n, d_in = x.shape
    mp, d_out = u.shape
    ints = (n, mp, d_in, d_out)
    fwd = [torch.empty(n, d_out, device="cuda"), torch.empty(n, 1, device="cuda"), torch.empty(n, 1, device="cuda")]
    dx = [torch.empty(n, d_in, device="cuda"), torch.empty(d_in, device="cuda"), torch.empty(d_in, device="cuda")]
    dku = [torch.empty(mp, d_in, device="cuda"), torch.empty(mp, d_out, device="cuda")]
    out = {}
    for kernel, stem, ptrs, outs in (("fwd", STEMS[0], fwd_ptrs(x, k, u, s, t, fwd, work), fwd),
                                     ("dx", STEMS[1], (*args, *dx, work), dx),
                                     ("dku", STEMS[2], (*args, *dku, work), dku)):
        err = call(libs[stem], fwd_entry(d_in, d_out) if kernel == "fwd" else stem, ptrs, ints)
        if err not in (0, 1):  # 1: cudaErrorInvalidValue, a width the build refuses
            raise RuntimeError(f"{stem}: cudaError {err}")
        out[kernel] = [a.clone() for a in outs] if err == 0 else None
    return out


def workspace(libs, n: int, mp: int, d_in: int, d_out: int):
    """Device scratch for the backward of every build at these sizes: the
    most any build's workspace entry asks for."""
    floats = 1
    for build in libs.values():
        for stem in STEMS:
            fn = getattr(build[stem], f"{stem}_workspace")
            fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
            floats = max(floats, fn(n, mp, d_in, d_out))
    return torch.empty(floats, device="cuda")


def cases(full: list[tuple[int, int]]) -> list[tuple]:
    """Phase 2's cases, then FULL_CASE and each of ``full``'s widths at
    its scale, with random tables."""
    _, n, mp, *_ = FULL_CASE
    out = cs.kernel_cases(cs.folded_tables())
    for label, d_in, d_out in [(FULL_CASE[0], *FULL_CASE[3:]), *((f"wide full {a}x{b}", a, b) for a, b in full)]:
        layer = cs.HopfieldLookup(d_in, d_out, mp, device="cuda")
        layer.reset_parameters(generator=torch.Generator(device="cuda").manual_seed(5))
        with torch.inference_mode():
            tables = tuple(a.contiguous() for i, a in enumerate(hc.fold_layer(layer)) if i != 2)
        out.append((label, n, tables, d_in, d_out))
    return out


def k1_bits(libs) -> None:
    """One JSON line a build and ``chip_smoke.PARENT_BITS`` case: the
    sha256 of its K1's ``(out, m, l)`` on the case's hashed inputs."""
    with torch.inference_mode():
        for sizes in cs.PARENT_BITS:
            n, mp, d_in, d_out = sizes
            inputs = cs.parent_bits_inputs(*sizes)
            work = workspace(libs, *sizes)
            for name in libs:
                outs = [torch.empty(n, d_out, device="cuda"), torch.empty(n, 1, device="cuda"),
                        torch.empty(n, 1, device="cuda")]
                err = call(libs[name][STEMS[0]], fwd_entry(d_in, d_out), fwd_ptrs(*inputs, outs, work), sizes)
                if err:
                    raise RuntimeError(f"{name} {STEMS[0]}{sizes}: cudaError {err}")
                torch.cuda.synchronize()
                print(json.dumps({"build": name, "k1_bits": sizes, "sha256": cs.lookup_digest(outs)}), flush=True)
            del inputs, work


def bits(libs) -> None:
    """One JSON line a build and ``chip_smoke.K2_PARENT_BITS`` case: the
    sha256 of its K2's ``(dx, ds, dt)`` on the case's hashed inputs; then
    the same of its K3's ``(dK, dU)`` at each ``chip_smoke.K3_PARENT_BITS``
    case; first K1's (``k1_bits``)."""
    k1_bits(libs)
    with torch.inference_mode():
        for kernel, stem, cases in (("k2", STEMS[1], cs.K2_PARENT_BITS), ("k3", STEMS[2], cs.K3_PARENT_BITS)):
            for sizes in cases:
                n, mp, d_in, d_out = sizes
                args = cs.backward_bits_args(*sizes)
                work = workspace(libs, *sizes)
                for name in libs:
                    outs = ([torch.empty(n, d_in, device="cuda"), torch.empty(d_in, device="cuda"),
                             torch.empty(d_in, device="cuda")] if kernel == "k2" else
                            [torch.empty(mp, d_in, device="cuda"), torch.empty(mp, d_out, device="cuda")])
                    err = call(libs[name][stem], stem, (*args, *outs, work), sizes)
                    if err:
                        raise RuntimeError(f"{name} {stem}{sizes}: cudaError {err}")
                    torch.cuda.synchronize()
                    print(json.dumps({"build": name, f"{kernel}_bits": sizes, "sha256": cs.lookup_digest(outs)}),
                          flush=True)
                del args, work


def width_steps(libs) -> None:
    """Phase 13's run at ``embedding_dim=384`` on each build's K1 to K3, in
    turns, ``WIDTH_ROUNDS`` times (each build's libraries stand in for the
    port's own)."""
    config, over, fit_prior = cs.WIDTH_RUNS[2]
    cfg = cs.load_config(config)
    for key, val in over.items():
        setattr(cfg, key, val)
    cfg.gamma = 1.0
    x = torch.from_numpy(cs.golden_input("mnist_digits")).cuda()
    torch.manual_seed(cfg.seed)
    state = cs.HopVAE(cfg, impl="torch", device="cpu").state_dict()  # the same weights for every build
    for name in [*libs, *reversed(libs)] * WIDTH_ROUNDS:
        nvcc._loaded.update(libs[name])
        model = cs.HopVAE(cfg, impl="cuda", device="cuda")
        model.load_state_dict(state)
        with cs.parity_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            losses, ms = cs.width_steps(model, cfg, x, fit_prior)
        kernel_ms = {e.key: e.device_time_total / 1e3 / len(ms) for e in prof.key_averages() if e.device_time_total > 0}
        lookup = [v for k, v in kernel_ms.items() if "hopfield" in k or "stream_" in k]  # K1 to K3 and their passes
        busy = {"all": sum(kernel_ms.values()), "lookups": sum(lookup)}
        print(json.dumps({"build": name, "width_run": {"config": config, **over}, "losses": losses, "step_ms": ms,
                          "device_busy_ms_a_step": busy}), flush=True)
        del model
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_hopfield_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    only_bits, steps, shapes, full = "--bits" in argv, "--no-steps" not in argv, None, []
    if "--shapes" in argv:
        at = argv.index("--shapes")
        shapes = set(argv[at + 1].split(","))
        argv = argv[:at] + argv[at + 2:]
    if "--full" in argv:
        at = argv.index("--full")
        full = [tuple(int(w) for w in pair.split("x")) for pair in argv[at + 1].split(",")]
        argv = argv[:at] + argv[at + 2:]
    argv = [a for a in argv if a not in ("--bits", "--no-steps")]
    builds = {"change": (nvcc.CSRC, [])}
    for arg in argv:
        name, _, spec = arg.partition("=")
        source, _, flags = spec.partition(":")
        builds[name] = (Path(source).resolve(), [f for f in flags.split(",") if f])
    print(f"card: {cs.smi('name,power.limit')}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(build, n, src, fl, tmp) for n, (src, fl) in builds.items()}
        libs = {n: f.result() for n, f in futures.items()}
    bits(libs)
    if only_bits:
        return 0
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = {"fwd": ("out", "m", "l"), "dx": ("dx", "ds", "dt"), "dku": ("dK", "dU")}
    with cs.parity_mode(), torch.inference_mode():
        for label, n, (k, u, s, t), d_in, d_out in cases(full):
            if shapes is not None and label not in shapes:
                continue
            x = cs.case_input(n, d_in, gen)
            g = torch.randn(n, d_out, device="cuda", generator=gen)
            out, m, l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
            args = (x, k, u, s, t, g, m, l, (g * out).sum(-1, keepdim=True))
            want = {"fwd": (out, m, l), "dx": hc.stream_bwd_dx_reference(*args),
                    "dku": hc.stream_bwd_dku_reference(*args)}
            work = workspace(libs, n, k.shape[0], d_in, d_out)
            timed = n * k.shape[0] > 1e7 or label.startswith("wide")
            reps = 3 if n * k.shape[0] > 1e8 else 10
            first = {}
            for name in [*libs, *reversed(libs)]:
                got, again = run(libs[name], args, work), run(libs[name], args, work)
                torch.cuda.synchronize()
                row = {"build": name, "shape": label, "n": n, "m": k.shape[0], "d_in": d_in, "d_out": d_out}
                first.setdefault(name, got)
                for kernel, outs in got.items():
                    if outs is None:
                        row[kernel] = "refused"
                        continue
                    ref = first["change"][kernel]
                    row[kernel] = {
                        "normwise_err": {nm: cs.normwise(a, w) for nm, a, w in zip(names[kernel], outs, want[kernel])},
                        "repeats_bitwise": all(torch.equal(a, b) for a, b in zip(outs, again[kernel])),
                        "equals_change": ref is not None and all(torch.equal(a, b) for a, b in zip(outs, ref)),
                    }
                    if kernel == "fwd" and label.startswith("wide") and n * k.shape[0] <= 1e8:
                        row[kernel]["rebuilt_row_sum_err"] = cs.rebuilt_rows_err(x, k, s, t, outs[1], outs[2], d_out)
                    if timed:
                        stem = STEMS[("fwd", "dx", "dku").index(kernel)]
                        entry = fwd_entry(d_in, d_out) if kernel == "fwd" else stem
                        ptrs = fwd_ptrs(x, k, u, s, t, outs, work) if kernel == "fwd" else (*args, *outs, work)
                        launch_once = lambda: call(libs[name][stem], entry, ptrs, (n, k.shape[0], d_in, d_out))  # noqa: E731
                        row[kernel]["ms"] = cs.cuda_ms(launch_once, reps)
                        if label.startswith("wide") and (n * k.shape[0] <= 1e8 or kernel == "dx"):
                            row[kernel]["kernel_ms"] = cs.kernel_ms(launch_once)
                print(json.dumps(row), flush=True)
            if label.startswith("wide"):
                plain_ms = cs.cuda_ms(lambda: hc.stream_lookup_fwd_reference(x, k, u, s, t), reps)
                fwd_ms, fwd_backend = cs.library_ms(cs.state_query(x, s, t), k, u, reps)
                with torch.inference_mode(False):  # autograd through SDPA on fresh copies of the inference tensors
                    lib_ms, backend = cs.library_bwd_ms(cs.state_query(x, s, t), k, u, g.clone(), reps)
                print(json.dumps({"shape": label, "plain_fwd_ms": plain_ms, "library_fwd_ms": fwd_ms,
                                  "library_fwd_backend": fwd_backend,
                                  "library_bwd_ms": lib_ms, "library_backend": backend}), flush=True)
            del x, g, out, m, l, args, want, first, work
            torch.cuda.empty_cache()
    if steps:
        width_steps(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
