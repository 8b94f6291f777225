"""Compare builds of the streaming Hopfield kernels K1, K2 and K3 on the card.

    python3 tools/torch_hopfield_bwd_variants.py [NAME=CSRC_DIR[:-DFLAG,...] ...]

Builds ``hopfield_stream_fwd.cu``, ``hopfield_stream_bwd_dx.cu`` and
``hopfield_stream_bwd_dku.cu`` from ``hopvae_torch/csrc`` (as ``change``)
and from each ``NAME=CSRC_DIR`` (a copy of that directory elsewhere, for
example a parent commit unpacked with ``git archive``; ``-D`` flags after a
colon) with the port's nvcc flags, prints each build's ptxas registers and
spills, and runs every build twice, in turns, at the shapes of phase 2 of
``chip_smoke.py`` (the trained FFHQ-64 and MNIST tables, a ragged case,
and its width cases), on the same inputs, the row stats from the plain
forward. Per build and shape, one JSON line: K1's and the backward's
normwise errors against the plain versions, whether a second launch
repeats the first bit for bit, whether the outputs equal the ``change``
build's, and each kernel's time (CUDA events) at the large shapes. A build that refuses a
width (cudaErrorInvalidValue) is reported as refusing it.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hopvae_torch.ops import hopfield_cuda as hc  # noqa: E402
from hopvae_torch.utils import nvcc  # noqa: E402

STEMS = ("hopfield_stream_fwd", "hopfield_stream_bwd_dx", "hopfield_stream_bwd_dku")
WORKSPACE_FLOATS = 1 << 26  # more than any build asks for at these shapes


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


def call(lib, stem: str, ptrs, ints) -> int:
    fn = getattr(lib, stem)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    return fn(*(a.data_ptr() for a in ptrs), *ints, torch.cuda.current_stream().cuda_stream)


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
    for kernel, stem, ptrs, outs in (("fwd", STEMS[0], (x, k, u, s, t, *fwd), fwd),
                                     ("dx", STEMS[1], (*args, *dx, work), dx),
                                     ("dku", STEMS[2], (*args, *dku, work), dku)):
        err = call(libs[stem], stem, ptrs, ints)
        if err not in (0, 1):  # 1: cudaErrorInvalidValue, a width the build refuses
            raise RuntimeError(f"{stem}: cudaError {err}")
        out[kernel] = [a.clone() for a in outs] if err == 0 else None
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_hopfield_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    builds = {"change": (nvcc.CSRC, [])}
    for arg in argv:
        name, _, spec = arg.partition("=")
        source, _, flags = spec.partition(":")
        builds[name] = (Path(source).resolve(), [f for f in flags.split(",") if f])
    print(f"card: {cs.smi('name,power.limit')}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(build, n, src, fl, tmp) for n, (src, fl) in builds.items()}
        libs = {n: f.result() for n, f in futures.items()}
    work = torch.empty(WORKSPACE_FLOATS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = {"fwd": ("out", "m", "l"), "dx": ("dx", "ds", "dt"), "dku": ("dK", "dU")}
    with cs.parity_mode(), torch.inference_mode():
        for label, n, (k, u, s, t), d_in, d_out in cs.kernel_cases(cs.folded_tables()):
            x = cs.case_input(n, d_in, gen)
            g = torch.randn(n, d_out, device="cuda", generator=gen)
            out, m, l = hc.stream_lookup_fwd_reference(x, k, u, s, t)
            args = (x, k, u, s, t, g, m, l, (g * out).sum(-1, keepdim=True))
            want = {"fwd": (out, m, l), "dx": hc.stream_bwd_dx_reference(*args),
                    "dku": hc.stream_bwd_dku_reference(*args)}
            timed = n * k.shape[0] > 1e7
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
                    if timed:
                        stem = STEMS[("fwd", "dx", "dku").index(kernel)]
                        ptrs = (x, k, u, s, t, *outs) if kernel == "fwd" else (*args, *outs, work)
                        row[kernel]["ms"] = cs.cuda_ms(
                            lambda: call(libs[name][stem], stem, ptrs, (n, k.shape[0], d_in, d_out)), 10)
                print(json.dumps(row), flush=True)
            del x, g, out, m, l, args, want, first
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
