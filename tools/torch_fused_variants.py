"""Compare builds of K4, the fused bottleneck forward, on the card (PyTorch/CUDA port).

    python3 tools/torch_fused_variants.py [NAME=CSRC_DIR ...]

Builds ``hopfield_bottleneck_fused.cu`` from ``hopvae_torch/csrc`` (as
``change``) and from each ``NAME=CSRC_DIR`` (a copy of that directory
elsewhere, for example a parent commit unpacked with ``git archive``) with
the port's nvcc flags, and runs every build's one-launch entry twice, in
turns, at the cases of phase 12 of ``chip_smoke.py`` on the same tokens and
tables: the ``zq`` bins that differ from the plain version, ``e``'s and
``r``'s max abs error, whether a second launch repeats the first bit for
bit, whether the outputs equal the ``change`` build's bit for bit, and the
time (CUDA events) at the full-width case and past 256. Past 256 it calls
the wide entry (each stage on K1's wide route), the workspace allocated
inside the timed call as the port's wrapper allocates it, and times each
kernel of the call by name with ``torch.profiler`` (``kernel_ms``: the
stages' query builds, the narrow-side stages with their split passes, the
cluster stages). A build that refuses the widths reports ``refused``. One
JSON line per build and case.
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
from hopvae_torch.ops.bottleneck import LAYERS  # noqa: E402
from hopvae_torch.utils import nvcc  # noqa: E402

STEM = "hopfield_bottleneck_fused"


def build(name: str, csrc: Path, out_dir: str) -> ctypes.CDLL:
    out = f"{out_dir}/lib_{name}_{STEM}.so"
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, "-o", out, str(csrc / f"{STEM}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(out)


def call(lib, x, tables, outs, num_levels) -> int:
    """The build's one-launch entry, or past 256 its wide entry (the three
    stages on K1's wide route) with the workspace its ``_workspace`` entry
    asks for."""
    d, di = x.shape[1], outs[1].shape[1]
    wide = hc.kernel_route(d, di) == "wide"
    fn = getattr(lib, f"{STEM}_wide" if wide else STEM)
    fn.argtypes = [ctypes.c_void_p] * (20 if wide else 19) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    work = []
    if wide:
        ms = [table[0].shape[0] for table in tables]
        try:  # the workspace entry of the stages' split scores, or a build's from before them
            floats, args = getattr(lib, f"{STEM}_wide_workspace"), (x.shape[0], *ms, d, di)
        except AttributeError:
            floats, args = getattr(lib, f"{STEM}_workspace"), (x.shape[0], d, di)
        floats.argtypes, floats.restype = [ctypes.c_int] * len(args), ctypes.c_longlong
        work = [torch.empty(floats(*args), device="cuda")]
    return fn(x.data_ptr(), *(a.data_ptr() for table in tables for a in table),
              *(a.data_ptr() for a in (*outs, *work)), x.shape[0], *(table[0].shape[0] for table in tables), d, di,
              num_levels, torch.cuda.current_stream().cuda_stream)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_fused_variants: no CUDA device", file=sys.stderr)
        return 2
    builds = {"change": nvcc.CSRC}
    for arg in argv:
        name, _, source = arg.partition("=")
        builds[name] = Path(source).resolve()
    print(f"card: {cs.smi('name,power.limit')}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(build, n, src, tmp) for n, src in builds.items()}
        libs = {n: f.result() for n, f in futures.items()}
    with cs.parity_mode(), torch.inference_mode():
        for label, layers, x, levels in cs.fused_cases():
            layer_list = [layers[name] for name in LAYERS]
            d, di = hc.fused_widths(layer_list)
            x2 = x.reshape(-1, d).contiguous()
            tables = hc._folded(layer_list)
            want = [a.reshape(-1, a.shape[-1]) for a in hc.bottleneck_fused_fwd_reference(*layer_list, x, levels)]
            first = {}
            for name in [*libs, *reversed(libs)]:
                got, again = ([torch.empty(x2.shape[0], w, device="cuda") for w in (d, di, d)] for _ in range(2))
                errs = [call(libs[name], x2, tables, outs, levels) for outs in (got, again)]
                torch.cuda.synchronize()
                if any(errs):
                    print(json.dumps({"build": name, "shape": label, "d": d, "di": di,
                                      "refused" if errs[0] == 1 else "error": errs}), flush=True)
                    continue
                first.setdefault(name, got)
                row = {"build": name, "shape": label, "d": d, "di": di, **cs.bins_and_errors(got, want),
                       "repeats_bitwise": all(torch.equal(a, b) for a, b in zip(got, again)),
                       "equals_change": all(torch.equal(a, b) for a, b in zip(got, first["change"]))}
                if label.startswith("ffhq64") or hc.kernel_route(d, di) == "wide":
                    row["ms"] = cs.cuda_ms(lambda: call(libs[name], x2, tables, got, levels), 10)
                if hc.kernel_route(d, di) == "wide":
                    row["kernel_ms"] = cs.kernel_ms(lambda: call(libs[name], x2, tables, got, levels))
                print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
