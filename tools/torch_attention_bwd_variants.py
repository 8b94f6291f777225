"""Compare builds of K5's backward kernels on the card (PyTorch/CUDA port).

    python3 tools/torch_attention_bwd_variants.py [NAME=SOURCE[:-DFLAG,...] ...]

Builds ``hopvae_torch/csrc/causal_attention_bwd.cu`` (as ``change``) and
each ``NAME=SOURCE`` (a copy of the source elsewhere, for example a parent
commit unpacked with ``git archive``; ``-D`` flags after a colon) with the
port's nvcc flags, prints each build's ptxas registers and spills, and runs
every build twice, in turns, at every shape of phase 7 of
``chip_smoke.py`` that the backward takes and one more ragged one: the
normwise error of dQ, dK and
dV against the plain versions, whether a second launch repeats the first
bit for bit, whether its outputs equal the ``change`` build's bit for bit
(a build that does not take a head width reports ``refused``),
and the time of each kernel (CUDA events). One JSON line per build and
shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hopvae_torch.ops import attention_cuda as ac  # noqa: E402
from hopvae_torch.utils import nvcc  # noqa: E402

CASES = [c for c in cs.ATTENTION_CASES if c[4] <= ac.BWD_WIDE_MAX] + [("ragged S48 dh128", 2, 48, 2, 128)]


def build(name: str, source: Path, flags: list[str], out_dir: str):
    out = f"{out_dir}/lib_{name}.so"
    inc = ["-I", str(source.parent)]
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, *flags, *inc, "-o", out, str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"{name}: {line.strip()}", flush=True)
    return ctypes.CDLL(out)


def call(lib, name: str, args, outs) -> None:
    q, k, v, g, lse, delta, scale = args
    fn = getattr(lib, name)
    b, s, h, dh = q.shape
    fn.argtypes = ([ctypes.c_void_p] * (6 + len(outs)) + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    strides = [st for a in (q, k, v, g) for st in a.stride()[:3]]
    err = fn(*(a.data_ptr() for a in (q, k, v, g, lse, delta, *outs)), b, s, h, dh, *strides, scale,
             torch.cuda.current_stream().cuda_stream)
    if err == 1:  # cudaErrorInvalidValue: a head width the build does not take
        raise ValueError("refused")
    if err:
        raise RuntimeError(f"{name}: cudaError {err}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_attention_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    builds = {"change": (nvcc.CSRC / "causal_attention_bwd.cu", [])}
    for arg in argv:
        name, _, spec = arg.partition("=")
        source, _, flags = spec.partition(":")
        builds[name] = (Path(source).resolve(), [f for f in flags.split(",") if f])
    print(f"card: {cs.smi('name,power.limit')}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(build, n, src, fl, tmp) for n, (src, fl) in builds.items()}
        libs = {n: f.result() for n, f in futures.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    with cs.parity_mode(), torch.inference_mode():
        for label, b, s, h, dh in CASES:
            q, k, v, g = cs.attention_inputs(b, s, h, dh, gen, offset=1 if "misaligned" in label else 0)
            scale = 1 / math.sqrt(dh)
            out, lse = ac.causal_attention_fwd_reference(q, k, v, scale)
            args = (q, k, v, g, lse, ac.attention_delta(out, g), scale)
            want = (*ac.causal_attention_bwd_dkv_reference(*args), ac.causal_attention_bwd_dq_reference(*args))
            timed = b * h * s * s > 1e8
            first = {}
            for name in [*libs, *reversed(libs)]:
                lib = libs[name]
                got, again = ([torch.empty(want[0].shape, device="cuda") for _ in range(3)] for _ in range(2))
                try:
                    for outs in (got, again):
                        call(lib, "causal_attention_bwd_dkv", args, outs[:2])
                        call(lib, "causal_attention_bwd_dq", args, outs[2:])
                except ValueError:
                    print(json.dumps({"build": name, "shape": label, "refused": True}), flush=True)
                    continue
                torch.cuda.synchronize()
                row = {"build": name, "shape": label,
                       "normwise_err": {n: cs.normwise(a, w) for n, a, w in zip(("dK", "dV", "dQ"), got, want)},
                       "repeats_bitwise": all(torch.equal(a, c) for a, c in zip(got, again))}
                first.setdefault(name, got)
                row["equals_change"] = all(torch.equal(a, c) for a, c in zip(got, first["change"]))
                if timed:
                    row["dkv_ms"] = cs.cuda_ms(lambda: call(lib, "causal_attention_bwd_dkv", args, got[:2]), 10)
                    row["dq_ms"] = cs.cuda_ms(lambda: call(lib, "causal_attention_bwd_dq", args, got[2:]), 10)
                print(json.dumps(row), flush=True)
            del q, k, v, g, out, lse, args, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
