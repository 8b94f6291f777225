"""Compare builds of K5's forward kernel on the card (PyTorch/CUDA port).

    python3 tools/torch_attention_fwd_variants.py [--reps N] [--bits] [NAME=SOURCE ...]

Builds ``hopvae_torch/csrc/causal_attention_fwd.cu`` (as ``change``) and
each ``NAME=SOURCE`` (a copy of the source elsewhere beside the headers it
includes: a parent commit unpacked with ``git archive``, or an edited copy
with other tiles) with the port's nvcc flags,
prints each build's ptxas registers and spills, and runs every build
twice, in turns, at every shape of phase 7 of ``chip_smoke.py`` and a
few more ragged ones (one with views off 16-byte alignment): the
normwise error of ``out`` and ``lse`` against the plain version, whether
a second launch repeats the first bit for bit, whether its outputs equal
the ``change`` build's bit for bit (a build that does not take a head
width reports ``refused``), and, at the full-width shapes and past 8192
(the window kernel, with each kernel its entry launches timed by name,
``kernel_ms``), its time (CUDA events, mean of ``--reps`` launches) beside
``F.scaled_dot_product_attention(is_causal=True)``'s forward on the same
inputs and the bounds of ``chip_smoke.py`` (three TF32 passes, and the
f32 CUDA cores' as context), and the build's registers, spills, shared
bytes, blocks an SM and, past 256, its cluster (blocks, slice, clusters
the card holds) where the build reports them. One JSON line per build and
shape. First, and alone with ``--bits``, the sha256 of each build's
``(out, lse)`` at the cases of ``chip_smoke.K5_PARENT_BITS`` (hashed
inputs), the digests that phase 7 holds the port's K5-fwd to.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from hopvae_torch.ops import attention_cuda as ac  # noqa: E402
from hopvae_torch.utils import nvcc  # noqa: E402
from torch_attention_bwd_variants import build  # noqa: E402

CASES = [*cs.ATTENTION_CASES, ("ragged S48 dh64", 2, 48, 2, 64), ("ragged S48 dh128", 2, 48, 2, 128),
         ("ragged S48 dh512", 2, 48, 1, 512)]


def call(lib, q, k, v, scale, out, lse) -> None:
    """The build's forward on the current stream; a build with
    ``causal_attention_fwd_workspace`` (the split scores past 8192) takes
    its scratch after lse."""
    fn = lib.causal_attention_fwd
    b, s, h, dh = q.shape
    work = []
    if hasattr(lib, "causal_attention_fwd_workspace"):
        ws = lib.causal_attention_fwd_workspace
        ws.argtypes, ws.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        floats = ws(b, s, h, dh)
        scratch = torch.empty(floats, device="cuda") if floats > 0 else None  # held until the launch is queued
        work = [None if scratch is None else scratch.data_ptr()]
    fn.argtypes = ([ctypes.c_void_p] * (5 + len(work)) + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    strides = [st for a in (q, k, v) for st in a.stride()[:3]]
    err = fn(*(a.data_ptr() for a in (q, k, v, out, lse)), *work, b, s, h, dh, *strides, scale,
             torch.cuda.current_stream().cuda_stream)
    if err == 1:  # cudaErrorInvalidValue: a head width the build does not take
        raise ValueError("refused")
    if err:
        raise RuntimeError(f"causal_attention_fwd: cudaError {err}")


def attributes(lib, dh: int) -> dict:
    """The build's kernel at head width ``dh`` as the card reports it
    (``causal_attention_fwd_attributes``), and its cluster where the build
    has ``causal_attention_fwd_cluster``."""
    out = (ctypes.c_int * len(nvcc.ATTRIBUTES))()
    entries = [getattr(lib, n) for n in ("causal_attention_fwd_attributes", "causal_attention_fwd_cluster")
               if hasattr(lib, n)]
    for fn in entries:
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    if entries[0](dh, out):
        return {}
    attrs = dict(zip(nvcc.ATTRIBUTES, out))
    if len(entries) > 1 and entries[1](dh, out) == 0:
        attrs.update(cluster=out[0], slice=out[1], active_clusters=out[2])
    return attrs


def bits(libs) -> None:
    """One JSON line a build and ``chip_smoke.K5_PARENT_BITS`` case: the
    sha256 of its ``(out, lse)`` on the case's hashed inputs."""
    for sizes in cs.K5_PARENT_BITS:
        b, s, h, dh = sizes
        q, k, v = cs.attention_bits_inputs(*sizes)
        for name, lib in libs.items():
            outs = (torch.empty(b, s, h, dh, device="cuda"), torch.empty(b, h, s, device="cuda"))
            call(lib, q, k, v, 1 / math.sqrt(dh), *outs)
            torch.cuda.synchronize()
            print(json.dumps({"build": name, "k5_fwd_bits": sizes, "sha256": cs.lookup_digest(outs)}), flush=True)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--bits", action="store_true", help="print the parent-bits digests alone")
    parser.add_argument("builds", nargs="*", metavar="NAME=SOURCE")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    builds = {"change": nvcc.CSRC / "causal_attention_fwd.cu"}
    for arg in args.builds:
        name, _, source = arg.partition("=")
        builds[name] = Path(source).resolve()
    print(f"card: {cs.smi('name,power.limit')}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(build, n, src, [], tmp) for n, src in builds.items()}
        libs = {n: f.result() for n, f in futures.items()}
    bits(libs)
    if args.bits:
        return 0
    exps = cs.exp_per_s()
    gen = torch.Generator(device="cuda").manual_seed(3)
    with cs.parity_mode(), torch.inference_mode():
        for label, b, s, h, dh in CASES:
            q, k, v, _g = cs.attention_inputs(b, s, h, dh, gen, offset=1 if "misaligned" in label else 0)
            scale = 1 / math.sqrt(dh)
            want = ac.causal_attention_fwd_reference(q, k, v, scale)
            timed = b * h * s * s > 1e8 or dh > ac.BWD_WIDE_MAX
            extra = {}
            if timed:
                qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
                extra = {
                    "sdpa_fwd_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                                              args.reps),
                    "bound_ms": cs.attention_bound("fwd", b, s, h, dh, exps, tensor_cores=True)[0],
                    "bound_f32_ms": cs.attention_bound("fwd", b, s, h, dh, exps)[0],
                }
                del qt, kt, vt
            first = {}
            for name in [*libs, *reversed(libs)]:
                lib = libs[name]
                got, again = ((torch.empty(b, s, h, dh, device="cuda"), torch.empty(b, h, s, device="cuda"))
                              for _ in range(2))
                try:
                    for outs in (got, again):
                        call(lib, q, k, v, scale, *outs)
                except ValueError:
                    print(json.dumps({"build": name, "shape": label, "refused": True}), flush=True)
                    continue
                torch.cuda.synchronize()
                row = {"build": name, "shape": label,
                       "normwise_err": {n: cs.normwise(a, w) for n, a, w in zip(("out", "lse"), got, want)},
                       "repeats_bitwise": all(torch.equal(a, c) for a, c in zip(got, again))}
                first.setdefault(name, got)
                row["equals_change"] = all(torch.equal(a, c) for a, c in zip(got, first["change"]))
                if timed:
                    row["ms"] = cs.cuda_ms(lambda: call(lib, q, k, v, scale, *got), args.reps)
                    if dh > ac.BWD_WIDE_MAX:
                        row["kernel_ms"] = cs.kernel_ms(lambda: call(lib, q, k, v, scale, *got))
                    row.update(extra, attrs=attributes(lib, dh))
                print(json.dumps(row), flush=True)
            del q, k, v, want, first
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
