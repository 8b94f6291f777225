"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``hopvae_torch/csrc/<stem>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``hopvae_torch/_build/``, named
by a hash of its source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source builds anew. A failed build raises; nothing falls
back.

Each kernel's wrapper counts its launches in ``launches`` through
:func:`count`. A CUDA graph's capture runs nothing, so a launch recorded
while a stream is captured goes to the tally of
:func:`captured_launches` instead, and the graph's owner adds that tally
at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from hopvae_torch.utils.tracing import span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# the tallies of the captures in progress, innermost last
_tallies: list[dict] = []
# ptxas register / shared-memory report of each build, by stem
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")
    return found


def library_path(stem: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers in ``csrc/`` and the flags."""
    src = (CSRC / f"{stem}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def _build(stem: str) -> Path:
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        with span("nvcc.build"):
            proc = subprocess.run(
                [nvcc_path(), *FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")],
                capture_output=True, text=True,
            )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {stem}.cu:\n{proc.stdout}{proc.stderr}")
        build_logs[stem] = proc.stdout + proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use. Two
    threads may race to build one stem: each writes its own temporary
    file and the rename is atomic, so both load the same library."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = _loaded.setdefault(stem, ctypes.CDLL(str(_build(stem))))
    return lib


def bind(stem: str, name: str, argtypes: list):
    """``lib.name`` of ``csrc/<stem>.cu`` with its ctypes argument types
    (the last is the stream); it returns a ``cudaError_t``."""
    fn = getattr(load_library(stem), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, fn, device, *args) -> None:
    """Call the entry point ``fn`` on the current stream of ``device``;
    raise if the launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def count(fn) -> None:
    """One launch of ``fn``'s kernel on the current stream: ``fn.launches
    += 1``, or, while that stream is captured into a CUDA graph, one more
    in the tally of the innermost :func:`captured_launches` (a capture
    outside one counts nothing: it launches nothing). A torch built
    without CUDA captures nothing."""
    if not (torch.backends.cuda.is_built() and torch.cuda.is_current_stream_capturing()):
        fn.launches += 1
    elif _tallies:
        _tallies[-1][fn] = _tallies[-1].get(fn, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Yields a dict, ``{wrapper: launches}``, of the kernels whose launches
    are captured inside the block; add it to the wrappers' ``launches`` at
    each replay of the graph. The backward's launches, made on autograd's
    device thread, land in it too."""
    tally: dict = {}
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def add_launches(tally: dict) -> None:
    """A replay of a graph whose capture recorded ``tally``."""
    for fn, n in tally.items():
        fn.launches += n


ATTRIBUTES = ("registers", "shared_bytes", "spill_bytes", "threads", "blocks_per_sm", "resident_rows",
              "streamed_rows")


def kernel_attributes(stem: str, *args: int) -> dict:
    """A kernel of ``csrc/<stem>.cu`` as the card reports it, through its
    ``<stem>_attributes(args..., out)`` entry: registers and spilled
    (local) bytes a thread, dynamic shared bytes, threads a block, blocks
    an SM, and its two tiles (rows resident and rows streamed). Launches
    nothing."""
    fn = getattr(load_library(stem), f"{stem}_attributes")
    out = (ctypes.c_int * len(ATTRIBUTES))()
    err = fn(*(ctypes.c_int(a) for a in args), out)
    if err != 0:
        raise RuntimeError(f"{stem}_attributes{args} failed: cudaError {err}")
    return dict(zip(ATTRIBUTES, out))


def build_all() -> list[str]:
    """Build and load every ``csrc/*.cu``, one ``nvcc`` each, all started
    together; returns the stems."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(stems)) as pool:
        for future in [pool.submit(load_library, s) for s in stems]:
            future.result()
    return stems
