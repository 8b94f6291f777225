"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``hopvae_torch/csrc/<stem>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``hopvae_torch/_build/``, named
by a hash of its source, the shared ``csrc/*.cuh`` headers and the flags,
so an edited source builds anew. A failed build raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
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


def build_all() -> list[str]:
    """Build and load every ``csrc/*.cu``, one ``nvcc`` each, all started
    together; returns the stems."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(stems)) as pool:
        for future in [pool.submit(load_library, s) for s in stems]:
            future.result()
    return stems
