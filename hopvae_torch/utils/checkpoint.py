"""Checkpoints: read the JAX package's native ``.msgpack`` files and turn
its parameter pytree into a torch ``state_dict``.

- :func:`load_msgpack` is a small pure-Python reader of the format that
  ``flax.serialization.msgpack_serialize`` writes: maps, str/bin, ints,
  floats, and the ndarray extension (ext type 1, whose payload is the
  msgpack triple ``(shape, dtype name, raw bytes)``). Lists are stored as
  maps keyed ``"0"``, ``"1"``, …. The top-level ``prior`` subtree is
  skipped unread: the port has no prior yet.
- :func:`params_from_jax` maps the JAX layouts onto torch's (the inverse
  of ``hopvae_tpu/utils/checkpoint.py``): conv HWIO → OIHW, the flipped
  HWIO of a transposed conv → ``(I, O, kH, kW)``, a Linear ``(d_in,
  d_out)`` kernel → ``weight (d_out, d_in)``, LayerNorm ``scale`` →
  ``weight``; ``lookup_weights`` and biases stay as they are.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

_EXT_NDARRAY = 1
SKIPPED_TOP_LEVEL = ("prior",)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def value(self, build: bool = True) -> Any:
        """Decode the next value; with ``build=False`` only step over it."""
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, build)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F, build)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, build)
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xCA: lambda: self._unpack(">f"), 0xCB: lambda: self._unpack(">d"),
            0xCC: lambda: self._unpack(">B"), 0xCD: lambda: self._unpack(">H"),
            0xCE: lambda: self._unpack(">I"), 0xCF: lambda: self._unpack(">Q"),
            0xD0: lambda: self._unpack(">b"), 0xD1: lambda: self._unpack(">h"),
            0xD2: lambda: self._unpack(">i"), 0xD3: lambda: self._unpack(">q"),
        }
        if b in simple:
            return simple[b]()
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self._unpack((">B", ">H", ">I")[b - 0xC4])
            raw = self._take(n)
            return bytes(raw) if build else None
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]), build)
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self._unpack((">H", ">I")[b - 0xDC]), build)
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack((">H", ">I")[b - 0xDE]), build)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4), build)
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._unpack((">B", ">H", ">I")[b - 0xC7]), build)
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at offset {self.pos - 1}")

    def _str(self, n: int, build: bool):
        raw = self._take(n)
        return str(raw, "utf-8") if build else None

    def _array(self, n: int, build: bool):
        items = [self.value(build) for _ in range(n)]
        return items if build else None

    def _map(self, n: int, build: bool, skip_keys: tuple = ()):
        out = {}
        for _ in range(n):
            key = self.value()
            if key in skip_keys:
                self.value(build=False)
                continue
            out[key] = self.value(build)
        return out if build else None

    def top_level_map(self, skip_keys: tuple) -> dict:
        b = self._take(1)[0]
        if 0x80 <= b <= 0x8F:
            n = b & 0x0F
        elif b in (0xDE, 0xDF):
            n = self._unpack((">H", ">I")[b - 0xDE])
        else:
            raise ValueError("not a msgpack map")
        return self._map(n, True, skip_keys)

    def _ext(self, n: int, build: bool):
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if not build:
            return None
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(bytes(payload)).value()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_msgpack(path: str) -> dict:
    """A native checkpoint → nested dict of numpy arrays, ``prior`` skipped."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    out = reader.top_level_map(SKIPPED_TOP_LEVEL)
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} trailing bytes")
    return out


def _leaf(path: tuple, a) -> tuple[str, np.ndarray]:
    """One JAX leaf → (torch name, array in torch layout)."""
    *parents, name = path
    a = np.asarray(a, dtype=np.float32)
    if name == "kernel" and a.ndim == 4:
        if parents and parents[-1].startswith("conv_trans"):
            # flipped HWIO (kH, kW, I, O) → (I, O, kH, kW), spatially unflipped
            a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
        name = "weight"
    elif name == "kernel" and a.ndim == 2:
        a = a.T  # Linear (d_in, d_out) → weight (d_out, d_in)
        name = "weight"
    elif name == "scale":
        name = "weight"
    elif name not in ("bias", "lookup_weights"):
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join((*parents, name)), np.array(a, order="C")  # a writable copy


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or JAX leaves; lists as lists or as
    maps keyed by index) → a ``HopVAE`` state_dict. ``prior`` is skipped."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            name, arr = _leaf(path, node)
            out[name] = torch.from_numpy(arr)
            return
        for k, v in items:
            if not path and k in SKIPPED_TOP_LEVEL:
                continue
            walk(v, (*path, str(k)))

    walk(tree, ())
    return out
