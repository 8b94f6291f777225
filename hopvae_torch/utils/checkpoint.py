"""Checkpoints: read the JAX package's native ``.msgpack`` files and turn
its parameter pytree into a torch ``state_dict``.

- :func:`load_msgpack` is a small pure-Python reader of the format that
  ``flax.serialization.msgpack_serialize`` writes: maps, str/bin, ints,
  floats, and the ndarray extension (ext type 1, whose payload is the
  msgpack triple ``(shape, dtype name, raw bytes)``). Lists are stored as
  maps keyed ``"0"``, ``"1"``, ….
- :func:`params_from_jax` maps the JAX layouts onto torch's (the inverse
  of ``hopvae_tpu/utils/checkpoint.py``): conv HWIO → OIHW, the flipped
  HWIO of a transposed conv → ``(I, O, kH, kW)``, a Linear ``(d_in,
  d_out)`` kernel → ``weight (d_out, d_in)``, LayerNorm ``scale`` →
  ``weight``; ``lookup_weights``, biases and the Transformer prior's
  embeddings stay as they are, and its ``blocks`` list (the PixelCNN's
  ``res`` list) becomes the ``ModuleList`` index. The PixelCNN prior's
  stored causality masks are checked against the port's own
  (``pixelcnn._group_mask``), and a mismatch raises; they are not loaded,
  since the port keeps them as buffers. A ``prior`` subtree of another
  shape is left out; the model's lenient ``load_state_dict`` then keeps
  its fresh prior and says so.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

from hopvae_torch.models.priors.pixelcnn import PIXELCNN_KEYS, _group_mask

_EXT_NDARRAY = 1
# the leaves of a Transformer prior subtree, and those kept as they are
TRANSFORMER_PRIOR_KEYS = frozenset(("tok_emb", "bos", "pos_emb", "blocks", "ln_f", "head"))
_KEPT = ("bias", "lookup_weights", "tok_emb", "bos", "pos_emb")


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

    def value(self) -> Any:
        """Decode the next value."""
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
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
            return bytes(self._take(n))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            return self._array(self._unpack((">H", ">I")[b - 0xDC]))
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self._unpack((">H", ">I")[b - 0xDE]))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._unpack((">B", ">H", ">I")[b - 0xC7]))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x} at offset {self.pos - 1}")

    def _str(self, n: int):
        return str(self._take(n), "utf-8")

    def _array(self, n: int):
        return [self.value() for _ in range(n)]

    def _map(self, n: int):
        return {self.value(): self.value() for _ in range(n)}

    def _ext(self, n: int):
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(bytes(payload)).value()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_msgpack(path: str) -> dict:
    """A native checkpoint → nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    out = reader.value()
    if not isinstance(out, dict):
        raise ValueError(f"{path}: not a msgpack map")
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
    elif name not in _KEPT:
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join((*parents, name)), np.array(a, order="C")  # a writable copy


def _items(node):
    return node.items() if isinstance(node, Mapping) else ((str(i), v) for i, v in enumerate(node))


def check_pixelcnn_masks(prior: Mapping) -> None:
    """Raise ``ValueError`` unless every stored ``mask`` of a PixelCNN prior
    subtree equals ``_group_mask`` at its conv's shape: mask A on
    ``conv_in``, mask B elsewhere, in ``C`` groups (``conv_in``'s input
    channels)."""
    n_groups = np.shape(prior["conv_in"]["kernel"])[2]
    convs = [("conv_in", prior["conv_in"], "A"), ("conv_out1", prior["conv_out1"], "B"),
             ("conv_out2", prior["conv_out2"], "B")]
    convs += [(f"res/{i}/{name}", block[name], "B") for i, block in _items(prior["res"]) for name in ("conv_a", "conv_b")]
    for name, conv, kind in convs:
        if "mask" not in conv:
            continue
        want = _group_mask(*np.shape(conv["kernel"]), n_groups, mask_type=kind)
        if not np.array_equal(np.asarray(conv["mask"], np.float32), want):
            raise ValueError(f"prior/{name}/mask is not the PixelCNN's mask {kind} at {want.shape} in "
                             f"{n_groups} groups")


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy or JAX leaves; lists as lists or as
    maps keyed by index) → a ``HopVAE`` state_dict. A ``prior`` subtree is
    mapped when it is a Transformer or PixelCNN prior's (the PixelCNN's
    masks checked, not loaded) and left out otherwise."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if not isinstance(node, (Mapping, list, tuple)):
            name, arr = _leaf(path, node)
            out[name] = torch.from_numpy(arr)
            return
        for k, v in _items(node):
            if not path and k == "prior":
                keys = v.keys() if isinstance(v, Mapping) else ()
                if PIXELCNN_KEYS <= keys:
                    check_pixelcnn_masks(v)
                elif not TRANSFORMER_PRIOR_KEYS <= keys:
                    continue
            if path[:1] == ("prior",) and k == "mask":
                continue
            walk(v, (*path, str(k)))

    walk(tree, ())
    return out
