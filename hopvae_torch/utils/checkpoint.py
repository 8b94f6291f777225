"""Checkpoints: read and write the JAX package's native ``.msgpack`` files
and map its parameter pytree to a torch ``state_dict`` and back.

- :func:`load_msgpack` is a small pure-Python reader of the format that
  ``flax.serialization.msgpack_serialize`` writes: maps, str/bin, ints,
  floats, and the ndarray extension (ext type 1, whose payload is the
  msgpack triple ``(shape, dtype name, raw bytes)``). Lists are stored as
  maps keyed ``"0"``, ``"1"``, ….
- :func:`save_msgpack` is the writer of the same format, byte for byte
  what the JAX package's ``save_params`` (``flax.serialization.to_bytes``
  of ``jax.device_get(tree)``) writes for the same tree: map keys sorted,
  as JAX orders a dict's keys; a list as a map keyed by index, in index
  order; each length in its smallest msgpack encoding.
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
- :func:`params_to_jax` is its inverse: a ``HopVAE`` state_dict → the
  tree JAX's ``HopVAE.init`` gives for the same config, leaf for leaf
  (f32), the PixelCNN prior's causality masks written from
  ``_group_mask``, and ``prior: {}`` under the Normal prior. JAX's strict
  ``load_params`` reads what :func:`save_msgpack` writes of it.
- :func:`load_reference_checkpoint` is JAX's loader of the same name: the
  reference's torch ``state_dict`` (``checkpoints/MNIST-28.ckpt``, 61
  tensors) through :func:`convert_reference_state_dict`, or a
  ``.msgpack``, merged by :func:`lenient_merge` into the model's fresh
  tensors; the port's own ``.pt`` as it is.
"""

from __future__ import annotations

import os
import re
import struct
import sys
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


# the largest array flax writes as one leaf; past it flax splits it in chunks
_MAX_LEAF_BYTES = 1 << 30


def _header(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length ``n`` in its smallest msgpack encoding: the fix form up to
    ``fix_max`` (when there is one), else ``codes`` for 8, 16 and 32 bits
    (``None`` where a form has no 8-bit width)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF)) if v >= 0 else (
        (0xD0, ">b", -0x80, 0), (0xD1, ">h", -0x8000, 0), (0xD2, ">i", -0x80000000, 0),
        (0xD3, ">q", -0x8000000000000000, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _ndarray_payload(a: np.ndarray) -> bytes:
    """The ndarray extension's payload: ``(shape, dtype name, raw bytes)``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError(f"cannot write an array of dtype {a.dtype}")
    if a.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"an array of {a.nbytes} bytes is past one leaf of the format ({_MAX_LEAF_BYTES})")
    out = bytearray()
    _pack((tuple(int(n) for n in a.shape), a.dtype.name, a.tobytes("C")), out, tree=False)
    return bytes(out)


def _pack(v: Any, out: bytearray, tree: bool = True) -> None:
    """Append ``v``'s msgpack encoding to ``out``. In a ``tree`` a map's keys
    are written sorted and a list or tuple as a map keyed by index; outside
    one (the ndarray payload) a tuple is an array."""
    if isinstance(v, int) and not isinstance(v, bool):
        _pack_int(out, v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _header(out, len(v), None, -1, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, np.ndarray):
        payload = _ndarray_payload(v)
        if len(payload) in (1, 2, 4, 8, 16):  # fixext 1/2/4/8/16
            out.append(0xD4 + (1, 2, 4, 8, 16).index(len(payload)))
        else:
            _header(out, len(payload), None, -1, (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY)
        out += payload
    elif isinstance(v, Mapping) or (tree and isinstance(v, (list, tuple))):
        items = sorted(v.items()) if isinstance(v, Mapping) else list(enumerate(v))
        _header(out, len(items), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in items:
            _pack(str(k), out)
            _pack(x, out, tree)
    elif isinstance(v, (list, tuple)):
        _header(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(x, out, tree)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def save_msgpack(path: str, tree: Mapping) -> None:
    """Write a nested dict (lists allowed) of numpy arrays, str, bytes and
    ints in the native format, to a temporary file renamed into place:
    the bytes of the JAX package's ``save_params`` for the same tree."""
    out = bytearray()
    _pack(tree, out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)


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


def _pixelcnn_convs(prior: Mapping):
    """``(name, conv subtree, mask kind)`` of each masked conv of a PixelCNN
    prior subtree: mask A on ``conv_in``, mask B elsewhere."""
    yield "conv_in", prior["conv_in"], "A"
    for i, block in _items(prior["res"]):
        yield f"res/{i}/conv_a", block["conv_a"], "B"
        yield f"res/{i}/conv_b", block["conv_b"], "B"
    yield "conv_out1", prior["conv_out1"], "B"
    yield "conv_out2", prior["conv_out2"], "B"


def _mask(conv: Mapping, kind: str, n_groups: int) -> np.ndarray:
    return _group_mask(*np.shape(conv["kernel"]), n_groups, mask_type=kind)


def check_pixelcnn_masks(prior: Mapping) -> None:
    """Raise ``ValueError`` unless every stored ``mask`` of a PixelCNN prior
    subtree equals ``_group_mask`` at its conv's shape: mask A on
    ``conv_in``, mask B elsewhere, in ``C`` groups (``conv_in``'s input
    channels)."""
    n_groups = np.shape(prior["conv_in"]["kernel"])[2]
    for name, conv, kind in _pixelcnn_convs(prior):
        if "mask" not in conv:
            continue
        want = _mask(conv, kind, n_groups)
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


def _jax_leaf(name: str, t) -> tuple[list[str], np.ndarray]:
    """One torch tensor → (JAX path, array in JAX layout): the inverse of
    :func:`_leaf`."""
    *parents, leaf = name.split(".")
    a = np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, dtype=np.float32)
    if leaf == "weight" and a.ndim == 4:
        if parents and parents[-1].startswith("conv_trans"):
            a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)  # (I, O, kH, kW) → flipped HWIO
        else:
            a = a.transpose(2, 3, 1, 0)  # OIHW → HWIO
        leaf = "kernel"
    elif leaf == "weight" and a.ndim == 2:
        a, leaf = a.T, "kernel"  # Linear weight (d_out, d_in) → kernel (d_in, d_out)
    elif leaf == "weight" and a.ndim == 1:
        leaf = "scale"  # LayerNorm
    elif leaf not in _KEPT:
        raise ValueError(f"unknown parameter {name}")
    return [*parents, leaf], np.array(a, order="C")


def _lists(node):
    """Maps keyed ``"0"`` … ``"n-1"`` (a ``ModuleList``'s indices) → lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(map(int, node)) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0 to {len(node) - 1}")
        return [node[str(i)] for i in range(len(node))]
    return node


def params_to_jax(state_dict: Mapping[str, Any], config) -> dict:
    """A ``HopVAE`` state_dict → the JAX parameter tree of ``config``: the
    tree ``hopvae_tpu``'s ``HopVAE(config).init`` gives, with the same
    leaves, shapes and dtypes (f32), so JAX's strict ``load_params`` reads
    it. Conv OIHW → HWIO, a transposed conv's ``(I, O, kH, kW)`` → its
    flipped HWIO, Linear ``weight`` → ``kernel (d_in, d_out)``, LayerNorm
    ``weight`` → ``scale``; ``ModuleList`` indices → the ``layers``,
    ``blocks`` and ``res`` lists. The PixelCNN prior's causality masks,
    which the JAX tree stores and the port keeps as buffers, are written
    from ``_group_mask`` (``config.index_dim`` groups); the Normal prior's
    subtree is ``{}``."""
    tree: dict = {}
    for name, t in state_dict.items():
        path, a = _jax_leaf(name, t)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    tree = _lists(tree)
    prior = tree.setdefault("prior", {})
    keys = set(prior)
    want = {"PixelCNN": PIXELCNN_KEYS, "Transformer": TRANSFORMER_PRIOR_KEYS}.get(config.prior, frozenset())
    if keys != want:
        raise ValueError(f"the state's prior holds {sorted(keys)}, not the {config.prior!r} prior's {sorted(want)}")
    if config.prior == "PixelCNN":
        for _name, conv, kind in _pixelcnn_convs(prior):
            conv["mask"] = _mask(conv, kind, config.index_dim)
    return tree


# ------------------------------------------------ the reference's checkpoint

_LOOKUPS = ("hopfield", "embedding_to_index", "index_to_embedding")
# an hflayers HopfieldLayer's tensors under ``<lookup>.hopfield.`` → the
# port's names under ``<lookup>.`` (torch Linear weights are (out, in) in
# both, so nothing is transposed)
_HOPFIELD_CORE = {
    "association_core.in_proj_weight": "in_proj.weight",
    "association_core.in_proj_bias": "in_proj.bias",
    "association_core.out_proj.weight": "out_proj.weight",
    "association_core.out_proj.bias": "out_proj.bias",
    **{f"{ref}.{p}": f"{ours}.{p}" for ref, ours in (("norm_stored_pattern", "norm_stored"),
                                                   ("norm_state_pattern", "norm_state"),
                                                   ("norm_pattern_projection", "norm_proj"))
       for p in ("weight", "bias")},
}
_RESIDUAL = re.compile(r"^(encoder|decoder)\.residual_stack\._layers\.(\d+)\._block\.([13])\.weight$")
_CONV = re.compile(r"^(encoder\.conv_[1-4]|pre_vq_conv|post_vq_conv|decoder\.conv_1|decoder\.conv_trans_[1-3])"
                   r"\.(weight|bias)$")


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint's top-level mapping, its tensors on the host: the
    reference's ``state_dict``, or the trainer's ``.pt``."""
    return torch.load(path, map_location="cpu")


def reference_name(key: str) -> str | None:
    """The port's state-dict name of one tensor of the reference HopVAE's
    ``state_dict`` (the names JAX's ``convert_torch_state_dict`` reads),
    or None for a name the model has no place for."""
    if m := _RESIDUAL.match(key):
        return f"{m[1]}.residual_stack.layers.{m[2]}.conv_{'a' if m[3] == '1' else 'b'}.weight"
    if _CONV.match(key):
        return key
    lookup, _, rest = key.partition(".")
    if lookup in _LOOKUPS:
        if rest == "lookup_weights":
            return key
        if rest.startswith("hopfield.") and rest[len("hopfield."):] in _HOPFIELD_CORE:
            return f"{lookup}.{_HOPFIELD_CORE[rest[len('hopfield.'):]]}"
    return None


def convert_reference_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference's ``state_dict`` (``checkpoints/MNIST-28.ckpt``: 61
    tensors, no prior) → the port's names. Its layouts are the port's
    already: conv weights OIHW, transposed-conv weights ``(I, O, kH, kW)``,
    Linear weights ``(out, in)``; each ``lookup_weights`` drops its leading
    axis of 1. Tensors the model has no place for are left out, as JAX's
    converter, which reads only the names it knows, leaves them."""
    out = {}
    for key, value in sd.items():
        name = reference_name(key)
        if name is not None:
            out[name] = value[0] if name.endswith("lookup_weights") else value
    return out


def lenient_merge(fresh: Mapping[str, torch.Tensor], stored: Mapping[str, torch.Tensor],
                  dropped: list | None = None) -> dict[str, torch.Tensor]:
    """The reference's partial load over state dicts (JAX's ``lenient_merge``):
    a stored tensor lands where ``fresh`` has one of that name and shape,
    cast to its dtype; every other fresh tensor is kept. ``dropped``, when
    given, collects where the checkpoint did not land: fresh tensors it
    lacks or holds at another shape, and stored names with no place."""
    out = {}
    for name, value in fresh.items():
        got = stored.get(name)
        if got is not None and tuple(got.shape) == tuple(value.shape):
            out[name] = got.to(value.dtype)
            continue
        out[name] = value
        if dropped is not None:
            dropped.append(f"{name} (shape {tuple(got.shape)} != {tuple(value.shape)})" if got is not None
                           else f"{name} (not in checkpoint)")
    if dropped is not None:
        dropped.extend(f"{name} (in checkpoint, no such param)" for name in stored if name not in fresh)
    return out


def warn_dropped(dropped: list, path: str) -> None:
    """JAX's warning for a partial load, on stderr."""
    if dropped:
        shown = ", ".join(dropped[:8]) + (" …" if len(dropped) > 8 else "")
        print(f"warning: lenient load of {path}: {len(dropped)} subtree(s) kept their fresh initialization / "
              f"were ignored: {shown}", file=sys.stderr)


def checkpoint_state(path: str) -> tuple[dict[str, torch.Tensor], bool]:
    """``(state_dict, lenient)`` of a checkpoint file, on the host, in the
    port's names: the JAX package's native ``.msgpack`` (lenient), a
    ``.pt`` that ``hopvae_torch.train`` writes, whose top level holds
    ``"model"`` (strict), or else the reference's torch ``state_dict``
    (lenient)."""
    if path.endswith(".msgpack"):
        return params_from_jax(load_msgpack(path)), True
    sd = load_torch_state_dict(path)
    if "model" in sd:
        return sd["model"], False
    return convert_reference_state_dict(sd), True


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> list[str]:
    """Load any checkpoint into ``model`` in place, as JAX's
    ``load_reference_checkpoint``: an absent file is a no-op; a ``.msgpack``
    (through :func:`params_from_jax`) and the reference's ``state_dict``
    (through :func:`convert_reference_state_dict`) merge leniently into
    the model's fresh tensors, and what did not land is printed; the
    port's own ``.pt`` loads as ``model.load_state_dict`` does. Returns
    the paths that did not land."""
    if not os.path.exists(path):
        return []
    state, lenient = checkpoint_state(path)
    dropped: list = []
    if lenient:
        state = lenient_merge(model.state_dict(), state, dropped)
        warn_dropped(dropped, path)
    model.load_state_dict(state)
    return dropped
