"""The HopVAE latent bottleneck: three Hopfield lookups and a quantizer.

Port of ``hopvae_tpu/ops/bottleneck.py`` and of the streaming bottleneck
``_bottleneck_fwd_streaming`` in ``hopfield_pallas.py``::

    e   = hopfield(x)                       # retrieval, d -> d
    i   = sigmoid(embedding_to_index(e))    # d -> index_dim
    zq  = ste_round(i * (L-1)); zn = zq/(L-1)
    r   = index_to_embedding(zn)            # index_dim -> d

Returns ``(e, zq, r)``: the decoder input, the quantized grid, and the
round-trip reconstruction for the aux loss. ``impl="torch"`` runs the
eager lookups (the parity path); ``impl="cuda"`` runs the folded tables
through the streaming kernels, forward and backward. Both are
differentiable; the round passes gradients straight through.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hopvae_torch.ops.hopfield import HopfieldLookup, hopfield_lookup
from hopvae_torch.ops.hopfield_cuda import hopfield_lookup_stream
from hopvae_torch.ops.ste import straight_through_round

LAYERS = ("hopfield", "embedding_to_index", "index_to_embedding")
IMPLS = ("cuda", "torch")


def _compose(layers: Mapping[str, HopfieldLookup], x: torch.Tensor, num_levels: int, look):
    e = look(layers["hopfield"], x)
    i = torch.sigmoid(look(layers["embedding_to_index"], e))
    zq = straight_through_round(i * (num_levels - 1))
    zn = zq / (num_levels - 1)
    r = look(layers["index_to_embedding"], zn)
    return e, zq, r


def streaming_bottleneck(layers: Mapping[str, HopfieldLookup], x: torch.Tensor, num_levels: int,
                         impl: str = "cuda"):
    """The bottleneck through the folded streaming lookups: the kernels
    (``impl="cuda"``, CUDA tensors) or their plain versions
    (``impl="torch"``, CPU tensors)."""
    return _compose(layers, x, num_levels, lambda layer, inp: hopfield_lookup_stream(layer, inp, impl))


def hopfield_bottleneck(
    layers: Mapping[str, HopfieldLookup], x: torch.Tensor, num_levels: int, impl: str = "cuda"
):
    if impl == "cuda":
        return streaming_bottleneck(layers, x, num_levels, impl="cuda")
    if impl == "torch":
        return _compose(layers, x, num_levels, hopfield_lookup)
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
