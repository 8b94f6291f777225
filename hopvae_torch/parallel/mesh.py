"""The multi-GPU layer: a ``(data, model)`` layout of the processes of one
``torch.distributed`` group (port of ``hopvae_tpu/parallel/mesh.py``).

- ``data``: each data index trains on its own contiguous slice of every
  global batch (:func:`process_batch_bounds`); gradients are averaged over
  the data group.
- ``model``: each Hopfield ``lookup_weights (M, d)`` is split by rows over
  the model group (:func:`shard_patterns`), and the lookups merge the
  shards' softmax row stats (``hopfield_cuda.ShardedStreamLookup``). The
  tables' folded parameters are replicated, and their gradients, which
  each shard sees only through its own rows, are summed over the model
  group by the trainer.

Ranks are laid out as JAX's ``make_mesh`` reshapes its devices, row-major
``(n_data, n_model)``: rank ``r`` holds data index ``r // n_model`` and
model index ``r % n_model``. ``DistributedDataParallel`` reduces every
parameter over one group and cannot say this, so the trainer reduces
explicitly. :func:`init_distributed` joins the group that ``torchrun``'s
environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL on the card, gloo where the caller
asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from hopvae_torch.ops.bottleneck import LAYERS


def init_distributed(device=None) -> torch.device:
    """Join the process group of ``torchrun``'s environment and return this
    rank's device: ``cuda:<LOCAL_RANK>`` (NCCL) unless ``device`` names
    the CPU (gloo)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://", rank=rank,
                            world_size=world)
    return device


class PatternGroup:
    """This rank's pattern shard and the model group it shares the patterns
    with: the reductions ``ShardedStreamLookup`` merges the shards with,
    each over the stacked shard axis of its argument (one shard here) and
    then across the ranks."""

    def __init__(self, group):
        self.group = group

    def split(self, t: torch.Tensor) -> tuple:
        return (t,)

    def _reduce(self, a: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(a, op=op, group=self.group)
        return a

    def max(self, a: torch.Tensor) -> torch.Tensor:
        return self._reduce(a.amax(0, keepdim=True), dist.ReduceOp.MAX)

    def sum(self, a: torch.Tensor) -> torch.Tensor:
        return self._reduce(a.sum(0, keepdim=True), dist.ReduceOp.SUM)


@dataclass
class Mesh:
    """This rank's place in the ``(n_data, n_model)`` layout and its two
    groups: ``data_group`` (the ranks of its model index) and
    ``model_group`` (the ranks of its data index)."""

    n_data: int
    n_model: int
    rank: int
    data_group: object
    model_group: object

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def patterns(self) -> PatternGroup:
        return PatternGroup(self.model_group)


def make_mesh(n_model: int = 1) -> Mesh:
    """The ``(world // n_model, n_model)`` layout of the initialized process
    group. Every rank creates every group, in one order, as
    ``torch.distributed.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world size {world}")
    n_data = world // n_model
    data_groups = [dist.new_group([i * n_model + j for i in range(n_data)]) for j in range(n_model)]
    model_groups = [dist.new_group([i * n_model + j for j in range(n_model)]) for i in range(n_data)]
    return Mesh(n_data, n_model, rank, data_groups[rank % n_model], model_groups[rank // n_model])


def process_batch_bounds(mesh: Mesh, global_batch: int) -> tuple[int, int]:
    """Half-open ``[start, stop)`` of the global batch that this rank's data
    index trains on; the ranks of one model group share it."""
    if global_batch % mesh.n_data:
        raise ValueError(f"batch {global_batch} does not split over {mesh.n_data} data ranks")
    per = global_batch // mesh.n_data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def pattern_rows(mesh: Mesh, m: int) -> slice:
    """The rows of an ``M``-row pattern memory that this rank holds."""
    if m % mesh.n_model:
        raise ValueError(f"{m} patterns do not split over {mesh.n_model} model ranks")
    per = m // mesh.n_model
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def shard_patterns(model: nn.Module, mesh: Mesh) -> None:
    """Replace each lookup's ``lookup_weights`` by this rank's rows, a new
    parameter (build the optimizer after this)."""
    for name in LAYERS:
        layer = getattr(model, name)
        rows = pattern_rows(mesh, layer.lookup_weights.shape[0])
        layer.lookup_weights = nn.Parameter(layer.lookup_weights.detach()[rows].clone())


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The full memory of a pattern shard ``t``: the model group's shards
    in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts)


def broadcast_state(model: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    for t in model.state_dict().values():
        dist.broadcast(t, 0)
