"""The parameterless uniform prior (the reference's ``Normal`` stub).

Port of ``hopvae_tpu/models/priors/normal.py``: ``forward`` returns
uniform random logits under a fixed seed, ``sample`` draws
``floor(U[0, 1) * num_levels)``, ``reconstruct`` is the identity and
``interpolate`` averages. The random numbers come from a
``torch.Generator``, so they are not JAX's threefry draws.
"""

from __future__ import annotations

import torch
from torch import nn


class NormalPrior(nn.Module):
    has_params = False

    def __init__(self, config):
        super().__init__()
        self.index_dim = config.index_dim
        self.representation_dim = config.representation_dim
        self.num_levels = config.num_levels

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Uniform random logits ``(B, r, r, C, num_levels)``, seed 0."""
        r, b = self.representation_dim, grid.shape[0]
        gen = torch.Generator(device=grid.device).manual_seed(0)
        shape = (b, r, r, self.index_dim, self.num_levels)
        return torch.rand(shape, generator=gen, device=grid.device, dtype=grid.dtype)

    def sample(self, num_samples: int = 1, generator: torch.Generator | None = None, device=None):
        r = self.representation_dim
        u = torch.rand((num_samples, r, r, self.index_dim), generator=generator, device=device)
        return torch.floor(u * self.num_levels)

    def reconstruct(self, grid: torch.Tensor) -> torch.Tensor:
        return grid

    def interpolate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (x + y) / 2
