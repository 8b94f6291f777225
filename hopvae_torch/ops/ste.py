"""Straight-through round (port of ``hopvae_tpu/ops/ste.py``)."""

from __future__ import annotations

import torch


def straight_through_round(x: torch.Tensor) -> torch.Tensor:
    """Forward: round half to even (as ``jnp.round``). Backward: identity."""
    return x + (torch.round(x) - x).detach()
