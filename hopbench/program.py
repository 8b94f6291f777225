"""The program under test as the benchmark builds it: its settings and configuration."""

from __future__ import annotations

import torch


def program_settings(cell, device) -> dict:
    """The port's production settings on the card; its plain float32 path
    on the CPU."""
    if device.type == "cuda":
        dtype = {"bfloat16": torch.bfloat16, "float32": None}[cell.precision.get("conv_stacks", "float32")]
        return {"impl": "cuda", "compute_dtype": dtype}
    return {"impl": "torch", "compute_dtype": None}


def program_config(cell):
    from hopvae_torch.config import MakeConfig

    return MakeConfig(dict(cell.config))
