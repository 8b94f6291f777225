"""Priors over the latent level grid: the factory.

Port of ``hopvae_tpu/models/priors/__init__.py``. A prior maps a grid
``(B, r, r, index_dim)`` of float integer levels to logits ``(B, r, r,
index_dim, num_levels)`` (``forward``), and has ``sample``,
``reconstruct`` and ``interpolate``; grids are NHWC as in the JAX package.
"""

from __future__ import annotations

from hopvae_torch.models.priors.normal import NormalPrior
from hopvae_torch.models.priors.pixelcnn import PixelCNNPrior
from hopvae_torch.models.priors.transformer import TransformerPrior


def get_prior(config, device=None):
    """``"PixelCNN"`` → :class:`PixelCNNPrior`; ``"Transformer"`` →
    :class:`TransformerPrior`; ``"None"`` or ``None`` (``--set prior=None``
    evaluates to the literal) → :class:`NormalPrior`."""
    if config.prior == "PixelCNN":
        return PixelCNNPrior(config, device=device)
    if config.prior == "Transformer":
        return TransformerPrior(config, device=device)
    if config.prior == "None" or config.prior is None:
        return NormalPrior(config)
    raise ValueError(f"unknown prior {config.prior!r}")
