"""Priors over the latent level grid: the factory.

Port of ``hopvae_tpu/models/priors/__init__.py``. A prior maps a grid
``(B, r, r, index_dim)`` of float integer levels to logits ``(B, r, r,
index_dim, num_levels)`` (``forward``), and has ``reconstruct`` and
``interpolate``; grids are NHWC as in the JAX package.
"""

from __future__ import annotations

from hopvae_torch.models.priors.normal import NormalPrior
from hopvae_torch.models.priors.transformer import TransformerPrior

PIXELCNN_NOT_PORTED = "the PixelCNN prior is not ported yet (ROADMAP.md, Queue 1 item 5)"


def get_prior(config, device=None):
    """``"Transformer"`` → :class:`TransformerPrior`; ``"None"`` or ``None``
    (``--set prior=None`` evaluates to the literal) → :class:`NormalPrior`."""
    if config.prior == "Transformer":
        return TransformerPrior(config, device=device)
    if config.prior == "None" or config.prior is None:
        return NormalPrior(config)
    if config.prior == "PixelCNN":
        raise NotImplementedError(PIXELCNN_NOT_PORTED)
    raise ValueError(f"unknown prior {config.prior!r}")
