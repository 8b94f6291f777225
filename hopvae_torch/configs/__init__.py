"""Config registry: the port's own copies of ``hopvae_tpu/configs`` (same
dict schema and key names), selected by name with ``get_config``."""

from __future__ import annotations

import importlib

_REGISTRY = (
    "mnist_28",
    "pixelcnn_mnist_28",
    "cifar10_32",
    "ffhq_32",
    "ffhq_64",
    "ffhq_64_scaled",
    "ffhq_128",
)


def available_configs() -> tuple:
    return _REGISTRY


def get_config(name: str) -> dict:
    """Return a fresh copy of the named config dict."""
    name = name.removesuffix("_config")
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; available: {_REGISTRY}")
    mod = importlib.import_module(f"hopvae_torch.configs.{name}_config")
    return dict(mod.config)
