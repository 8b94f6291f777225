"""The port's package exports ``Trainer`` and ``InferenceEngine`` lazily, as
``hopvae_tpu/__init__.py`` does: importing the package loads neither
``hopvae_torch.train`` nor ``hopvae_torch.serving``."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import os
import subprocess
import sys

import pytest

import hopvae_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lazy_exports_are_the_modules_classes():
    from hopvae_torch.serving import InferenceEngine
    from hopvae_torch.train import Trainer

    assert hopvae_torch.Trainer is Trainer
    assert hopvae_torch.InferenceEngine is InferenceEngine
    assert {"Trainer", "InferenceEngine", "HopVAE", "load_config"} <= set(hopvae_torch.__all__)


def test_import_leaves_train_and_serving_unloaded():
    code = ("import sys, hopvae_torch; "
            "print(sorted(m for m in ('hopvae_torch.train', 'hopvae_torch.serving') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT}, check=True)
    assert proc.stdout.strip() == "[]"


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no_such_name"):
        hopvae_torch.no_such_name  # noqa: B018
