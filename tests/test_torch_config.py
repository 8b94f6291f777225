"""The port's config copies equal the JAX package's."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import pytest

from hopvae_tpu.config import apply_overrides as jax_apply_overrides
from hopvae_tpu.configs import available_configs as jax_available, get_config as jax_get_config
from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.configs import available_configs, get_config

NAMES = (
    "mnist_28", "pixelcnn_mnist_28", "cifar10_32", "ffhq_32",
    "ffhq_64", "ffhq_64_scaled", "ffhq_128",
)


def test_registry_matches_jax():
    assert available_configs() == jax_available() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_dict_matches_jax(name):
    assert get_config(name) == jax_get_config(name)
    assert get_config(f"{name}_config") == get_config(name)


def test_overrides_match_jax():
    from hopvae_tpu.config import load_config as jax_load_config

    sets = ["num_hiddens=16", "prior=Transformer", "prior_heads=2", "data_set='FFHQ'"]
    ours, theirs = load_config("mnist_28"), jax_load_config("mnist_28")
    apply_overrides(ours, sets)
    jax_apply_overrides(theirs, sets)
    assert ours.to_dict() == theirs.to_dict()
    with pytest.raises(ValueError, match="KEY=VALUE"):
        apply_overrides(ours, ["no_equals_sign"])


def test_unknown_config_raises():
    with pytest.raises(KeyError, match="unknown config"):
        get_config("mnist_29")
