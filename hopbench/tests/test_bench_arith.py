"""The copied FLOPs model equals the port's for every registered
configuration, and one least time checked by hand."""

import pytest

from hopbench.arith import flops


def _configs():
    from hopvae_torch.configs import available_configs

    return available_configs()


@pytest.mark.parametrize("name", _configs())
def test_flops_equal_the_ports(name):
    from hopvae_torch.config import load_config
    from hopvae_torch.utils import flops as port

    cfg = load_config(name)
    assert flops.forward_flops_per_image(cfg) == port.forward_flops_per_image(cfg)
    assert flops.train_flops_per_image(cfg) == port.train_flops_per_image(cfg)
    assert flops.conv_flops_per_image(cfg) + flops.bottleneck_flops(cfg) == port.forward_flops_per_image(cfg)


def test_one_least_time_by_hand():
    """K1 of the (64, 64) lookup at N 73,984 (batch 256 of a 17x17 grid),
    M 4,096: 2·N·M·128 FLOPs at 989 TFLOP/s against its f32 words at 3.35
    TB/s; the operations bound it."""
    n, m = 256 * 17 * 17, 4096
    fl, by = flops.lookup_work("K1", n, m, 64, 64)
    assert fl == 2 * 73984 * 4096 * 128 == 77_577_846_784
    words = 73984 * 64 + 4096 * 128 + 2 * 64 + 73984 * 64 + 2 * 73984
    assert by == 4 * words
    assert flops.least_seconds(fl, by) == pytest.approx(77_577_846_784 / 989e12)
    assert flops.least_seconds(fl, by) == pytest.approx(7.844e-5, rel=1e-3)


def test_a_training_step_counts_each_kernel_once():
    class Cfg:
        representation_dim, num_embeddings, embedding_dim, index_dim = 17, 4096, 64, 3

    step = flops.lookups_least_seconds(Cfg, 256, ("K1", "K2", "K3"))
    fwd = flops.lookups_least_seconds(Cfg, 256, ("K1",))
    assert 7.0e-4 < step < 7.4e-4 and 1.5e-4 < fwd < 1.7e-4
    with pytest.raises(ValueError):
        flops.lookup_work("K4", 1, 1, 1, 1)
