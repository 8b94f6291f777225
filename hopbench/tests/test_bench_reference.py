"""The plain reference against the port's ``impl="torch"`` path at a tiny
size on the CPU: the forward, the PixelCNN's logits and the decode of a
grid; the weights' schema against every
registered configuration."""

import math

import pytest
import tiny
import torch

from hopbench import harness, seeded
from hopbench.reference.model import Model, exact_f32, fp8, tf32


def _cfg(name="ffhq64-recon"):
    cell = harness.resolve(name, config_overrides=tiny.CONFIG)
    return cell.namespace(), cell


def _program(cfg):
    from hopvae_torch.config import MakeConfig
    from hopvae_torch.models.hopvae import HopVAE

    state = seeded.state(cfg, tiny.SEED, "cpu")
    model = HopVAE(MakeConfig(dict(vars(cfg))), impl="torch", device="cpu")
    model.load_state_dict(state)
    return model, state


@pytest.mark.parametrize("name", ["mnist_28", "pixelcnn_mnist_28", "cifar10_32", "ffhq_32", "ffhq_64",
                                  "ffhq_64_scaled", "ffhq_128"])
def test_schema_is_the_ports_state_dict(name):
    from hopvae_torch.config import load_config
    from hopvae_torch.models.hopvae import HopVAE

    cfg = load_config(name)
    if cfg.prior not in ("PixelCNN", "None", None):
        cfg.prior = "None"
    shapes = {k: tuple(v.shape) for k, v in HopVAE(cfg, impl="torch", device="meta").state_dict().items()}
    assert {n: tuple(s) for n, s, *_ in seeded.schema(cfg)} == shapes


def test_weights_and_images_follow_the_seed():
    cfg, _ = _cfg()
    a, b, c = (seeded.state(cfg, s, "cpu") for s in (tiny.SEED, tiny.SEED, tiny.SEED + 1))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["hopfield.lookup_weights"],
                                                                     c["hopfield.lookup_weights"])
    x = seeded.images(cfg, 8, tiny.SEED, "cpu")
    assert x.shape == (8, 16, 16, 3) and torch.equal(x, seeded.images(cfg, 8, tiny.SEED, "cpu"))
    assert -0.5 <= float(x.min()) and float(x.max()) <= 0.5


def test_forward_matches_the_port():
    cfg, _ = _cfg()
    model, state = _program(cfg)
    x = seeded.images(cfg, 4, tiny.SEED, "cpu")
    with torch.no_grad(), exact_f32():
        y, aux = model(x)
        ry, raux = Model(cfg, state).forward(x)
    assert torch.allclose(y, ry, atol=2e-6, rtol=1e-5)
    assert math.isclose(float(aux), float(raux), rel_tol=1e-4)


def test_pixelcnn_logits_and_decode_match_the_port():
    cfg, _ = _cfg("pixelcnn-mnist28-sample")
    model, state = _program(cfg)
    g = torch.Generator().manual_seed(5)
    grid = torch.randint(0, cfg.num_levels, (2, cfg.representation_dim, cfg.representation_dim, cfg.index_dim),
                         generator=g).float()
    ref = Model(cfg, state)
    with torch.no_grad(), exact_f32():
        assert torch.allclose(model.prior(grid), ref.pixelcnn_logits(grid), atol=1e-5, rtol=1e-5)
        assert torch.allclose(model.decode_grid(grid), ref.decode_grid(grid), atol=2e-6, rtol=1e-5)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 3.0])
    assert torch.equal(tf32(x), torch.tensor([1.0, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0]))
    y = torch.linspace(-2.0, 2.0, 101)
    assert 0 < float((fp8(y) - y).abs().max()) <= 2.0 / 2**3 / 2 * 1.01
