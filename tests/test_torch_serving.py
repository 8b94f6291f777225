"""The port's InferenceEngine and CLI on the CPU path (impl="torch", f32)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from hopvae_torch import HopVAE, load_config
from hopvae_torch.data import GOLDENS, golden_digits, golden_input
from hopvae_torch.serving import InferenceEngine, main, state_from_checkpoint
from hopvae_torch.train import Trainer

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / GOLDENS["mnist_digits"]["checkpoint"]


@pytest.fixture(scope="module")
def state():
    return state_from_checkpoint(str(CKPT))


def _engine(state, max_batch=8, **kw):
    """An engine of the MNIST golden's config, reconstruct and encode unless
    ``ops`` says otherwise."""
    cfg = load_config(GOLDENS["mnist_digits"]["config"])
    kw = {"impl": "torch", "compute_dtype": None, "device": "cpu", "ops": ("reconstruct", "encode"), **kw}
    return cfg, InferenceEngine(cfg, state, max_batch=max_batch, **kw)


def test_reconstruct_pads_and_unpads(state):
    cfg, eng = _engine(state)
    x = golden_input("mnist_digits")[:3]
    y = eng.reconstruct(x)
    assert y.shape == (3, 28, 28, 1) and y.dtype == np.float32
    # the same inputs in another batch size give the same outputs
    np.testing.assert_allclose(eng.reconstruct(x[:2]), y[:2], rtol=1e-5, atol=1e-6)
    z = eng.encode(x[:2])
    assert z.shape == (2, cfg.representation_dim**2, cfg.embedding_dim)


def test_reconstruct_rejects_oversize_batch(state):
    _, eng = _engine(state, max_batch=4)
    with pytest.raises(ValueError, match="max_batch"):
        eng.reconstruct(np.zeros((5, 28, 28, 1), np.float32))


def test_engine_rejects_unported_and_unwarmed_ops(state):
    """Every op of the JAX engine is served (sample under the anchor's
    PixelCNN prior too); a name that is none of them raises, and so does
    an op the engine did not warm up."""
    _, eng = _engine(state, max_batch=2, ops=("reconstruct", "sample"), n_sample=2)
    assert eng.sample(0).shape == (2, 28, 28, 1)
    with pytest.raises(ValueError, match="unknown ops"):
        _engine(state, ops=("reconstruct", "denoise"))
    _, eng = _engine(state, max_batch=2, ops=("encode",))
    with pytest.raises(RuntimeError, match="reconstruct"):
        eng.reconstruct(np.zeros((1, 28, 28, 1), np.float32))


def test_default_device_without_cuda_raises(state, monkeypatch):
    """No device argument means the card; without one the engine raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("mnist_28")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, state, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HopVAE(cfg, impl="torch")


def test_cuda_impl_on_cpu_raises(state):
    with pytest.raises(ValueError, match="impl='cuda'"):
        _engine(state, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        HopVAE(load_config("mnist_28"), impl="pallas", device="cpu")


def test_cli_reconstructs_npy_inputs(tmp_path, capsys):
    digits = golden_digits()
    paths = []
    for i in range(3):  # raw uint8 (normalized by the CLI) and normalized float
        p = tmp_path / f"d{i}.npy"
        np.save(p, digits[i] if i < 2 else golden_input("mnist_digits")[i])
        paths.append(str(p))
    out = tmp_path / "served"
    main([
        "--config", "pixelcnn_mnist_28", "--checkpoint", str(CKPT), "--out", str(out),
        "--impl", "torch", "--compute-dtype", "float32", "--device", "cpu", "--max-batch", "2",
        *paths,
    ])
    y = np.load(out / "reconstructions.npy")
    assert y.shape == (3, 28, 28, 1) and np.isfinite(y).all()
    mse = float(np.mean((y - golden_input("mnist_digits")[:3]) ** 2))
    assert mse < 0.05  # trained reconstructions of the digits, not noise
    assert "recon MSE" in capsys.readouterr().out


def test_cli_serves_a_trainer_checkpoint(tmp_path, state):
    """Train, then serve: the ``.pt`` that ``Trainer.save`` writes goes
    through ``serving.main``, and its reconstructions equal
    ``HopVAE.reconstruct`` of the same state on the same inputs, within
    1e-5: the CPU's conv kernels sum in an order that depends on the input
    buffer's alignment (5e-6 between a slice and a fresh copy of the same
    values)."""
    name = GOLDENS["mnist_digits"]["config"]
    cfg = load_config(name)
    model = HopVAE(cfg, impl="torch", device="cpu")
    model.load_state_dict(state)
    trainer = Trainer(model, cfg)
    trainer.build_optimizer(1)
    trainer.save(0, str(tmp_path / "run"))
    ckpt = trainer.checkpoint_path(str(tmp_path / "run"))
    assert ckpt.endswith("MNIST-28.pt")
    x = golden_input("mnist_digits")[:3]
    paths = []
    for i, a in enumerate(x):
        np.save(tmp_path / f"x{i}.npy", a)
        paths.append(str(tmp_path / f"x{i}.npy"))
    main(["--config", name, "--checkpoint", ckpt, "--out", str(tmp_path / "served"), "--impl", "torch",
          "--compute-dtype", "float32", "--device", "cpu", *paths])
    got = np.load(tmp_path / "served" / "reconstructions.npy")
    model.eval()
    with torch.inference_mode():
        want = model.reconstruct(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
