"""Checkpoints from the port back to the JAX package, on the CPU.

- ``save_msgpack`` against flax: the same bytes as
  ``flax.serialization.msgpack_serialize`` of the tree's state dict, and
  as the JAX package's ``save_params`` (``to_bytes`` of
  ``jax.device_get(tree)``), on trees that reach every length encoding
  the parameters use; ``load_msgpack`` reads it back.
- ``params_to_jax`` against JAX's ``HopVAE.init``: the inverse of
  ``params_from_jax`` leaf for leaf, the PixelCNN masks included.
- ``tools/torch_convert_checkpoint.py``: a port model written to
  ``.msgpack`` loads through JAX's strict ``load_params`` and its JAX
  forward (``impl="xla"``, f32) matches the port's plain forward within
  ``tests/test_torch_model.py``'s tolerances: recon rtol 1e-3, atol 1e-4;
  the aux loss (with the prior's bits where the config has a learned
  prior) rtol 1e-3, atol 1e-6. The shipped PixelCNN checkpoint goes to
  ``.pt`` and back bit for bit; the reference's ``.ckpt`` gives the bytes
  of JAX's own converter; a trainer ``.pt`` resumes in JAX's ``Trainer``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from chip_smoke import reference_key
from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.train import Trainer as JaxTrainer
from hopvae_tpu.utils import checkpoint as jax_ckpt
from hopvae_torch import HopVAE, Trainer, load_config, serving
from hopvae_torch.utils.checkpoint import (load_msgpack, load_reference_checkpoint, params_from_jax, params_to_jax,
                                           save_msgpack)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import convert_checkpoint as jax_converter  # noqa: E402
import torch_convert_checkpoint as converter  # noqa: E402

CKPTS = ROOT / "checkpoints"
RTOL, ATOL, AUX_ATOL = 1e-3, 1e-4, 1e-6  # tests/test_torch_model.py's
# name → (config, overrides): the Transformer prior at a small width
CASES = {
    "mnist_28": ("mnist_28", {}),
    "pixelcnn_mnist_28": ("pixelcnn_mnist_28", {}),
    "transformer": ("mnist_28", {"prior": "Transformer", "prior_d_model": 32, "prior_layers": 2}),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _configs(case: str):
    name, over = CASES[case]
    jcfg, tcfg = jax_load_config(name), load_config(name)
    for k, v in over.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    return jcfg, tcfg


def _sets(case: str) -> list:
    name, over = CASES[case]
    return ["--config", name, *[a for k, v in over.items() for a in ("--set", f"{k}={v}")]]


_INITS: dict = {}


def _jax_init(case: str):
    """JAX's ``HopVAE.init`` tree of a case, on the host (compiled once)."""
    if case not in _INITS:
        _INITS[case] = jax.device_get(jax.jit(JaxHopVAE(_configs(case)[0]).init)(jax.random.PRNGKey(0)))
    return _INITS[case]


def _assert_same_tree(got, want):
    (gl, gt), (wl, wt) = jax.tree_util.tree_flatten(got), jax.tree_util.tree_flatten(want)
    assert gt == wt
    for a, b in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the writer

def _trees() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "nested maps": {"b": {"z": f32(3, 4), "a": {"deep": {"deeper": f32(2)}}}, "a": f32(5)},
        "a list": {"layers": [{"kernel": f32(3, 3, 2, 4)}, {"kernel": f32(1, 1, 4, 2)}], "bias": f32(2)},
        "dtypes": {"f32": f32(2, 3), "i32": rng.integers(-9, 9, (4,), dtype=np.int32),
                   "u8": rng.integers(0, 255, (2, 5), dtype=np.uint8), "f64": rng.standard_normal(3)},
        "0-d arrays": {"f32": np.array(1.5, np.float32), "i32": np.array(-7, np.int32),
                       "u8": np.array(200, np.uint8)},
        "bin32": {"big": f32(20_000), "small": f32(1)},  # 80,000 bytes: bin32 in ext32
        "bin16 and str8": {"k" * 40: f32(300), "v": np.zeros((0, 3), np.float32)},
        "map16": {f"p{i:02d}": np.full((i,), i, np.int32) for i in range(20)},
        "all": {"enc": {"conv": {"kernel": f32(4, 4, 1, 8), "bias": f32(8)}},
                "res": [{"a": f32(3)}, {"b": np.array(2.0, np.float32)}], "big": f32(17_000),
                "u8": rng.integers(0, 255, (70_000,), dtype=np.uint8), "prior": {}},
    }


@pytest.mark.parametrize("case", list(_trees()))
def test_save_msgpack_writes_flax_bytes(tmp_path, case):
    tree = _trees()[case]
    save_msgpack(str(tmp_path / "port.msgpack"), tree)
    got = (tmp_path / "port.msgpack").read_bytes()
    # flax writes the state dict; its copy of the tree orders map keys as
    # JAX sorts them (a list's keys too, so "10" before "2": no list here
    # is that long)
    assert got == serialization.msgpack_serialize(serialization.to_state_dict(tree))
    jax_ckpt.save_params(str(tmp_path / "jax.msgpack"), tree)
    assert got == (tmp_path / "jax.msgpack").read_bytes()


def test_save_msgpack_orders_a_long_list_as_save_params(tmp_path):
    """A list of 12: by index, as ``to_bytes`` writes it (``"2"`` before
    ``"10"``)."""
    tree = {"blocks": [np.full((2,), i, np.float32) for i in range(12)]}
    save_msgpack(str(tmp_path / "port.msgpack"), tree)
    jax_ckpt.save_params(str(tmp_path / "jax.msgpack"), tree)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


@pytest.mark.parametrize("case", list(_trees()))
def test_load_msgpack_reads_back_what_save_msgpack_wrote(tmp_path, case):
    tree = _trees()[case]
    save_msgpack(str(tmp_path / "t.msgpack"), tree)
    back = load_msgpack(str(tmp_path / "t.msgpack"))
    want = serialization.to_state_dict(tree)  # lists come back as maps keyed by index
    _assert_same_tree(back, want)


def test_save_msgpack_refuses_what_the_format_lacks(tmp_path):
    with pytest.raises(TypeError, match="cannot write"):
        save_msgpack(str(tmp_path / "x.msgpack"), {"a": object()})
    with pytest.raises(TypeError, match="dtype"):
        save_msgpack(str(tmp_path / "x.msgpack"), {"a": np.array([None], dtype=object)})
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------ the layouts

@pytest.mark.parametrize("case", list(CASES))
def test_params_to_jax_inverts_params_from_jax(case):
    """JAX's init tree → the port's names → back: the same tree, leaf for
    leaf (shapes, dtypes, values; the PixelCNN's masks from
    ``_group_mask``)."""
    tree = _jax_init(case)
    back = params_to_jax(params_from_jax(tree), _configs(case)[1])
    _assert_same_tree(back, tree)
    assert (back["prior"] == {}) == (case == "mnist_28")


def test_params_to_jax_holds_the_config_prior():
    _, tcfg = _configs("mnist_28")
    torch.manual_seed(0)
    state = HopVAE(load_config("pixelcnn_mnist_28"), impl="torch", device="cpu").state_dict()
    with pytest.raises(ValueError, match="prior"):
        params_to_jax(state, tcfg)  # a PixelCNN's tensors under the Normal prior


# ------------------------------------------------------------ the converter

def _port_model(tcfg, seed: int = 3) -> HopVAE:
    torch.manual_seed(seed)
    return HopVAE(tcfg, impl="torch", device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_converted_port_model_runs_in_jax(tmp_path, case, capsys):
    """A port model (its own seeded init) → ``.pt`` → the converter →
    ``.msgpack`` → JAX's strict ``load_params``; JAX's f32 forward matches
    the port's."""
    jcfg, tcfg = _configs(case)
    model = _port_model(tcfg)
    torch.save({"model": model.state_dict()}, tmp_path / "model.pt")
    out = tmp_path / "model.msgpack"
    assert converter.main([*_sets(case), "--input", str(tmp_path / "model.pt"), "--output", str(out)]) == 0
    n = len(jax.tree_util.tree_leaves(_jax_init(case)))
    assert f"{n} tensors" in capsys.readouterr().out
    jm = JaxHopVAE(jcfg)
    params = jax_ckpt.load_params(str(out), _jax_init(case))
    fit_prior = tcfg.prior != "None"
    x = np.random.default_rng(5).standard_normal((4, 28, 28, 1)).astype(np.float32)
    recon_j, aux_j = jax.jit(lambda p, v: jm.forward(p, v, fit_prior=fit_prior))(params, jnp.asarray(x))
    with torch.no_grad():
        recon, aux = model(torch.from_numpy(x), fit_prior=fit_prior)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=RTOL, atol=AUX_ATOL)


def test_pixelcnn_checkpoint_goes_to_pt_and_back_bit_for_bit(tmp_path):
    src = CKPTS / "PixelCNN-MNIST-28.msgpack"
    pt, back = tmp_path / "anchor.pt", tmp_path / "anchor.msgpack"
    for inp, out in ((src, pt), (pt, back)):
        assert converter.main(["--config", "pixelcnn_mnist_28", "--input", str(inp), "--output", str(out)]) == 0
    _assert_same_tree(load_msgpack(str(back)), load_msgpack(str(src)))
    assert back.read_bytes() == src.read_bytes()
    # the .pt is the port's own checkpoint: the loader and the serving CLI's state read it strictly
    model = _port_model(load_config("pixelcnn_mnist_28"))
    assert load_reference_checkpoint(model, str(pt)) == []
    want = params_from_jax(load_msgpack(str(src)))
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name
    served = serving.served_state(load_config("pixelcnn_mnist_28"), str(pt))
    assert all(torch.equal(served[k], v) for k, v in model.state_dict().items())


def test_reference_ckpt_converts_as_jax_converter_does(tmp_path):
    """The reference's torch ``state_dict`` (its 61 names) → ``.msgpack``:
    the bytes of ``tools/convert_checkpoint.py``."""
    _, tcfg = _configs("mnist_28")
    state = _port_model(tcfg, seed=7).state_dict()
    torch.save({reference_key(k): v[None] if k.endswith("lookup_weights") else v for k, v in state.items()},
               tmp_path / "MNIST-28.ckpt")
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    converter.main(["--config", "mnist_28", "--input", str(tmp_path / "MNIST-28.ckpt"), "--output", str(ours)])
    jax_converter.main(["--config", "mnist_28", "--input", str(tmp_path / "MNIST-28.ckpt"), "--output", str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()
    back = params_from_jax(load_msgpack(str(ours)))
    assert len(back) == 61 and all(torch.equal(back[k], v) for k, v in state.items())


def test_trainer_pt_resumes_in_jax(tmp_path):
    """A trainer ``.pt`` at epoch 4 converted into an out directory: JAX's
    ``Trainer._try_resume`` returns its parameters and epoch 5, and finds
    no optimizer state (Adam and the schedule start fresh)."""
    jcfg, tcfg = _configs("mnist_28")
    trainer = Trainer(_port_model(tcfg), tcfg)
    trainer.build_optimizer(1)
    trainer.save(4, str(tmp_path / "port"))
    jax_out = tmp_path / "jax"
    tag = f"{tcfg.data_set}-{tcfg.image_size}"
    converter.main(["--config", "mnist_28", "--input", trainer.checkpoint_path(str(tmp_path / "port")),
                    "--output", str(jax_out / f"{tag}.ckpt.msgpack")])
    assert json.loads((jax_out / f"{tag}.meta.json").read_text()) == {"epoch": 4}
    jtrainer = JaxTrainer(JaxHopVAE(jcfg), jcfg)
    params, start = jtrainer._try_resume(_jax_init("mnist_28"), str(jax_out), 0)
    assert start == 5
    _assert_same_tree(jax.device_get(params), params_to_jax(trainer.model.state_dict(), tcfg))
    opt_state = {"count": np.zeros((), np.int32)}
    assert jtrainer._try_resume_opt(opt_state, str(jax_out)) is opt_state


def test_converter_refuses_an_unknown_output(tmp_path):
    with pytest.raises(SystemExit):
        converter.main(["--config", "mnist_28", "--input", str(CKPTS / "PixelCNN-MNIST-28.msgpack"),
                        "--output", str(tmp_path / "x.npz")])
    with pytest.raises(FileNotFoundError):
        converter.main(["--config", "mnist_28", "--input", str(tmp_path / "absent.pt"),
                        "--output", str(tmp_path / "x.pt")])
    assert not os.listdir(tmp_path)
