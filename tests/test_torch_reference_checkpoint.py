"""The reference's torch checkpoint in the port (``load_reference_checkpoint``)
against the JAX package's loader of the same name on the CPU.

A reference-keyed ``state_dict`` (the hflayers and ``_layers.{i}._block``
names of the reference HopVAE; ``chip_smoke.reference_key`` maps the
port's names onto them) is made from a seeded init plus numpy noise,
saved with ``torch.save``, and loaded by both packages: exactly equal
tensors, an f32 forward within ``test_torch_model.py``'s tolerances, and
the same paths reported where the load is partial (one key dropped, one
extra, one shape off; a wider ``.msgpack``). Then the trainer's default
checkpoint path and the serving CLI.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from chip_smoke import reference_key
from hopvae_tpu.config import load_config as jax_load_config
from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
from hopvae_tpu.utils import checkpoint as jax_ckpt
from hopvae_torch import HopVAE, load_config
from hopvae_torch import serving
from hopvae_torch import train as ttrain
from hopvae_torch.utils import checkpoint as ckpt
from hopvae_torch.utils.checkpoint import load_reference_checkpoint, params_from_jax

TINY = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 64, "embedding_dim": 16}


def _configs(over):
    jcfg, tcfg = jax_load_config("mnist_28"), load_config("mnist_28")
    for k, v in over.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    return jcfg, tcfg


def _port_state(tcfg, seed: int) -> dict:
    torch.manual_seed(seed)
    return HopVAE(tcfg, impl="torch", device="cpu").state_dict()


def _to_reference(state: dict) -> dict:
    return {reference_key(k): v[None] if k.endswith("lookup_weights") else v for k, v in state.items()}


def _jax_params(jcfg, tcfg, seed: int = 0):
    """JAX parameters equal to the port's fresh init with ``seed``, made by
    JAX's own converter (a JAX init compiles for seconds)."""
    sd = {k: v.numpy() for k, v in _to_reference(_port_state(tcfg, seed)).items()}
    return jax_ckpt.convert_torch_state_dict(sd, jcfg)


def _reference_sd(tcfg, seed=1) -> dict:
    """A reference-keyed state_dict: the port's init plus numpy noise drawn
    with ``seed``, under the reference's names."""
    rng = np.random.default_rng(seed)
    state = {k: v + torch.from_numpy((0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
             for k, v in _port_state(tcfg, 1).items()}
    return _to_reference(state)


def _port_name(jax_path: str) -> str:
    """A path JAX's lenient_merge reports → the port's state-dict name."""
    path = jax_path.split(" (")[0].strip("/")
    parts = re.sub(r"\[(\d+)\]", r"/\1", path).split("/")
    parts[-1] = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts)


def _jax_load(jcfg, tcfg, path) -> dict:
    return params_from_jax(jax_ckpt.load_reference_checkpoint(JaxHopVAE(jcfg), _jax_params(jcfg, tcfg), str(path)))


def _port_load(tcfg, path, seed=0):
    torch.manual_seed(seed)
    model = HopVAE(tcfg, impl="torch", device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    return model, load_reference_checkpoint(model, str(path)), fresh


@pytest.mark.parametrize("over", [TINY, {}], ids=["tiny", "mnist_28"])
def test_reference_checkpoint_loads_as_in_jax(over, tmp_path):
    """Every tensor equals JAX's ``load_reference_checkpoint`` then
    ``params_from_jax``, bit for bit (61 at the full ``mnist_28``: the
    reference's count), and the f32 forward agrees with JAX's."""
    jcfg, tcfg = _configs(over)
    sd = _reference_sd(tcfg)
    path = tmp_path / "MNIST-28.ckpt"
    torch.save(sd, path)
    want = _jax_load(jcfg, tcfg, path)
    model, dropped, _ = _port_load(tcfg, path)
    got = model.state_dict()
    assert dropped == [] and got.keys() == want.keys() and len(sd) == len(got)
    if not over:
        assert len(sd) == 61
    for name, v in want.items():
        assert torch.equal(got[name], v), name

    x = np.random.default_rng(0).standard_normal((4, 28, 28, 1)).astype(np.float32)
    jm = JaxHopVAE(jcfg)
    params = jax_ckpt.load_reference_checkpoint(jm, _jax_params(jcfg, tcfg), str(path))
    recon_j, aux_j = jax.jit(jm.forward)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        recon, aux = model(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-3, atol=1e-6)


def _jax_dropped(jcfg, tcfg, sd, drop=None) -> list:
    """The paths JAX's lenient_merge reports for ``sd`` converted, with the
    leaf at the port name ``drop`` taken out of the converted tree (JAX's
    converter itself raises on a missing key)."""
    params = _jax_params(jcfg, tcfg)
    converted = jax_ckpt.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    if drop is not None:
        *parents, leaf = drop.split(".")
        node = converted
        for p in parents:
            node = node[int(p)] if isinstance(node, list) else node[p]
        del node["kernel" if leaf == "weight" and "kernel" in node else leaf]
    dropped = []
    jax_ckpt.lenient_merge(params, converted, dropped=dropped)
    return sorted(_port_name(p) for p in dropped)


@pytest.mark.parametrize("case", ["dropped", "extra", "shape"])
def test_lenient_cases_report_what_jax_reports(case, tmp_path, capsys):
    """One key dropped (that tensor keeps the port's fresh init), one extra
    (ignored by both converters), one at another shape (fresh kept): every
    other tensor is JAX's, and the reported paths are JAX's, on stderr in
    JAX's words."""
    jcfg, tcfg = _configs(TINY)
    sd = _reference_sd(tcfg)
    full = tmp_path / "full.ckpt"
    torch.save(sd, full)
    want = _jax_load(jcfg, tcfg, full)
    name = {"dropped": "encoder.conv_2.bias", "extra": None, "shape": "hopfield.in_proj.weight"}[case]
    if case == "dropped":
        del sd[reference_key(name)]
    elif case == "extra":
        sd["unused_buffer"] = torch.ones(3)
    else:
        sd[reference_key(name)] = torch.ones(5, 5)
    path = tmp_path / f"{case}.ckpt"
    torch.save(sd, path)
    model, dropped, fresh = _port_load(tcfg, path)
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], fresh[k] if k == name else v), k
    # JAX's converter raises on the dropped key: its merge sees the leaf taken out
    jax_sd, drop = (torch.load(full), name) if case == "dropped" else (sd, None)
    theirs = _jax_dropped(jcfg, tcfg, jax_sd, drop=drop)
    assert sorted(d.split(" (")[0] for d in dropped) == theirs == ([] if name is None else [name])
    err = capsys.readouterr().err
    assert ("kept their fresh initialization / were ignored" in err) == (name is not None)


def test_wider_msgpack_loads_partially_as_jax(tmp_path, capsys):
    """A ``.msgpack`` of another ``embedding_dim`` loads where the shapes
    still match, as ``load_params_lenient`` does, with the same paths
    reported."""
    jwide, twide = _configs({**TINY, "embedding_dim": 24})
    jcfg, tcfg = _configs(TINY)
    path = tmp_path / "wide.msgpack"
    jax_ckpt.save_params(str(path), _jax_params(jwide, twide, seed=1))
    params = _jax_params(jcfg, tcfg)
    want = params_from_jax(jax_ckpt.load_params_lenient(str(path), params))
    raw = serialization.msgpack_restore(path.read_bytes())
    theirs = []
    jax_ckpt.lenient_merge(serialization.to_state_dict(jax.device_get(params)), raw, dropped=theirs)

    torch.manual_seed(0)
    model = HopVAE(tcfg, impl="torch", device="cpu")  # the init JAX's params were made from
    dropped = load_reference_checkpoint(model, str(path))
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert sorted(d.split(" (")[0] for d in dropped) == sorted(_port_name(p) for p in theirs)
    assert 0 < len(dropped) < len(got) and "warning: lenient load" in capsys.readouterr().err


def _cli(tmp_path, *extra):
    sets = [f"--set={k}={v}" for k, v in {**TINY, "batch_size": 512}.items()]
    return ["--config", "mnist_28", "--device", "cpu", "--impl", "torch", "--eval-only", "--out",
            str(tmp_path / "out"), *sets, *extra]


def test_trainer_default_checkpoint(tmp_path, monkeypatch):
    """The trainer reads ``checkpoints/MNIST-28.ckpt`` under the working
    directory when it exists and starts fresh when it does not; an
    explicit ``--checkpoint`` that does not exist fails in the parser."""
    _, tcfg = _configs(TINY)
    sd = _reference_sd(tcfg, seed=5)
    loads = []

    def spy(model, path):
        out = load_reference_checkpoint(model, path)
        loads.append((path, {k: v.clone() for k, v in model.state_dict().items()}))
        return out

    monkeypatch.setattr(ttrain, "load_reference_checkpoint", spy)
    monkeypatch.setattr(ttrain.Trainer, "evaluate", lambda self, *a, **k: 0.0)
    monkeypatch.chdir(tmp_path)
    ttrain.main(_cli(tmp_path))
    (tmp_path / "checkpoints").mkdir()
    torch.save(sd, tmp_path / "checkpoints" / "MNIST-28.ckpt")
    ttrain.main(_cli(tmp_path))
    (path0, absent), (path1, present) = loads
    assert path0 == path1 == "checkpoints/MNIST-28.ckpt"
    conv = present["encoder.conv_1.weight"]
    assert torch.equal(conv, sd["encoder.conv_1.weight"]) and not torch.equal(conv, absent["encoder.conv_1.weight"])
    with pytest.raises(SystemExit):
        ttrain.main(_cli(tmp_path, "--checkpoint", str(tmp_path / "missing.ckpt")))


def test_serving_cli_takes_a_reference_ckpt_and_a_pt(tmp_path):
    """The serving CLI reconstructs through a reference ``.ckpt`` as the port
    model loaded from it does, and a ``.pt`` of the trainer still loads."""
    _, tcfg = _configs(TINY)
    sd = _reference_sd(tcfg, seed=7)
    ref = tmp_path / "MNIST-28.ckpt"
    torch.save(sd, ref)
    model, _, _ = _port_load(tcfg, ref)
    pt = tmp_path / "run.pt"
    torch.save({"model": model.state_dict(), "epoch": 0}, pt)
    x = np.random.default_rng(1).standard_normal((3, 28, 28)).astype(np.float32)
    inputs = []
    for i, img in enumerate(x):
        np.save(tmp_path / f"in{i}.npy", img)
        inputs.append(str(tmp_path / f"in{i}.npy"))
    with torch.no_grad():
        want = model(torch.from_numpy(x[..., None]))[0].numpy()
    sets = [f"--set={k}={v}" for k, v in TINY.items()]
    for i, path in enumerate((ref, pt)):
        out = tmp_path / f"served{i}"
        serving.main(["--config", "mnist_28", "--checkpoint", str(path), "--out", str(out), "--impl", "torch",
                      "--compute-dtype", "float32", "--device", "cpu", *sets, *inputs])
        np.testing.assert_allclose(np.load(out / "reconstructions.npy"), want, rtol=1e-5, atol=1e-6)
