"""The port's checkpoint bridge against the JAX package: the pure-Python
msgpack reader against flax's, the layout conversions against the JAX
converters and convs, the Transformer prior's subtree, the lenient load
of a prior that does not match, and the committed golden digits."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from flax import serialization

from hopvae_tpu.data import render_digits
from hopvae_tpu.ops import conv as jax_conv
from hopvae_torch.data import golden_digits
from hopvae_torch.utils.checkpoint import load_msgpack, params_from_jax

CKPTS = Path(__file__).resolve().parents[1] / "checkpoints"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


@pytest.mark.parametrize("name", ["PixelCNN-MNIST-28.msgpack", "Transformer-FFHQ-64.msgpack"])
def test_load_msgpack_matches_flax(name):
    path = CKPTS / name
    ours = load_msgpack(str(path))
    theirs = serialization.msgpack_restore(path.read_bytes())
    assert "prior" in theirs and "prior" in ours
    a, b = dict(_flatten(ours)), dict(_flatten(theirs))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg="/".join(key))


def test_load_msgpack_rejects_truncated_file(tmp_path):
    data = (CKPTS / "PixelCNN-MNIST-28.msgpack").read_bytes()
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        load_msgpack(str(cut))


def test_params_from_jax_round_trips_layouts():
    """torch layout → the JAX package's converters → params_from_jax is
    the identity, for conv, transposed conv, Linear and LayerNorm."""
    g = torch.Generator().manual_seed(0)
    conv = torch.randn(8, 3, 4, 4, generator=g)
    conv_t = torch.randn(6, 5, 4, 4, generator=g)
    lin = torch.randn(7, 4, generator=g)
    tree = {
        "encoder": {"conv_1": {"kernel": np.asarray(jax_conv.torch_conv_kernel_to_hwio(conv.numpy())),
                               "bias": np.arange(8.0)}},
        "decoder": {"conv_trans_2": {"kernel": np.asarray(jax_conv.torch_conv_transpose_kernel_to_hwio(conv_t.numpy())),
                                     "bias": np.arange(5.0)}},
        "hopfield": {"out_proj": {"kernel": lin.numpy().T, "bias": np.zeros(7)},
                     "norm_state": {"scale": np.ones(4), "bias": np.zeros(4)},
                     "lookup_weights": np.ones((3, 4))},
        "prior": {"anything": np.zeros(2)},
    }
    sd = params_from_jax(tree)
    torch.testing.assert_close(sd["encoder.conv_1.weight"], conv, rtol=0, atol=0)
    torch.testing.assert_close(sd["decoder.conv_trans_2.weight"], conv_t, rtol=0, atol=0)
    torch.testing.assert_close(sd["hopfield.out_proj.weight"], lin, rtol=0, atol=0)
    assert sd["hopfield.norm_state.weight"].shape == (4,)
    assert sd["hopfield.lookup_weights"].shape == (3, 4)
    assert not any(k.startswith("prior") for k in sd)
    with pytest.raises(ValueError, match="unknown parameter"):
        params_from_jax({"x": {"gamma": np.zeros(2)}})


@pytest.mark.parametrize("transposed,stride,padding", [(False, 2, 1), (False, 1, 2), (True, 1, 2), (True, 2, 1)])
def test_converted_conv_matches_jax_conv(transposed, stride, padding):
    """Weights bridged by params_from_jax give torch's conv the JAX conv's
    output, NHWC on the JAX side (tests/test_checkpoint_parity.py tolerances)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    k = rng.standard_normal((4, 4, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    name = "conv_trans_1" if transposed else "conv_1"
    sd = params_from_jax({"decoder": {name: {"kernel": k, "bias": b}}})
    w = sd[f"decoder.{name}.weight"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if transposed:
        ref = jax_conv.conv_transpose2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride, padding=padding)
        got = F.conv_transpose2d(xt, w, torch.from_numpy(b), stride=stride, padding=padding)
    else:
        ref = jax_conv.conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride=stride, padding=padding)
        got = F.conv2d(xt, w, torch.from_numpy(b), stride=stride, padding=padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_golden_digits_asset_matches_render_digits():
    digits, _ = render_digits(64, 28, seed=0)
    assert golden_digits().dtype == np.uint8
    np.testing.assert_array_equal(golden_digits(), digits)


def test_transformer_prior_subtree_maps_onto_the_prior():
    """The prior subtree of Transformer-FFHQ-64.msgpack, read by the port,
    lands in ``TransformerPrior``'s state_dict: Linear kernels transposed,
    LayerNorm scales as weights, blocks as ModuleList indices, embeddings
    as they are; every tensor equals flax's leaf."""
    from hopvae_torch import HopVAE, load_config

    path = CKPTS / "Transformer-FFHQ-64.msgpack"
    theirs = serialization.msgpack_restore(path.read_bytes())["prior"]
    sd = params_from_jax(load_msgpack(str(path)))
    cfg = load_config("ffhq_64_scaled")
    cfg.prior = "Transformer"
    model = HopVAE(cfg, impl="torch", device="cpu")
    prior_keys = {k for k in model.state_dict() if k.startswith("prior.")}
    assert prior_keys == {k for k in sd if k.startswith("prior.")} and len(prior_keys) == 4 * 12 + 7
    np.testing.assert_array_equal(sd["prior.tok_emb"].numpy(), theirs["tok_emb"])
    np.testing.assert_array_equal(sd["prior.pos_emb"].numpy(), theirs["pos_emb"])
    np.testing.assert_array_equal(sd["prior.blocks.3.qkv.weight"].numpy(), theirs["blocks"]["3"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["prior.blocks.0.ln2.weight"].numpy(), theirs["blocks"]["0"]["ln2"]["scale"])
    np.testing.assert_array_equal(sd["prior.head.weight"].numpy(), theirs["head"]["kernel"].T)
    model.load_state_dict(sd)
    torch.testing.assert_close(model.prior.blocks[2].mlp_out.bias, torch.from_numpy(np.array(theirs["blocks"]["2"]["mlp_out"]["bias"])))


def test_lenient_load_keeps_a_fresh_prior_that_does_not_match(capsys):
    """A PixelCNN checkpoint under prior=Transformer, a Transformer
    checkpoint under a PixelCNN config, and a PixelCNN checkpoint under
    prior=None: the backbone loads, the prior keeps its fresh
    initialization, and a warning names the dropped subtree. The PixelCNN
    subtree now loads into the PixelCNN prior, without a warning, each
    tensor flax's leaf (conv kernels HWIO → OIHW); a stored mask that is
    not the causality mask raises."""
    from hopvae_torch import HopVAE, load_config

    cfg = load_config("pixelcnn_mnist_28")
    cfg.prior, cfg.prior_d_model, cfg.prior_layers = "Transformer", 32, 1
    model = HopVAE(cfg, impl="torch", device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("prior.")}
    path = CKPTS / "PixelCNN-MNIST-28.msgpack"
    sd = params_from_jax(load_msgpack(str(path)))
    assert len([k for k in sd if k.startswith("prior.")]) == 2 * (2 + 2 * 4 + 1)
    model.load_state_dict(sd)
    assert "kept the prior's fresh initialization" in capsys.readouterr().err
    for k, v in fresh.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(model.state_dict()["hopfield.lookup_weights"], sd["hopfield.lookup_weights"])

    pixelcnn = HopVAE(load_config("ffhq_64_scaled"), impl="torch", device="cpu")
    pixelcnn.load_state_dict(params_from_jax(load_msgpack(str(CKPTS / "Transformer-FFHQ-64.msgpack"))))
    assert "kept the prior's fresh initialization" in capsys.readouterr().err
    cfg = load_config("pixelcnn_mnist_28")
    cfg.prior = "None"
    HopVAE(cfg, impl="torch", device="cpu").load_state_dict(sd)
    assert "dropped it" in capsys.readouterr().err

    anchor = HopVAE(load_config("pixelcnn_mnist_28"), impl="torch", device="cpu")
    anchor.load_state_dict(sd)
    assert capsys.readouterr().err == ""
    theirs = serialization.msgpack_restore(path.read_bytes())["prior"]
    np.testing.assert_array_equal(anchor.prior.res[3].conv_a.weight.detach().numpy(),
                                  theirs["res"]["3"]["conv_a"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(anchor.prior.conv_out2.bias.detach().numpy(), theirs["conv_out2"]["bias"])
    np.testing.assert_array_equal(anchor.prior.conv_in.mask.numpy(), theirs["conv_in"]["mask"].transpose(3, 2, 0, 1))
    tree = load_msgpack(str(path))
    tree["prior"]["res"]["1"]["conv_a"]["mask"][1, 1] = 1.0  # the center tap seeing later groups
    with pytest.raises(ValueError, match="prior/res/1/conv_a/mask"):
        params_from_jax(tree)


def test_lenient_load_of_a_wider_prior_matches_lenient_merge(capsys):
    """``Transformer-FFHQ-64.msgpack`` (a prior of d 128 in 4 heads) into
    ffhq_64_scaled with ``prior_d_model=256, prior_heads=1``, the recipe of
    the one-wide-head prior phase. JAX's ``load_params_lenient`` keeps a
    prior leaf where the checkpoint's has its shape and the fresh one
    elsewhere; the port's ``HopVAE.load_state_dict`` keeps the same leaves
    (the head's bias, of shape (512,), alone), leaves the rest of the prior
    fresh, loads the backbone whole, and warns of as many leaves as JAX."""
    import re

    import jax
    from hopvae_torch import HopVAE, load_config
    from hopvae_tpu.config import load_config as jax_load_config
    from hopvae_tpu.models.hopvae import HopVAE as JaxHopVAE
    from hopvae_tpu.utils.checkpoint import load_params_lenient

    path = CKPTS / "Transformer-FFHQ-64.msgpack"
    over = {"prior": "Transformer", "prior_d_model": 256, "prior_heads": 1}
    jcfg, tcfg = jax_load_config("ffhq_64_scaled"), load_config("ffhq_64_scaled")
    for k, v in over.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jm = JaxHopVAE(jcfg)
    merged = load_params_lenient(str(path), jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))))
    jax_dropped = int(re.search(r"(\d+) subtree\(s\)", capsys.readouterr().err).group(1))
    stored = params_from_jax(load_msgpack(str(path)))
    jax_prior = params_from_jax({"prior": jax.device_get(merged["prior"])})

    def from_checkpoint(sd):
        return {k for k, v in sd.items() if k.startswith("prior.") and k in stored
                and v.shape == stored[k].shape and torch.equal(v, stored[k])}

    model = HopVAE(tcfg, impl="torch", device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(stored)
    err = capsys.readouterr().err
    port_dropped = int(re.search(r"(\d+) prior tensor\(s\) kept the prior's fresh initialization", err).group(1))
    ours = model.state_dict()
    assert from_checkpoint(ours) == from_checkpoint(jax_prior) == {"prior.head.bias"}
    assert port_dropped == jax_dropped == len(fresh_prior := [k for k in fresh if k.startswith("prior.")]) - 1
    for k in fresh_prior:
        if k != "prior.head.bias":
            torch.testing.assert_close(ours[k], fresh[k], rtol=0, atol=0, msg=k)
    for k, v in ours.items():
        if not k.startswith("prior."):
            torch.testing.assert_close(v, stored[k], rtol=0, atol=0, msg=k)
