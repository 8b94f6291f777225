"""Convert checkpoints between the PyTorch port and the JAX package.

Usage:
    python tools/torch_convert_checkpoint.py --config mnist_28 \
        --input outputs/mnist/MNIST-28.pt --output outputs/mnist_jax/MNIST-28.ckpt.msgpack
    python tools/torch_convert_checkpoint.py --config pixelcnn_mnist_28 \
        --input checkpoints/PixelCNN-MNIST-28.msgpack --output outputs/PixelCNN-MNIST-28.pt

The input is picked by its suffix and contents: a JAX ``.msgpack``, the
port trainer's ``.pt`` (a dict holding ``"model"``), or else the
reference's torch ``state_dict`` (``MNIST-28.ckpt``). Each loads into a
fresh model of ``--config`` (seeded with its seed, on the CPU): the
trainer's ``.pt`` strictly, the other two leniently, as
``load_reference_checkpoint`` loads them, with its warning for what did
not land. The output is picked by the suffix of ``--output``:

- ``.msgpack``: the JAX package's native parameters
  (``utils.checkpoint.params_to_jax``, written by ``save_msgpack``), which
  ``hopvae_tpu``'s strict ``load_params`` reads. From a trainer ``.pt``
  it also writes ``<DATA>-<size>.meta.json`` beside it, holding the
  ``.pt``'s epoch, so an output named ``<out>/<DATA>-<size>.ckpt.msgpack``
  lets ``python -m hopvae_tpu.train --resume --out <out>`` continue the
  run at the next epoch. The Adam moments and the learning-rate
  schedule's count are not converted: the JAX side starts them fresh, as
  it does after its own converter.
- ``.pt``: the port's model checkpoint, ``{"model": state_dict}``, which
  ``load_reference_checkpoint``, ``--checkpoint`` and the serving CLI
  read (strictly). It holds no optimizer, so it starts a run; it does not
  resume one.

It prints the count of tensors it wrote. It imports torch, never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from hopvae_torch.config import apply_overrides, load_config
from hopvae_torch.models.hopvae import HopVAE
from hopvae_torch.utils.checkpoint import (load_reference_checkpoint, load_torch_state_dict, params_to_jax,
                                           save_msgpack)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return 1


def load_model(config, path: str) -> tuple[HopVAE, int | None]:
    """``(model, epoch)``: a fresh CPU model of ``config`` with the
    checkpoint at ``path`` loaded; ``epoch`` is a trainer ``.pt``'s, else
    None."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    torch.manual_seed(config.seed)
    model = HopVAE(config, impl="torch", device="cpu")
    raw = None if path.endswith(".msgpack") else load_torch_state_dict(path)
    if raw is not None and "model" in raw:
        model.load_state_dict(raw["model"])
        return model, int(raw["epoch"]) if "epoch" in raw else None
    load_reference_checkpoint(model, path)
    return model, None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True, help="a JAX .msgpack, a trainer .pt or the reference's .ckpt")
    parser.add_argument("--output", required=True, help=".msgpack (JAX) or .pt (the port)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config key (repeatable), e.g. --set prior=Transformer")
    args = parser.parse_args(argv)
    if not args.output.endswith((".msgpack", ".pt")):
        parser.error(f"--output must end in .msgpack or .pt: {args.output}")

    config = load_config(args.config)
    try:
        apply_overrides(config, args.set, config_name=args.config)
    except ValueError as e:
        parser.error(str(e))
    model, epoch = load_model(config, args.input)
    state = model.state_dict()
    if args.output.endswith(".msgpack"):
        tree = params_to_jax(state, config)
        save_msgpack(args.output, tree)
        n = _count(tree)
        if epoch is not None:
            meta = os.path.join(os.path.dirname(os.path.abspath(args.output)),
                                f"{config.data_set}-{config.image_size}.meta.json")
            with open(meta, "w") as f:
                json.dump({"epoch": epoch}, f)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        torch.save({"model": state}, args.output)
        n = len(state)
    print(f"wrote {args.output}: {n} tensors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
