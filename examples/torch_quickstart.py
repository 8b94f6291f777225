"""Quickstart for the PyTorch/CUDA port: the library surface in one script.

Train a small Hop-VAE with a PixelCNN prior on hermetic rendered digits
(the backbone first, the prior phase in the last epoch), reconstruct 8
test images, draw 16 samples from the prior, and write the three image
grids: the port's counterpart of ``examples/quickstart.py``.

Run: ``python examples/torch_quickstart.py [--epochs N] [--out DIR]``
on an NVIDIA card, where the lookups run on the port's CUDA kernels
(``impl="cuda"``); ``--device cpu`` runs the eager lookups instead.
"""

from __future__ import annotations

import argparse
import os
import sys

# runnable straight from a checkout: running a script puts examples/ on
# sys.path, not the repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from hopvae_torch import HopVAE, Trainer, load_config
from hopvae_torch.data import get_datasets
from hopvae_torch.models.hopvae import resolve_device
from hopvae_torch.utils.metrics import denormalize, save_image_grid

GRIDS = ("quickstart_inputs.png", "quickstart_recons.png", "quickstart_samples.png")


def main(argv=None) -> dict:
    """Returns the run's numbers: ``recon_mse`` and ``aux`` of the 8 test
    images, the trainer's ``checkpoint`` and the ``grids`` written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default="outputs/torch_quickstart")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config("pixelcnn_mnist_28")  # MNIST geometry + PixelCNN prior
    cfg.prior_start = max(args.epochs - 2, 0)  # engage the prior phase at the end

    # the CUDA kernels on the card; the eager lookups on the CPU. Add
    # compute_dtype=torch.bfloat16 for the production path's bf16 conv stacks.
    device = resolve_device(args.device)
    torch.manual_seed(cfg.seed)
    model = HopVAE(cfg, impl="cuda" if device.type == "cuda" else "torch", device=device)

    # rendered-digit fallback data (pass --data to hopvae-torch-train for real MNIST)
    train_ds, _, test_ds = get_datasets(cfg, None)
    train_ds.images, train_ds.labels = train_ds.images[: args.n_train], train_ds.labels[: args.n_train]

    trainer = Trainer(model, cfg)
    trainer.fit(train_ds, test_ds, epochs=args.epochs, out_dir=args.out)

    # reconstruct a test batch and draw unconditional samples
    x = torch.from_numpy(test_ds.gather(np.arange(8))[0]).to(device)
    with torch.no_grad():
        x_recon, aux = model(x)
    samples = model.sample(16, generator=torch.Generator(device).manual_seed(0))

    os.makedirs(args.out, exist_ok=True)
    grids = [os.path.join(args.out, name) for name in GRIDS]
    for path, images in zip(grids, (x, x_recon, samples)):
        save_image_grid(path, denormalize(images.cpu().numpy(), cfg.data_set))
    recon_mse, aux = float(torch.mean((x_recon - x) ** 2)), float(aux)
    print(f"recon MSE: {recon_mse:.5f}  aux: {aux:.6f}")
    print(f"grids written to {args.out}/")
    return {"recon_mse": recon_mse, "aux": aux, "checkpoint": trainer.checkpoint_path(args.out), "grids": grids}


if __name__ == "__main__":
    main()
