"""How the port's bf16 conv stacks round (PyTorch/CUDA port).

    python3 tools/torch_bf16_probe.py            # on a CUDA card, from the repo root

Prints JSON lines:

- ``conv``: for each biased conv of the trained MNIST backbone, fed the
  activations of the f32 model, the relative error against the exact
  result of the same bf16 operands, of the conv as ``hopvae_torch`` runs
  it (f32 sums and bias, one rounding) and of cuDNN's own bf16 conv with
  its bias (two roundings);
- ``golden``: the MNIST golden recon MSE shift (relative to 0.0073064) of
  the f32 and bf16 paths on the CPU and on the card, and of the card's
  bf16 path with cuDNN's two roundings per biased conv.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hopvae_torch import HopVAE, load_config  # noqa: E402
from hopvae_torch.data import GOLDENS, golden_input  # noqa: E402
from hopvae_torch.ops import conv as conv_mod  # noqa: E402
from hopvae_torch.serving import state_from_checkpoint  # noqa: E402

SPEC = GOLDENS["mnist_digits"]


def cudnn_rounding(fn, x, weight, bias, **kw):
    """The conv as cuDNN runs it in bf16: output rounded, then the bias sum."""
    return fn(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), **kw)


def conv_errors(model: HopVAE, x: torch.Tensor) -> None:
    """Feed each biased conv the f32 activations of the f32 model."""
    bf = torch.bfloat16
    taps = []
    orig = conv_mod._apply

    def tap(fn, inp, weight, bias, **kw):
        if bias is not None:
            taps.append((fn, inp, weight, bias, kw))
        return orig(fn, inp, weight, bias, **kw)

    conv_mod._apply = tap
    try:
        with torch.inference_mode():
            model(x)
    finally:
        conv_mod._apply = orig
    names = {id(p): n.rsplit(".", 1)[0] for n, p in model.named_parameters()}
    with torch.inference_mode():
        for fn, inp, weight, bias, kw in taps:
            xb, wb, bb = inp.to(bf), weight.to(bf), bias.to(bf)
            exact = fn(xb.double(), wb.double(), bb.double(), **kw)
            rel = lambda a: float((a.double() - exact).norm() / exact.norm())
            print(json.dumps({
                "conv": names[id(weight)],
                "one_rounding_rel_err": rel(orig(fn, xb, weight, bias, **kw)),
                "cudnn_rel_err": rel(cudnn_rounding(fn, xb, weight, bias, **kw)),
            }))


def shift(model: HopVAE, x: torch.Tensor) -> float:
    with torch.inference_mode():
        recon, _ = model(x)
    return float(((recon - x) ** 2).mean()) / SPEC["recon_mse"] - 1


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(SPEC["config"])
    state = state_from_checkpoint(str(ROOT / "checkpoints" / SPEC["checkpoint"]))
    x_np = golden_input("mnist_digits")

    def model(device, dtype):
        m = HopVAE(cfg, impl="cuda" if device == "cuda" else "torch", compute_dtype=dtype, device=device)
        m.load_state_dict(state)
        return m

    conv_errors(model("cuda", None), torch.from_numpy(x_np).cuda())
    out = {}
    for device in ("cpu", "cuda"):
        x = torch.from_numpy(x_np).to(device)
        out[f"{device}_f32"] = shift(model(device, None), x)
        out[f"{device}_bf16"] = shift(model(device, torch.bfloat16), x)
    orig = conv_mod._apply
    conv_mod._apply = cudnn_rounding
    try:
        out["cuda_bf16_cudnn_rounding"] = shift(model("cuda", torch.bfloat16), torch.from_numpy(x_np).cuda())
    finally:
        conv_mod._apply = orig
    print(json.dumps({"golden": out, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
