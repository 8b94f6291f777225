"""Weights and images made from the run's seed, on the run's device.

Both sides get the same tensors: the program loads the state dict, the
reference reads it. The parameter schema is written out here from the
configuration's sizes, under the names of the port's state dict (the
layout of its checkpoints), so a program whose parameters differ fails to
load it. Every value comes from two draws on a ``torch.Generator`` on the
device: one normal block for the pattern memories and one uniform block
for everything else, each leaf a slice of it scaled by its rule.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one of the run's streams (weights 0, images 1, draw noise 2 on)."""
    return torch.Generator(device=device).manual_seed((seed * 7919 + stream * 104729) & SEED_MASK)


def _conv(name: str, c_out: int, c_in: int, k: int, bias: bool = True, transpose: bool = False) -> list:
    """A conv's leaves, uniform in ±1/sqrt(fan_in) as torch's default init
    (fan_in from the weight's second dimension, as torch computes it)."""
    shape = (c_in, c_out, k, k) if transpose else (c_out, c_in, k, k)
    bound = 1.0 / math.sqrt(shape[1] * k * k)
    leaves = [(f"{name}.weight", shape, "uniform", bound, 0.0)]
    if bias:
        leaves.append((f"{name}.bias", (c_out,), "uniform", bound, 0.0))
    return leaves


def _residual_stack(name: str, h: int, hres: int, layers: int) -> list:
    out = []
    for i in range(layers):
        out += _conv(f"{name}.layers.{i}.conv_a", hres, h, 3, bias=False)
        out += _conv(f"{name}.layers.{i}.conv_b", h, hres, 1, bias=False)
    return out


def _lookup(name: str, d_in: int, d_out: int, m: int) -> list:
    out = [(f"{name}.lookup_weights", (m, d_in), "normal", 1.0, 0.0)]
    for proj, o in (("in_proj", d_in), ("out_proj", d_out)):
        out.append((f"{name}.{proj}.weight", (o, d_in), "uniform", math.sqrt(6.0 / (d_in + o)), 0.0))
        out.append((f"{name}.{proj}.bias", (o,), "uniform", 1.0 / math.sqrt(d_in), 0.0))
    for norm in ("norm_stored", "norm_state", "norm_proj"):
        out.append((f"{name}.{norm}.weight", (d_in,), "uniform", 0.1, 1.0))
        out.append((f"{name}.{norm}.bias", (d_in,), "uniform", 0.1, 0.0))
    return out


def schema(cfg) -> list[tuple[str, tuple, str, float, float]]:
    """``(name, shape, draw, scale, offset)`` of every parameter: the value
    is ``offset + scale · draw``, the draw normal or uniform in [-1, 1)."""
    h, hres, nres, c = cfg.num_hiddens, cfg.num_residual_hiddens, cfg.num_residual_layers, cfg.num_channels
    d, di, m = cfg.embedding_dim, cfg.index_dim, cfg.num_embeddings
    out = _conv("encoder.conv_1", h // 2, c, 4) + _conv("encoder.conv_2", h, h // 2, 4)
    out += _conv("encoder.conv_3", h, h, 4) + _conv("encoder.conv_4", h, h, 3)
    out += _residual_stack("encoder.residual_stack", h, hres, nres)
    out += _conv("pre_vq_conv", d, h, 1)
    out += _lookup("hopfield", d, d, m) + _lookup("embedding_to_index", d, di, m) + _lookup("index_to_embedding", di, d, m)
    out += _conv("post_vq_conv", di, di, 1)
    out += _conv("decoder.conv_1", h, d, 3) + _residual_stack("decoder.residual_stack", h, hres, nres)
    out += _conv("decoder.conv_trans_1", h // 2, h, 4, transpose=True)
    out += _conv("decoder.conv_trans_2", h // 2, h // 2, 4, transpose=True)
    out += _conv("decoder.conv_trans_3", c, h // 2, 4, transpose=True)
    if cfg.prior == "PixelCNN":
        f = int(getattr(cfg, "prior_num_filters", 96))
        out += _conv("prior.conv_in", f, di, 7)
        for b in range(int(getattr(cfg, "prior_num_res_blocks", 4))):
            out += _conv(f"prior.res.{b}.conv_a", f, f, 3) + _conv(f"prior.res.{b}.conv_b", f, f, 1)
        out += _conv("prior.conv_out1", f, f, 1) + _conv("prior.conv_out2", di * cfg.num_levels, f, 1)
    elif cfg.prior not in ("None", None):
        raise ValueError(f"the benchmark makes weights for the PixelCNN prior or none, not {cfg.prior!r}")
    return out


def state(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter, float32 on ``device``, from the run's seed."""
    leaves = schema(cfg)
    sizes = {kind: sum(math.prod(s) for _, s, k, _, _ in leaves if k == kind) for kind in ("normal", "uniform")}
    gen = generator(seed, device, 0)
    draws = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device).mul_(2.0).sub_(1.0)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale, offset in leaves:
        n = math.prod(shape)
        out[name] = draws[kind][at[kind] : at[kind] + n].reshape(shape) * scale + offset
        at[kind] += n
    return out


def images(cfg, n: int, seed: int, device, stream: int = 1) -> torch.Tensor:
    """``n`` normalized NHWC float32 images: seeded 8×8 colour fields
    upsampled bilinearly, with fine noise, in [0, 1], minus 0.5 (the FFHQ
    normalization)."""
    s, c = cfg.image_size, cfg.num_channels
    gen = generator(seed, device, stream)
    coarse = torch.rand(n, c, 8, 8, generator=gen, device=device)
    fine = torch.rand(n, c, s, s, generator=gen, device=device)
    x = F.interpolate(coarse, size=(s, s), mode="bilinear", align_corners=False)
    x = (0.85 * x + 0.15 * fine).clamp_(0.0, 1.0) - 0.5
    return x.permute(0, 2, 3, 1).contiguous()


def gumbel(shape: tuple, seed: int, device, stream: int) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform on ``[tiny,
    1)``, float32 on ``device``, from the run's seed."""
    u = torch.rand(shape, generator=generator(seed, device, stream), device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()
