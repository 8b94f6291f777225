"""Encoder/decoder conv stacks (port of ``hopvae_tpu/models/layers.py``).

- ``Residual``: ReLU → 3×3 conv (no bias) → ReLU → 1×1 conv (no bias),
  additive skip.
- ``ResidualStack``: N residual blocks, then a final ReLU.
- ``Encoder``: k4s2p1 → k4s2p1 → k4s1p2 → k3s1p1 convs, ReLU after the
  first three only, then the residual stack; spatial H → H/4 + 1.
- ``Decoder``: 3×3 conv → residual stack → transposed convs k4s1p2 →
  k4s2p1 → k4s2p1, ReLU after the first two only.

Activations are NCHW. The ``nn.Conv2d``/``nn.ConvTranspose2d`` children
only hold the parameters (torch's default init, as the JAX init copies);
``forward`` goes through :mod:`hopvae_torch.ops.conv`, which casts them to
the activation dtype.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.functional import relu

from hopvae_torch.ops.conv import conv2d, conv_transpose2d


class Residual(nn.Module):
    def __init__(self, in_ch, num_hiddens, num_residual_hiddens, device=None):
        super().__init__()
        self.conv_a = nn.Conv2d(in_ch, num_residual_hiddens, 3, bias=False, device=device)
        self.conv_b = nn.Conv2d(num_residual_hiddens, num_hiddens, 1, bias=False, device=device)

    def forward(self, x):
        h = conv2d(relu(x), self.conv_a.weight, padding=1)
        h = conv2d(relu(h), self.conv_b.weight)
        return x + h


class ResidualStack(nn.Module):
    def __init__(self, in_ch, num_hiddens, num_residual_layers, num_residual_hiddens, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Residual(in_ch, num_hiddens, num_residual_hiddens, device)
            for _ in range(num_residual_layers)
        )

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return relu(x)


def _conv(layer: nn.Module, x, **kw):
    return conv2d(x, layer.weight, layer.bias, **kw)


def _conv_t(layer: nn.Module, x, **kw):
    return conv_transpose2d(x, layer.weight, layer.bias, **kw)


class Encoder(nn.Module):
    def __init__(self, in_ch, num_hiddens, num_residual_layers, num_residual_hiddens, device=None):
        super().__init__()
        h = num_hiddens
        self.conv_1 = nn.Conv2d(in_ch, h // 2, 4, device=device)
        self.conv_2 = nn.Conv2d(h // 2, h, 4, device=device)
        self.conv_3 = nn.Conv2d(h, h, 4, device=device)
        self.conv_4 = nn.Conv2d(h, h, 3, device=device)
        self.residual_stack = ResidualStack(h, h, num_residual_layers, num_residual_hiddens, device)

    def forward(self, x):
        x = relu(_conv(self.conv_1, x, stride=2, padding=1))
        x = relu(_conv(self.conv_2, x, stride=2, padding=1))
        x = relu(_conv(self.conv_3, x, stride=1, padding=2))
        x = _conv(self.conv_4, x, stride=1, padding=1)
        return self.residual_stack(x)


class Decoder(nn.Module):
    def __init__(self, in_ch, out_ch, num_hiddens, num_residual_layers, num_residual_hiddens, device=None):
        super().__init__()
        h = num_hiddens
        self.conv_1 = nn.Conv2d(in_ch, h, 3, device=device)
        self.residual_stack = ResidualStack(h, h, num_residual_layers, num_residual_hiddens, device)
        self.conv_trans_1 = nn.ConvTranspose2d(h, h // 2, 4, device=device)
        self.conv_trans_2 = nn.ConvTranspose2d(h // 2, h // 2, 4, device=device)
        self.conv_trans_3 = nn.ConvTranspose2d(h // 2, out_ch, 4, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(self.conv_1, x, stride=1, padding=1)
        x = self.residual_stack(x)
        x = relu(_conv_t(self.conv_trans_1, x, stride=1, padding=2))
        x = relu(_conv_t(self.conv_trans_2, x, stride=2, padding=1))
        return _conv_t(self.conv_trans_3, x, stride=2, padding=1)
