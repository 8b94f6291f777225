"""2-D convolutions in torch layouts (port of ``hopvae_tpu/ops/conv.py``).

Activations are NCHW here and weights keep torch's layouts: ``(O, I, kH,
kW)`` for a conv and ``(I, O, kH, kW)`` for a transposed conv. The JAX
package's HWIO and flipped-HWIO layouts are converted once, in
``hopvae_torch.utils.checkpoint.params_from_jax``.

Parameters are f32 masters; both functions cast them to the activation's
dtype, which is how the bf16 conv stacks run (``HopVAE._cast`` in JAX).

A conv with bf16 operands and a bias rounds to bf16 once: it sums the
products in f32, adds the bias in f32 and then rounds. cuDNN, through
``F.conv2d``, would round the conv's output and then the bias sum; that
second rounding moves the MNIST golden's recon MSE by +2.5% on an H100,
against +0.3% for one rounding (``tools/torch_bf16_probe.py``). The f32
conv of bf16 values runs on the tensor cores where TF32 is allowed
(cuDNN's default): TF32 holds every bf16 value exactly, so its products
are exact.

Every conv asks cuDNN for a deterministic algorithm, so one request
gives the same reconstruction each time: the f32 transposed convs
otherwise take one whose sums change order from run to run (on an H100,
up to one bf16 step in the decoder's output, at no gain in speed).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _apply(fn, x, weight, bias, **kw) -> torch.Tensor:
    w = weight.to(x.dtype)
    with _deterministic():
        if bias is None or x.dtype == torch.float32:
            return fn(x, w, None if bias is None else bias.to(x.dtype), **kw)
        # bf16 operands, f32 sums and bias, one rounding
        return fn(x.float(), w.float(), bias.to(x.dtype).float(), **kw).to(x.dtype)


def conv2d(x, weight, bias=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``nn.Conv2d(stride, padding)``; output ``floor((H+2p-k)/s)+1``."""
    return _apply(F.conv2d, x, weight, bias, stride=stride, padding=padding)


def conv_transpose2d(x, weight, bias=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d(stride, padding)``; output ``(H-1)s-2p+k``."""
    return _apply(F.conv_transpose2d, x, weight, bias, stride=stride, padding=padding)
