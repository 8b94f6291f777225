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

Every conv asks cuDNN for a deterministic algorithm, in the forward and
in the backward, so one request gives the same reconstruction each time
and one training step the same gradients: the f32 transposed convs and
the weight gradients otherwise take algorithms whose sums change order
from run to run (on an H100, up to one bf16 step in the decoder's
output, at no gain in speed). Under autograd the conv runs inside
:class:`_Deterministic`, whose backward differentiates it under the same
flag; without a gradient it is called directly, with the same numbers.
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


class _Deterministic(torch.autograd.Function):
    """``compute(*args)`` with cuDNN's deterministic flag set in the
    forward and in the backward. The forward records the inner graph of
    ``compute``; the backward differentiates that graph under the flag."""

    @staticmethod
    def forward(ctx, compute, *args):
        with torch.enable_grad(), _deterministic():
            leaves = [None if a is None else a.detach().requires_grad_(a.requires_grad) for a in args]
            out = compute(*leaves)
        ctx.graph = (leaves, out)
        return out.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        leaves, out = ctx.graph
        del ctx.graph
        wanted = [a for a in leaves if a is not None and a.requires_grad]
        with _deterministic():
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, *(next(grads) if a is not None and a.requires_grad else None for a in leaves))


def _apply(fn, x, weight, bias, **kw) -> torch.Tensor:
    def compute(x, weight, bias):
        w = weight.to(x.dtype)
        if bias is None or x.dtype == torch.float32:
            return fn(x, w, None if bias is None else bias.to(x.dtype), **kw)
        # bf16 operands, f32 sums and bias, one rounding
        return fn(x.float(), w.float(), bias.to(x.dtype).float(), **kw).to(x.dtype)

    args = (x, weight, bias)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _Deterministic.apply(compute, *args)
    with _deterministic():
        return compute(*args)


def conv2d(x, weight, bias=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``nn.Conv2d(stride, padding)``; output ``floor((H+2p-k)/s)+1``."""
    return _apply(F.conv2d, x, weight, bias, stride=stride, padding=padding)


def conv_transpose2d(x, weight, bias=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d(stride, padding)``; output ``(H-1)s-2p+k``."""
    return _apply(F.conv_transpose2d, x, weight, bias, stride=stride, padding=padding)
