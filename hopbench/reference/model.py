"""The plain reference: HopVAE's math in float32 torch, written out anew.

It imports nothing of the program. It reads a state dict of float32
tensors under the port's checkpoint names (:mod:`hopbench.seeded` makes
it), NHWC images and level grids, and computes:

- ``forward``: encoder (k4s2p1, k4s2p1, k4s1p2, k3s1p1 convs, ReLU after
  the first three, a residual stack), the 1×1 pre-VQ conv, the three
  Hopfield lookups (``softmax(β·LN(x)·LN(P)ᵀ) · (LN(P)·W_inᵀ + b_in) ·
  W_outᵀ + b_out``, β = 1/√d_in), the sigmoid and the straight-through
  round to L levels, the round trip, and the decoder on the retrieval
  ``e``; it returns the reconstruction and the aux loss ``mean((r-e)²)``;
- ``pixelcnn_logits``: the masked-conv PixelCNN's teacher-forced logits;
- ``decode_grid``: a level grid through the index→embedding lookup and
  the decoder.

``mode="reference"`` computes every product in float32 with TF32 off.
``mode="stated"`` computes in the precisions the configuration states for
the program: the conv stacks' operands and outputs rounded to bfloat16,
everything else as the reference; its distance from the reference is the
rounding that those precisions bring, the yardstick the program's own
distance is read against. ``mode="control"`` is the same math one
precision step below what the configuration states: the conv stacks'
operands and outputs in fp8 (e4m3, one scale a tensor) for their
bfloat16, the lookups' and the prior's product operands in TF32 for their
float32 (TF32 rounding emulated, so the control reads alike on any
device).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
MODES = ("reference", "stated", "control")
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 inside the block; the flags restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _straight(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)
    return _straight(x, r)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16."""
    return _straight(x, x.detach().to(torch.bfloat16).to(torch.float32))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through fp8 e4m3 with one scale for the tensor."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    r = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return _straight(x, r)


def stated_mode(precision: dict) -> str:
    """The mode that computes in a configuration's stated ``precision``:
    ``"stated"`` for bfloat16 conv stacks, the reference where it states
    float32 throughout."""
    return "stated" if precision.get("conv_stacks") == "bfloat16" else "reference"


class Model:
    """The reference over one state dict ``params`` (float32 tensors by
    name) and a configuration ``cfg`` (its keys as attributes)."""

    def __init__(self, cfg, params: dict, mode: str = "reference"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.cfg, self.p, self.mode = cfg, params, mode
        self._masks = {}

    # ------------------------------------------------------------ pieces

    def _conv_round(self, x):
        return {"control": fp8, "stated": bf16}.get(self.mode, lambda t: t)(x)

    def _product_operand(self, x):
        return tf32(x) if self.mode == "control" else x

    def conv(self, name: str, x, *, stride=1, padding=0, transpose=False, bias=True):
        w = self._conv_round(self.p[f"{name}.weight"])
        b = self.p[f"{name}.bias"] if bias else None
        fn = F.conv_transpose2d if transpose else F.conv2d
        return self._conv_round(fn(self._conv_round(x), w, b, stride=stride, padding=padding))

    def residual_stack(self, name: str, x):
        for i in range(self.cfg.num_residual_layers):
            h = self.conv(f"{name}.layers.{i}.conv_a", F.relu(x), padding=1, bias=False)
            x = x + self.conv(f"{name}.layers.{i}.conv_b", F.relu(h), bias=False)
        return F.relu(x)

    def encode(self, x):
        """NHWC images → pre-VQ tokens ``(B, r², d)``."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv("encoder.conv_1", x, stride=2, padding=1))
        x = F.relu(self.conv("encoder.conv_2", x, stride=2, padding=1))
        x = F.relu(self.conv("encoder.conv_3", x, padding=2))
        x = self.conv("encoder.conv_4", x, padding=1)
        z = self.conv("pre_vq_conv", self.residual_stack("encoder.residual_stack", x))
        return z.permute(0, 2, 3, 1).reshape(z.shape[0], -1, self.cfg.embedding_dim)

    def decode(self, tokens):
        """Tokens ``(B, r², d)`` → NHWC images."""
        r = self.cfg.representation_dim
        x = tokens.reshape(tokens.shape[0], r, r, -1).permute(0, 3, 1, 2)
        x = self.residual_stack("decoder.residual_stack", self.conv("decoder.conv_1", x, padding=1))
        x = F.relu(self.conv("decoder.conv_trans_1", x, padding=2, transpose=True))
        x = F.relu(self.conv("decoder.conv_trans_2", x, stride=2, padding=1, transpose=True))
        return self.conv("decoder.conv_trans_3", x, stride=2, padding=1, transpose=True).permute(0, 2, 3, 1)

    def _norm(self, name: str, x):
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"], self.p[f"{name}.bias"], LN_EPS)

    def _linear(self, name: str, x):
        return self._product_operand(x) @ self._product_operand(self.p[f"{name}.weight"]).T + self.p[f"{name}.bias"]

    def lookup(self, name: str, x):
        """One Hopfield lookup of ``x (B, S, d_in)``."""
        patterns = self.p[f"{name}.lookup_weights"]
        k = self._norm(f"{name}.norm_stored", patterns)
        q = self._norm(f"{name}.norm_state", x)
        v = self._linear(f"{name}.in_proj", self._norm(f"{name}.norm_proj", patterns))
        scores = self._product_operand(q) @ self._product_operand(k).T / math.sqrt(patterns.shape[1])
        attn = torch.softmax(scores, dim=-1)
        return self._linear(f"{name}.out_proj", self._product_operand(attn) @ self._product_operand(v))

    # ------------------------------------------------------------ model

    def forward(self, x):
        """``(x_recon, aux)`` for NHWC images ``x``."""
        levels = self.cfg.num_levels - 1
        e = self.lookup("hopfield", self.encode(x))
        i = torch.sigmoid(self.lookup("embedding_to_index", e))
        zq = _straight(i * levels, torch.round(i * levels))
        r = self.lookup("index_to_embedding", zq / levels)
        return self.decode(e), torch.mean((r - e) ** 2)

    def decode_grid(self, grid):
        """A level grid ``(B, r, r, C)`` → NHWC images."""
        b, r = grid.shape[0], self.cfg.representation_dim
        tokens = (grid.float() / (self.cfg.num_levels - 1)).reshape(b, r * r, self.cfg.index_dim)
        return self.decode(self.lookup("index_to_embedding", tokens))

    # ---------------------------------------------------------- PixelCNN

    def _mask(self, k: int, c_in: int, c_out: int, kind: str, device):
        """Raster causality, and at the center tap channel-group causality:
        input group gi feeds output group go iff gi < go (A) or gi ≤ go (B)."""
        key = (k, c_in, c_out, kind)
        if key not in self._masks:
            groups = self.cfg.index_dim
            m = np.zeros((c_out, c_in, k, k), np.float32)
            m[:, :, : k // 2] = 1.0
            m[:, :, k // 2, : k // 2] = 1.0
            gi = np.arange(c_in) * groups // c_in
            go = np.arange(c_out) * groups // c_out
            center = gi[None, :] < go[:, None] if kind == "A" else gi[None, :] <= go[:, None]
            m[:, :, k // 2, k // 2] = center
            self._masks[key] = torch.from_numpy(m).to(device)
        return self._masks[key]

    def _masked(self, name: str, x, kind: str):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        w = w * self._mask(k, w.shape[1], w.shape[0], kind, w.device)
        if self.mode == "control":
            x, w = tf32(x), tf32(w)
        return F.conv2d(x, w, self.p[f"{name}.bias"], padding=k // 2)

    def pixelcnn_logits(self, grid):
        """Teacher-forced logits ``(B, r, r, C, L)`` of a level grid ``(B, r,
        r, C)``: a 7×7 mask-A conv, residual pairs of 3×3 and 1×1 mask-B
        convs, two 1×1 mask-B heads, on ``grid / (L-1) · 2 - 1``."""
        cfg = self.cfg
        b, r, lvl = grid.shape[0], cfg.representation_dim, cfg.num_levels
        x = (grid.float() / (lvl - 1) * 2.0 - 1.0).permute(0, 3, 1, 2)
        h = self._masked("prior.conv_in", x, "A")
        for i in range(int(getattr(cfg, "prior_num_res_blocks", 4))):
            a = self._masked(f"prior.res.{i}.conv_a", F.relu(h), "B")
            h = h + self._masked(f"prior.res.{i}.conv_b", F.relu(a), "B")
        h = self._masked("prior.conv_out1", F.relu(h), "B")
        logits = self._masked("prior.conv_out2", F.relu(h), "B")
        return logits.permute(0, 2, 3, 1).reshape(b, r, r, cfg.index_dim, lvl)
