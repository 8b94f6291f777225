"""The benchmark's yardstick: FLOPs per image, peaks and the lookups' least times.

The FLOPs per image are a copy of the port's analytic model
(``hopvae_torch/utils/flops.py``: ``forward_flops_per_image`` and
``train_flops_per_image``), kept here so that a change to the program
cannot move the yardstick. Its conventions:

- one multiply-add = 2 FLOPs;
- conv FLOPs = 2 · H_out·W_out · C_in·C_out · kh·kw per image;
- a transposed conv counted input-based: 2 · H_in·W_in · C_in·C_out · kh·kw;
- a training step = 3× the forward;
- elementwise, LayerNorm and softmax work is ignored.

The least times count each Hopfield lookup's own operations once, whatever
implements them, against the dense bf16 peak (no implementation within the
outputs' limits computes faster), and each input byte read once and each
output byte written once, against the HBM rate. The least time is the
larger of the two, so a share of it cannot pass 100%.

``config`` is any object with the configuration's keys as attributes.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM, dense rates
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def conv2d_flops(h_out: int, w_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * h_out * w_out * c_in * c_out * k * k


def residual_stack_flops(cfg, r: int) -> int:
    h, res = cfg.num_hiddens, cfg.num_residual_hiddens
    return cfg.num_residual_layers * (conv2d_flops(r, r, h, res, 3) + conv2d_flops(r, r, res, h, 1))


def encoder_flops(cfg) -> int:
    """k4s2p1 → k4s2p1 → k4s1p2 → k3s1p1, then the residual stack."""
    h, c, s0 = cfg.num_hiddens, cfg.num_channels, cfg.image_size
    s1, s2 = s0 // 2, s0 // 4
    r = s2 + 1
    return (conv2d_flops(s1, s1, c, h // 2, 4) + conv2d_flops(s2, s2, h // 2, h, 4) + conv2d_flops(r, r, h, h, 4)
            + conv2d_flops(r, r, h, h, 3) + residual_stack_flops(cfg, r))


def decoder_flops(cfg) -> int:
    """3×3 conv, the residual stack, three transposed convs."""
    h, c, d, r = cfg.num_hiddens, cfg.num_channels, cfg.embedding_dim, cfg.representation_dim
    s2, s1 = cfg.image_size // 4, cfg.image_size // 2
    return (conv2d_flops(r, r, d, h, 3) + residual_stack_flops(cfg, r) + conv2d_flops(r, r, h, h // 2, 4)
            + conv2d_flops(s2, s2, h // 2, h // 2, 4) + conv2d_flops(s1, s1, h // 2, c, 4))


def bottleneck_flops(cfg) -> int:
    """Per lookup 2·r²·M·(d_in + d_out), plus 2·d·M for the value-table fold."""
    r2, m, d, di = cfg.representation_dim**2, cfg.num_embeddings, cfg.embedding_dim, cfg.index_dim
    return 2 * r2 * m * ((d + d) + (d + di) + (di + d)) + 2 * d * m


def pre_vq_flops(cfg) -> int:
    r = cfg.representation_dim
    return conv2d_flops(r, r, cfg.num_hiddens, cfg.embedding_dim, 1)


def conv_flops_per_image(cfg) -> int:
    return encoder_flops(cfg) + pre_vq_flops(cfg) + decoder_flops(cfg)


def forward_flops_per_image(cfg) -> int:
    return conv_flops_per_image(cfg) + bottleneck_flops(cfg)


def train_flops_per_image(cfg) -> int:
    return 3 * forward_flops_per_image(cfg)


# ------------------------------------------------------- the lookups' least times


def lookup_widths(cfg) -> list[tuple[int, int]]:
    """(d_in, d_out) of the bottleneck's three lookups, in order."""
    d, di = cfg.embedding_dim, cfg.index_dim
    return [(d, d), (d, di), (di, d)]


def lookup_work(kernel: str, n: int, m: int, d_in: int, d_out: int) -> tuple[float, float]:
    """``(flops, bytes)`` that one launch of ``kernel`` must do for N tokens
    over M patterns: K1 the forward, K2 the input gradient, K3 the table
    gradients. Reads: x, the keys K and the value table U, the state
    LayerNorm's scale and shift; the backward also the output gradient and
    the softmax row stats (m, l, delta). Writes: K1 the output and m, l; K2
    dx and the two LayerNorm gradients; K3 dK and dU."""
    forward_reads = n * d_in + m * (d_in + d_out) + 2 * d_in
    if kernel == "K1":
        flops = 2 * n * m * (d_in + d_out)
        words = forward_reads + n * d_out + 2 * n
    elif kernel == "K2":
        flops = 2 * n * m * (2 * d_in + d_out)
        words = forward_reads + n * d_out + 3 * n + n * d_in + 2 * d_in
    elif kernel == "K3":
        flops = 2 * n * m * (2 * d_in + 2 * d_out)
        words = forward_reads + n * d_out + 3 * n + m * (d_in + d_out)
    else:
        raise ValueError(f"kernel must be K1, K2 or K3, got {kernel!r}")
    return float(flops), float(F32_BYTES * words)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def lookups_least_seconds(cfg, batch: int, kernels=("K1",)) -> float:
    """The least seconds of the bottleneck's three lookups for one batch:
    each of ``kernels`` once a lookup (``("K1",)`` a forward,
    ``("K1", "K2", "K3")`` a training step)."""
    n, m = batch * cfg.representation_dim**2, cfg.num_embeddings
    return sum(least_seconds(*lookup_work(k, n, m, d_in, d_out))
               for d_in, d_out in lookup_widths(cfg) for k in kernels)
