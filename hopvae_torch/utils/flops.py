"""Analytic FLOPs model, MFU and the kernels' least times on an H100.

Port of ``hopvae_tpu/utils/flops.py``: every function of it, giving the
same integers for every config. Conventions, as there:

- one multiply-add = 2 FLOPs;
- conv FLOPs = 2 · H_out·W_out · C_in·C_out · kh·kw per image;
- a transposed conv counted input-based (each input pixel touches the
  full kernel): 2 · H_in·W_in · C_in·C_out · kh·kw;
- a training step ≈ 3× the forward (the forward, the input gradient and
  the weight gradient have the same contraction sizes);
- elementwise, LayerNorm and softmax work is ignored.

The peaks are the card's, not a TPU's: NVIDIA's data sheet for the H100
SXM ("NVIDIA H100 80GB HBM3, 700.00 W" as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives it; a card set
below 700 W runs slower under load). :func:`mfu` divides by the dense bf16
peak by default, as the JAX package divides production by its chip's
bf16 peak.

The bound helpers (:func:`roof`, :func:`bound`, :func:`bound_bwd`,
:func:`attention_bound`, :func:`fused_bound`) give the least time of one
launch of K1 to K5, the larger of its operations over the card's rate and
the f32 words it must move (each input read once, each output written
once) over the HBM rate; ``chip_smoke.py`` prints them as ``bound_ms``.
"""

from __future__ import annotations

# the card the peaks below are for (NVIDIA's data sheet, SXM part, dense)
PEAKS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores: K1 to K5 run their products in three TF32 passes
F32_FLOPS = 67e12  # f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
# exp runs on the special-function units at 16 results a clock an SM
# (CUDA C++ Programming Guide, compute capability 9.0); times the SMs and
# the SM clock, which ``chip_smoke.py`` reads from the card
SFU_PER_CLOCK_PER_SM = 16
# K1's token rows a block (TM in csrc/hopfield_stream_fwd.cuh): each
# block walks every pattern table once
K1_TOKEN_TILE = 64


def conv2d_flops(h_out: int, w_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * h_out * w_out * c_in * c_out * k * k


def encoder_flops(cfg) -> int:
    """4 convs (k4s2p1, k4s2p1, k4s1p2, k3s1p1) + residual stack; geometry
    H → H/2 → H/4 → H/4+1 → H/4+1."""
    h, c = cfg.num_hiddens, cfg.num_channels
    s0 = cfg.image_size
    s1, s2 = s0 // 2, s0 // 4
    r = s2 + 1
    total = conv2d_flops(s1, s1, c, h // 2, 4)
    total += conv2d_flops(s2, s2, h // 2, h, 4)
    total += conv2d_flops(r, r, h, h, 4)
    total += conv2d_flops(r, r, h, h, 3)
    total += residual_stack_flops(cfg, r)
    return total


def residual_stack_flops(cfg, r: int) -> int:
    res = cfg.num_residual_hiddens
    h = cfg.num_hiddens
    per_block = conv2d_flops(r, r, h, res, 3) + conv2d_flops(r, r, res, h, 1)
    return cfg.num_residual_layers * per_block


def decoder_flops(cfg) -> int:
    """3×3 conv + residual stack + 3 transposed convs."""
    h, c, d = cfg.num_hiddens, cfg.num_channels, cfg.embedding_dim
    r = cfg.representation_dim
    s2, s1 = cfg.image_size // 4, cfg.image_size // 2
    total = conv2d_flops(r, r, d, h, 3)
    total += residual_stack_flops(cfg, r)
    total += conv2d_flops(r, r, h, h // 2, 4)  # trans_1 (input-based), r→s2
    total += conv2d_flops(s2, s2, h // 2, h // 2, 4)  # trans_2, s2→s1
    total += conv2d_flops(s1, s1, h // 2, c, 4)  # trans_3, s1→image
    return total


def bottleneck_flops(cfg) -> int:
    """Triple Hopfield lookup: per lookup 2·r²·M·(d_in + d_out) attention
    matmuls, plus 2·d·M for the value-table fold, counted per image."""
    r2 = cfg.representation_dim**2
    m, d, di = cfg.num_embeddings, cfg.embedding_dim, cfg.index_dim
    attn = 2 * r2 * m * ((d + d) + (d + di) + (di + d))
    return attn + 2 * cfg.embedding_dim * m  # pre_vq handled in conv count


def pre_vq_flops(cfg) -> int:
    r = cfg.representation_dim
    return conv2d_flops(r, r, cfg.num_hiddens, cfg.embedding_dim, 1)


def forward_flops_per_image(cfg) -> int:
    return encoder_flops(cfg) + pre_vq_flops(cfg) + bottleneck_flops(cfg) + decoder_flops(cfg)


def train_flops_per_image(cfg) -> int:
    return 3 * forward_flops_per_image(cfg)


def mfu(flops_per_item: float, items_per_sec: float, peak: float = PEAK_BF16_FLOPS) -> float:
    return flops_per_item * items_per_sec / peak


def bottleneck_hbm_bytes_per_image(cfg, *, table_dtype_bytes: int = 4) -> int:
    """The streaming lookups' HBM traffic: the pattern tables (K and the
    folded U of each lookup) are read once for every tile of
    ``K1_TOKEN_TILE`` tokens; the token activations move once each way per
    lookup."""
    r2 = cfg.representation_dim**2
    m, d, di = cfg.num_embeddings, cfg.embedding_dim, cfg.index_dim
    widths = [(d, d), (d, di), (di, d)]
    table_bytes = sum(m * (i + o) * table_dtype_bytes for i, o in widths)
    token_bytes = sum((i + o) * 4 * r2 for i, o in widths)
    return table_bytes * r2 // K1_TOKEN_TILE + token_bytes


# ------------------------------------------------------- kernel bounds


def roof(flops: float, exps: float, floats: float, exp_per_s: float, flops_per_s: float = F32_FLOPS
         ) -> tuple[float, str]:
    """Least time (ms) of a kernel: its FLOPs at ``flops_per_s`` (the f32
    peak unless given) and its exps on the SFUs (they overlap) against the
    f32 words it must move at the HBM rate, each input read once and each
    output written once. Returns the ms and what bounds it, ``"operations"``
    or ``"bytes"``."""
    ops_s = max(flops / flops_per_s, exps / exp_per_s)
    bytes_s = 4 * floats / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def bound(n, m, d_in, d_out, exp_per_s, tensor_cores: bool = False) -> tuple[float, str]:
    """K1: reads x, K, U, s, t; writes out, m, l; the score and value
    products at the real widths. ``tensor_cores``: three times the FLOPs
    at the TF32 rate (the kernel's three passes) instead of the FLOPs at
    the f32 rate of the CUDA cores."""
    floats = n * d_in + m * (d_in + d_out) + 2 * d_in + n * d_out + 2 * n
    flops = 2 * n * m * (d_in + d_out)
    if tensor_cores:
        return roof(3 * flops, n * m, floats, exp_per_s, TF32_FLOPS)
    return roof(flops, n * m, floats, exp_per_s)


def bound_bwd(kernel: str, n, m, d_in, d_out, exp_per_s, tensor_cores: bool = False) -> tuple[float, str]:
    """K2 and K3 read x, K, U, s, t, g, m, l and delta. K2 does the score
    product, g·Uᵀ and dS·K and writes dx, ds, dt; K3 does the score
    product, g·Uᵀ, Aᵀg and dSᵀq and writes dK, dU. The FLOPs are those of
    the real widths. ``tensor_cores``: three times the FLOPs at the TF32
    rate (the kernels' three passes) instead of the FLOPs at the f32 rate
    of the CUDA cores."""
    reads = n * d_in + m * (d_in + d_out) + 2 * d_in + n * d_out + 3 * n
    if kernel == "dx":
        flops, words = 2 * n * m * (2 * d_in + d_out), reads + n * d_in + 2 * d_in
    else:
        flops, words = 2 * n * m * (2 * d_in + 2 * d_out), reads + m * (d_in + d_out)
    if tensor_cores:
        return roof(3 * flops, n * m, words, exp_per_s, TF32_FLOPS)
    return roof(flops, n * m, words, exp_per_s)


def attention_bound(kernel: str, b, s, h, dh, exp_per_s, tensor_cores: bool = False) -> tuple[float, str]:
    """Least time of one K5 launch. Each product over the causal triangle
    is 2·dh·S(S+1)/2 FLOPs per head; the forward needs 2 (QKᵀ, PV), dK/dV
    4 (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) and dQ 3 (QKᵀ, dO·Vᵀ, dS·K), each with
    one exp per score. Words: q, k, v (and dO, lse, delta) read once, the
    outputs (out and lse; dK and dV; dQ) written once. ``tensor_cores``:
    three times the FLOPs at the TF32 rate (the kernels' three passes)
    instead of the FLOPs at the f32 rate of the CUDA cores."""
    pairs = b * h * s * (s + 1) / 2
    products = {"fwd": 2, "dkv": 4, "dq": 3}[kernel]
    tensor = b * s * h * dh
    words = {"fwd": 4 * tensor + b * h * s, "dkv": 6 * tensor + 2 * b * h * s,
             "dq": 5 * tensor + 2 * b * h * s}[kernel]
    flops = products * 2 * dh * pairs
    if tensor_cores:
        return roof(3 * flops, pairs, words, exp_per_s, TF32_FLOPS)
    return roof(flops, pairs, words, exp_per_s)


def fused_bound(n: int, layers, exp_per_s, tensor_cores: bool = False) -> tuple[float, str]:
    """Least time of one K4 launch: each lookup's score and value products
    (2·N·M·(d_in + d_out) FLOPs, three times over at the TF32 rate with
    ``tensor_cores``, else once at the f32 rate) and N·M exps; reads x and
    the six tables, writes e, zq and r. ``layers``: the three lookups
    (``HopfieldLookup``), in the bottleneck's order."""
    flops = exps = floats = 0
    for layer in layers:
        m, d_in, d_out = layer.lookup_weights.shape[0], layer.d_in, layer.out_proj.weight.shape[0]
        flops += 2 * n * m * (d_in + d_out)
        exps += n * m
        floats += m * (d_in + d_out) + 2 * d_in + d_out
    d, di = layers[0].d_in, layers[1].out_proj.weight.shape[0]
    floats += n * (3 * d + di)
    if tensor_cores:
        return roof(3 * flops, exps, floats, exp_per_s, TF32_FLOPS)
    return roof(flops, exps, floats, exp_per_s)
