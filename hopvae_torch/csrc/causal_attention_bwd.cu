// Causal flash attention, backward (K5-dkv and K5-dq), for Hopper (sm_90a).
//
// Replace the Mosaic TPU kernels `_flash_attention_dkv_kernel` and
// `_flash_attention_dq_kernel` (jax/experimental/pallas/ops/tpu/
// flash_attention.py) behind hopvae_tpu/ops/attention.py:
// flash_causal_attention. For one (batch, head), with the cotangent g of
// out, the forward's row log-sum-exp lse and delta = rowsum(g * out),
// both rebuild the probabilities tile by tile,
//
//     P  = exp(scale * q k^T - lse)            (0 where key > row)
//     dS = P * (g v^T - delta)
//
// and K5-dkv computes dV = P^T g and dK = scale * dS^T q, K5-dq computes
// dQ = scale * dS k.
//
// What bounds them on an H100: the tensor cores. K5-dkv does four products
// over the causal triangle (q k^T, g v^T, P^T g, dS^T q) and K5-dq three
// (q k^T, g v^T, dS k), 2 * D * S(S+1)/2 FLOPs each per head. Every one
// runs as mma.sync m16n8k8 on TF32 operands in three passes (mma_tf32.cuh),
// so the ceiling is 495 / 3 = 165 TFLOP/s f32-equivalent: at B = 256,
// S = 867, one head of D = 256, 1.20 and 0.90 ms, against about 0.2 ms of
// memory traffic each. One TF32 pass (11 bits of mantissa) would move dQ,
// dK and dV by about 1e-3 normwise, far past the 5e-5 the port holds them
// to; three passes keep about 21 bits, which with f32 sums lands where
// plain f32 does (tests/test_torch_attention_tf32.py emulates both). On
// the card the tensor cores' truncating sums add a little: 3e-6 normwise
// at S = 867 (see the design below). P is rebuilt from lse with scores from
// these products, not from the forward's FMA sums: the two differ by about
// 1e-7 relative, which moves P by about 1e-6.
// The split into two kernels recomputes the scores and g v^T in both; one
// fused kernel would need float atomics for dQ, and the backward must
// repeat bit for bit.
//
// Design (M: the block's resident rows, keys in K5-dkv and query rows in
// K5-dq; N: the rows it streams, query rows in K5-dkv and keys in K5-dq):
// - One block owns TM resident rows of one (batch, head) and walks the
//   streamed tiles of TN rows: K5-dkv from its diagonal to the end, K5-dq
//   up to its diagonal. Each output belongs to one block and is summed in
//   a fixed order: no float atomics. Blocks with the most tiles launch
//   first.
// - The resident tiles (k, v in K5-dkv; q, g in K5-dq) load once; each
//   streamed pair (q, g with lse and delta; k, v) arrives by cp.async into
//   one of two buffers while the other is multiplied. 16-byte copies where
//   an input's base and strides allow it, 4-byte ones where not; rows past
//   S are zero-filled and never written.
// - A warp owns a 16-row slab of the resident tile (the M of an m16
//   mma). With SPLIT warps a slab, each computes the slab's scores and
//   g v^T against the whole streamed tile over 1/SPLIT of the head width;
//   the partial sums meet in shared memory and are added in warp order,
//   each warp finishing 1/SPLIT of the score n-tiles (P, dS) and handing
//   them to the others. Each warp owns 1/SPLIT of the output columns, its
//   dK and dV (or dQ) in accumulator fragments.
// - The score fragments (C layout) become the A operand of the products
//   that sum over the streamed rows (dV, dK, dQ) without a transpose: the
//   k index of those products is permuted so that k = t is streamed row 2t
//   and k = t + 4 row 2t + 1, which makes C's (c0, c2, c1, c3) an A
//   fragment; the B operand is read from the same permuted rows. With
//   SPLIT = 1 they stay in registers; with SPLIT > 1 they go through
//   shared memory in fragment order (one float4 a lane), in f32.
// - dK, dV and dQ are summed over each streamed tile in fresh fragments
//   and added to the running sums after it: the tensor cores' sums
//   truncate, and chains of a few dozen mma keep that error near 3e-6
//   normwise at S = 867 (one chain over the whole walk gave 1.5e-5).
// - Shared memory holds f32 only, rows D + 4 floats apart: D + 4 is 4
//   times an odd number, so the fragment loads by row g (ldmatrix: eight
//   16-byte rows in eight bank groups) and those by permuted row 2t
//   (scalar, banks 8t + g or 8t + 4 + g) hit 32 banks; a tile read in
//   both roles (q and g in K5-dkv, k in K5-dq) needs no swizzle.
//
//   D       TM  TN  SPLIT  warps  shared bytes (dkv / dq)
//   8..64   64  32  1      4      1024 (D + 4) + 512 / 1024 (D + 4)
//   128     64  32  2      8      152,064 / 151,552
//   256     32  32  4      8      216,576 / 216,064
//   (At D = 256 a 16-row slab of dK and dV over the full width would take
//   128 accumulators a thread; four warps a slab keep 32 of each. 64-key
//   tiles with double-buffered q and g would not fit 227 KB.)
//
//   Registers and blocks an SM per width (no spills at any width) are in
//   PERF.md, from causal_attention_bwd_attributes on the card.
//
// Past 256 (any multiple of 128 up to 8192; the cluster kernels below,
// the width a runtime argument) the resident tiles no longer fit one block
// beside the streamed ones, and a warp's dK and dV over the full width
// would take too many registers. So the depth is split across the blocks
// of a thread-block cluster (Hopper's distributed shared memory), one
// level above SPLIT's split across the warps of a slab:
// - A cluster of R blocks on the grid's z axis shares one (batch, head)
//   and one resident tile; block rank r owns the depth slice [r SL,
//   r SL + SL) of all four inputs (the last slice may be 128 narrower per
//   missing chunk). Its resident slice (k, v or q, g) is staged once and
//   stays for the whole walk; each streamed tile's slice (q, g with lse and
//   delta, or k, v) arrives by cp.async into one of NB buffers (three where
//   they fit: the copies then start two tiles ahead).
// - Per streamed tile, each warp (a 16-row slab, a 64-column part of the
//   slice) computes its partial scores and g v^T over its 64 columns in
//   fresh fragments (chains of 8 steps, as the chunks of 64 the narrow
//   instances' warps run) and writes them to its own shared memory. After
//   a cluster barrier, n-tile j of a slab is finished by the warp of part
//   j / R in rank j % R: it reads every rank's partials of that n-tile
//   (mapa, ld.shared::cluster), sums each rank's parts in a fresh sum and
//   adds the ranks in rank order (the order is fixed: two launches give
//   equal bits), builds P and dS and leaves them in its shared memory in
//   A-fragment order (the reduce-scatter). After a second barrier every
//   warp reads the slab's P and dS from their finishers (the all-gather)
//   and runs the output products on its own 64 columns of the streamed
//   slice already in its shared memory. So q k^T and g v^T are computed
//   once per (resident tile, streamed tile) and no output window
//   recomputes them. A slab's causal skip is the same in every rank; a
//   warp that skips still meets both barriers, and every block ends with
//   a barrier, so none leaves while another may read its shared memory.
// - The two barriers a tile are split into arrive and wait, and the walk
//   runs one tile behind in the outputs: while barrier 0 of tile t is
//   pending, a warp runs tile t - 1's outputs; while barrier 1 is pending,
//   tile t + 1's partials. A warp reads tile t - 1's P and dS before it
//   arrives at tile t's barrier 0, after which their finishers rewrite
//   them; the partials of tile t + 1 wait in registers until barrier 1.
// - The operands split into big and small TF32 parts as mma_tf32.cuh
//   says, the small part truncated by the tensor cores instead of rounded
//   (split<true>): an error of the same order, two integer operations
//   fewer a value. K5-dkv runs its outputs in two groups of 32 columns and
//   its finishers read one rank at a time, to stay within 255 registers.
// - R = n / J rounded up for a head of n chunks of 128, J chunks a slice:
//
//   n        J  SL   TM  TN  R        NB (dkv / dq)  shared bytes (dkv / dq)
//   3..8     1  128  64  32  3..8     3 / 3          218,880 / 209,920
//   9..16    2  256  32  16  5..8     3 / 3          187,264 / 184,832
//   17..64   4  512  16  16  5..16    2 / 2          216,832 / 215,552
//
//   8 warps a block, one block an SM. Clusters past 8 blocks (n past 32)
//   are non-portable, opted in at the launch; past 64 chunks (8192) a
//   cluster would need more than 16 blocks, and the width is refused.
//   The plan, the cluster's helpers and its launch configuration are
//   cluster.cuh's (the head width's plan causal_attention_cluster.cuh's),
//   shared with the forward's cluster kernel (causal_attention_fwd.cu),
//   which sums q k^T in this order, and with the wide Hopfield backward
//   (hopfield_cluster.cuh).
//   The launch sets the cluster size at run time (cudaLaunchKernelEx);
//   causal_attention_bwd_cluster reports it, the slice width and whether
//   the card can hold such a cluster at once. A launch that fails returns
//   its error; nothing falls back.

#include <cstdint>

#include "causal_attention_cluster.cuh"

namespace {

using causal_attention::load_a;
using causal_attention::load_b_cols;
using causal_attention::load_b_rows2;
using causal_attention::out_offset;
using causal_attention::stage;
using causal_attention::Strides;
using causal_attention::vec16_ok;
using causal_attention::add4;
using causal_attention::cluster_arrive;
using causal_attention::cluster_attributes;
using causal_attention::cluster_config;
using causal_attention::cluster_rank;
using causal_attention::cluster_ranks;
using causal_attention::cluster_wait;
using causal_attention::ld_cluster;
using causal_attention::stage_slice;
using causal_attention::wide_plan;
using namespace tf32x3;

template <int D>
struct Tiles {
  static constexpr int TM = D > 128 ? 32 : 64;  // resident rows of a block
  static constexpr int TN = 32;                 // streamed rows of a tile
  static constexpr int NT = TN / 8;             // n-tiles of a 16 x TN score slab
  static constexpr int SPLIT = D > 128 ? 4 : D > 64 ? 2 : 1;  // warps of a 16-row slab
  static constexpr int WARPS = TM / 16 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RS = D + 4;              // row stride in shared memory
  static constexpr int KD = D / SPLIT;          // depth of a warp's part of the scores
  static constexpr int NTO = NT / SPLIT;        // score n-tiles a warp finishes
  static constexpr int CT = D / SPLIT / 8;      // output n-tiles of a warp
  static constexpr int XCH = TM / 16 * SPLIT * NT * 128;  // floats of one exchange
  static_assert(TM % TN == 0 && NT % SPLIT == 0 && CT >= 1 && KD % 8 == 0, "tiles");
};

// floats of shared memory: two resident tiles, two buffers of two streamed
// tiles, K5-dkv's two buffers of the streamed rows' lse and delta, and,
// when SPLIT > 1, the exchange of partial scores, reused for the hand-over
// of P and dS (K5-dkv) or dS (K5-dq)
template <int D, bool DKV>
constexpr size_t smem_bytes() {
  using C = Tiles<D>;
  const size_t stats = DKV ? 4 * C::TN : 0;
  const size_t exchange = C::SPLIT > 1 ? C::XCH : 0;
  static_assert(C::SPLIT == 1 || (DKV ? 2 : 1) * C::TM * C::TN <= C::XCH, "the hand-over fits the exchange");
  return sizeof(float) * (2 * C::TM * C::RS + 4 * C::TN * C::RS + stats + exchange);
}

// Sum the SPLIT warps' partial fragments of a slab's score n-tiles: each
// warp writes its NT partials, then adds up, in warp order, those of the
// NTO n-tiles it finishes. x: the slab's exchange, [warp][n-tile][lane].
template <int NT, int NTO, int SPLIT>
__device__ __forceinline__ void reduce_parts(float (&part)[NT][4], float (&sum)[NTO][4], float4* x, int w, int lane,
                                             int bar) {
#pragma unroll
  for (int j = 0; j < NT; ++j) x[(w * NT + j) * 32 + lane] = make_float4(part[j][0], part[j][1], part[j][2], part[j][3]);
  named_barrier(bar, 32 * SPLIT);
#pragma unroll
  for (int jj = 0; jj < NTO; ++jj) {
    float4 a = x[(w * NTO + jj) * 32 + lane];
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) {
      const float4 b = x[(p * NT + w * NTO + jj) * 32 + lane];
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    sum[jj][0] = a.x, sum[jj][1] = a.y, sum[jj][2] = a.z, sum[jj][3] = a.w;
  }
  named_barrier(bar, 32 * SPLIT);  // the exchange is free again
}

template <int D, bool DKV>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
causal_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ out_a, float* __restrict__ out_b, int s, int h, Strides qs, Strides ks,
                  Strides vs, Strides gs, float scale, unsigned vec16) {
  using C = Tiles<D>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, RS = C::RS, SPLIT = C::SPLIT, THREADS = C::THREADS;
  constexpr int NTO = C::NTO, CT = C::CT;
  extern __shared__ float4 smem4[];
  float* res0 = reinterpret_cast<float*>(smem4);  // k (dkv) or q (dq)
  float* res1 = res0 + TM * RS;                    // v (dkv) or g (dq)
  float* str = res1 + TM * RS;                     // buffer u: streamed tiles at str + u * 2 * TN * RS
  float* stat = str + 4 * TN * RS;                 // dkv, buffer u: lse, delta at stat + u * 2 * TN
  float4* xch = reinterpret_cast<float4*>(stat + (DKV ? 4 * TN : 0));  // exchange and hand-over

  // inputs by role: resident 0 and 1, streamed 0 and 1; vec16 has bits q, k, v, g
  const float* r0p = DKV ? k : q;
  const float* r1p = DKV ? v : g;
  const float* s0p = DKV ? q : k;
  const float* s1p = DKV ? g : v;
  const Strides r0s = DKV ? ks : qs, r1s = DKV ? vs : gs, s0s = DKV ? qs : ks, s1s = DKV ? gs : vs;
  const bool r0v = vec16 >> (DKV ? 1 : 0) & 1u, r1v = vec16 >> (DKV ? 2 : 3) & 1u;
  const bool s0v = vec16 >> (DKV ? 0 : 1) & 1u, s1v = vec16 >> (DKV ? 3 : 2) & 1u;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / SPLIT, part = warp % SPLIT;
  const int m0 = 16 * slab;  // the warp's resident rows in the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int mt = DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;  // the longest walks first
  const int row_m0 = mt * TM;
  const int first = DKV ? row_m0 / TN : 0;
  const int last = DKV ? (s - 1) / TN : (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;  // its first resident row (key or query row)
  float4* x = xch + slab * SPLIT * NT * 32;  // the slab's exchange
  const int bar = 1 + slab;                  // the slab's named barrier

  stage<D, TM, THREADS>(res0, r0p, r0s, b, hh, row_m0, s, r0v);
  stage<D, TM, THREADS>(res1, r1p, r1s, b, hh, row_m0, s, r1v);

  auto stage_stream = [&](int it, int u) {
    float* y = str + u * 2 * TN * RS;
    stage<D, TN, THREADS>(y, s0p, s0s, b, hh, it * TN, s, s0v);
    stage<D, TN, THREADS>(y + TN * RS, s1p, s1s, b, hh, it * TN, s, s1v);
    if constexpr (DKV) {
      float* st = stat + u * 2 * TN;
      for (int i = threadIdx.x; i < 2 * TN; i += THREADS) {
        const int r = it * TN + (i % TN);
        const bool in = r < s;
        const float* src = (i < TN ? lse : delta) + static_cast<size_t>(bh) * s;
        cp_async4(st + i, in ? src + r : src, in);
      }
    }
    cp_async_commit();
  };
  stage_stream(first, 0);

  // K5-dq: lse and delta of the warp's rows gq and gq + 8
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = slab_lo + gq + 8 * e;
      if (row < s) {
        lse_r[e] = lse[static_cast<size_t>(bh) * s + row];
        dl_r[e] = delta[static_cast<size_t>(bh) * s + row];
      }
    }
  }

  // accumulators: dK and dV (dkv) or dQ (dq, acc0 only), rows gq and gq + 8
  // of the slab, columns D / SPLIT * part + 8c + 2tq and + 1
  float acc0[CT][4], acc1[DKV ? CT : 1][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[c][e] = acc1[DKV ? c : 0][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_stream(it + 1, u ^ 1);
    const float* y0 = str + u * 2 * TN * RS;  // q (dkv) or k (dq)
    const float* y1 = y0 + TN * RS;           // g (dkv) or v (dq)
    const float* st = stat + u * 2 * TN;
    const int n_lo = it * TN;  // the tile's first streamed row

    // a slab whose keys all exceed its rows (or whose rows are all past S)
    // in this tile has P = dS = 0: its warps skip the tile together
    if (DKV ? (slab_lo > n_lo + TN - 1 || n_lo >= s) : (n_lo > slab_lo + 15 || slab_lo >= s)) continue;

    // ---- the warp's part (columns KD * part ..) of the slab's 16 x TN
    // scores and g v^T, C layout
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kk = C::KD * part; kk < C::KD * (part + 1); kk += 8) {
      const FragA xa = load_a<RS>(res0 + m0 * RS + kk, gq, tq);
      const FragA wa = load_a<RS>(res1 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB y0b, y1b, z0b, z1b;
        load_b_rows2<RS>(y0b, y1b, y0 + 8 * j * RS + kk, gq, tq);
        load_b_rows2<RS>(z0b, z1b, y1 + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], xa, y0b);
        mma3(dp[j], wa, z0b);
        mma3(sc[j + 1], xa, y1b);
        mma3(dp[j + 1], wa, z1b);
      }
    }

    // ---- the full sums of the n-tiles the warp finishes: j = NTO * part + jj
    float fs[NTO][4], fd[NTO][4];
    if constexpr (SPLIT > 1) {
      reduce_parts<NT, NTO, SPLIT>(sc, fs, x, part, lane, bar);
      reduce_parts<NT, NTO, SPLIT>(dp, fd, x, part, lane, bar);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fs[j][e] = sc[j][e], fd[j][e] = dp[j][e];
    }

    // ---- P and dS, in place
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = slab_lo + gq + 8 * (e >> 1);                       // resident row
        const int n = n_lo + 8 * (NTO * part + jj) + 2 * tq + (e & 1);  // streamed row
        const int key = DKV ? m : n, row = DKV ? n : m;
        const float l = DKV ? st[n - n_lo] : lse_r[e >> 1];
        const float dl = DKV ? st[TN + n - n_lo] : dl_r[e >> 1];
        const float p = key <= row && row < s ? __expf(fs[jj][e] * scale - l) : 0.f;
        fs[jj][e] = p;
        fd[jj][e] = p * (fd[jj][e] - dl);
      }

    // ---- hand them to the slab's other warps (SPLIT > 1), in A-fragment
    // order: x[n-tile][lane] holds dS, and in K5-dkv x[NT + n-tile][lane] P
    if constexpr (SPLIT > 1) {
#pragma unroll
      for (int jj = 0; jj < NTO; ++jj) {
        const int j = NTO * part + jj;
        x[j * 32 + lane] = make_float4(fd[jj][0], fd[jj][2], fd[jj][1], fd[jj][3]);
        if constexpr (DKV) x[(NT + j) * 32 + lane] = make_float4(fs[jj][0], fs[jj][2], fs[jj][1], fs[jj][3]);
      }
      named_barrier(bar, 32 * SPLIT);
    }

    // ---- dV += P^T g and dK += dS^T q (dkv), dQ += dS k (dq), over the
    // tile's streamed rows 8j .. 8j + 7 in order, into the tile's partial
    // sums o0, o1, added to acc0, acc1 after the tile (the tensor cores'
    // sums truncate, and short chains keep that error 4x smaller at S = 867)
    float o0[CT][4], o1[DKV ? CT : 1][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o0[c][e] = o1[DKV ? c : 0][e] = 0.f;
    const int dc0 = D / SPLIT * part;  // the warp's output columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      // rows j with no key <= row, or past S, hold zeros only
      if (DKV ? (n8 + 7 < slab_lo || n8 >= s) : (n8 > slab_lo + 15 || n8 >= s)) continue;
      float pa[4], da[4];
      if constexpr (SPLIT == 1) {
        pa[0] = fs[j][0], pa[1] = fs[j][2], pa[2] = fs[j][1], pa[3] = fs[j][3];
        da[0] = fd[j][0], da[1] = fd[j][2], da[2] = fd[j][1], da[3] = fd[j][3];
      } else {
        const float4 d4 = x[j * 32 + lane];
        da[0] = d4.x, da[1] = d4.y, da[2] = d4.z, da[3] = d4.w;
        if constexpr (DKV) {
          const float4 p4 = x[(NT + j) * 32 + lane];
          pa[0] = p4.x, pa[1] = p4.y, pa[2] = p4.z, pa[3] = p4.w;
        }
      }
      const FragA dsa = split_a(da[0], da[1], da[2], da[3]);
      if constexpr (DKV) {
        const FragA pfa = split_a(pa[0], pa[1], pa[2], pa[3]);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = dc0 + 8 * c;
          mma3(o1[c], pfa, load_b_cols<RS>(y1 + 8 * j * RS + col, gq, tq));  // dV, g
          mma3(o0[c], dsa, load_b_cols<RS>(y0 + 8 * j * RS + col, gq, tq));  // dK, q
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          mma3(o0[c], dsa, load_b_cols<RS>(y0 + 8 * j * RS + dc0 + 8 * c, gq, tq));  // dQ, k
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[c][e] += o0[c][e];
        if constexpr (DKV) acc1[c][e] += o1[c][e];
      }
  }

  // ---- write dK, dV (dkv) or dQ (dq): rows of the slab < S
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = out_offset<D>(b, row, hh, s, h) + D / SPLIT * part + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      *reinterpret_cast<float2*>(out_a + at + 8 * c) =
          make_float2(acc0[c][2 * e] * scale, acc0[c][2 * e + 1] * scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out_b + at + 8 * c) = make_float2(acc1[c][2 * e], acc1[c][2 * e + 1]);
    }
  }
}

template <int D, bool DKV>
int launch(const float* q, const float* k, const float* v, const float* g, const float* lse,
           const float* delta, float* out_a, float* out_b, int b, int s, int h, Strides qs, Strides ks,
           Strides vs, Strides gs, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  const int m_tiles = (s + C::TM - 1) / C::TM;
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL || m_tiles > 65535)
    return cudaErrorInvalidValue;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2 | vec16_ok(g, gs) << 3;
  auto kernel = causal_bwd_kernel<D, DKV>;
  constexpr size_t bytes = smem_bytes<D, DKV>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * h, m_tiles), C::THREADS, bytes, stream>>>(q, k, v, g, lse, delta, out_a, out_b, s, h, qs, ks,
                                                              vs, gs, scale, vec16);
  return cudaGetLastError();
}


// ---- head widths past 256: the cluster kernels (see the header), one
// instance for each slice of at most J chunks of 128 (the width d is a
// runtime argument)
namespace wide {
using namespace causal_attention::wide;
// float4s of the partials: [slab][part][scores, g v^T][n-tile][lane]
template <int J>
constexpr int XCH = Cfg<J>::SLABS * Cfg<J>::WS * 2 * Cfg<J>::NT * 32;
// shared bytes with NB buffers of the streamed slices: the resident
// slices, the streamed ones (with K5-dkv's lse and delta), the partials,
// the hand-over of dS (and P)
template <int J, bool DKV>
__host__ __device__ constexpr size_t bytes_with(int nb) {
  using C = Cfg<J>;
  return sizeof(float) * (2 * C::TM * C::RS + nb * (2 * C::TN * C::RS + (DKV ? 2 * C::TN : 0))) +
         sizeof(float4) * (XCH<J> + C::SLABS * (DKV ? 2 : 1) * C::NT * 32);
}
// streamed buffers: three where they fit (a tile's copies then start two
// tiles ahead), else two
template <int J, bool DKV>
__host__ __device__ constexpr int buffers() { return bytes_with<J, DKV>(3) <= 232448 ? 3 : 2; }
template <int J, bool DKV>
__host__ __device__ constexpr size_t bytes() { return bytes_with<J, DKV>(buffers<J, DKV>()); }
}  // namespace wide

template <int J, bool DKV>
__global__ void __launch_bounds__(wide::THREADS, 1)
causal_bwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ g, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ out_a, float* __restrict__ out_b, int s,
                          int h, int d, Strides qs, Strides ks, Strides vs, Strides gs, float scale, unsigned vec16) {
  using namespace wide;
  using C = Cfg<J>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, WS = C::WS, SL = C::SL, RS = C::RS;
  constexpr int PART = C::PART;
  constexpr int NB = buffers<J, DKV>();  // streamed buffers
  constexpr int CT = PART / 8;           // a warp's output n-tiles
  constexpr int HO = DKV ? 2 : 1;        // hand-over arrays: dS (and P)
  constexpr int BUF = 2 * TN * RS + (DKV ? 2 * TN : 0);  // floats of a streamed buffer
  extern __shared__ float4 smem4[];
  float* res0 = reinterpret_cast<float*>(smem4);  // k (dkv) or q (dq): the resident slice
  float* res1 = res0 + TM * RS;                    // v (dkv) or g (dq)
  float* str = res1 + TM * RS;                     // buffer u at str + u * BUF: the streamed slices, lse, delta
  float4* xch = reinterpret_cast<float4*>(str + NB * BUF);  // [slab][part][sc, dp][n-tile][lane]
  float4* hand = xch + XCH<J>;                              // [slab][dS, P][n-tile][lane]

  // inputs by role, as in causal_bwd_kernel
  const float* r0p = DKV ? k : q;
  const float* r1p = DKV ? v : g;
  const float* s0p = DKV ? q : k;
  const float* s1p = DKV ? g : v;
  const Strides r0s = DKV ? ks : qs, r1s = DKV ? vs : gs, s0s = DKV ? qs : ks, s1s = DKV ? gs : vs;
  const bool r0v = vec16 >> (DKV ? 1 : 0) & 1u, r1v = vec16 >> (DKV ? 2 : 3) & 1u;
  const bool s0v = vec16 >> (DKV ? 0 : 1) & 1u, s1v = vec16 >> (DKV ? 3 : 2) & 1u;

  const int rank = cluster_rank(), ranks = cluster_ranks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / WS, part = warp % WS;
  const int m0 = 16 * slab;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int mt = DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;  // the longest walks first
  const int row_m0 = mt * TM;
  const int first = DKV ? row_m0 / TN : 0;
  const int last = DKV ? (s - 1) / TN : (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;
  const int c0 = rank * SL;                  // the block's slice: columns c0 .. c0 + cols
  const int cols = min(SL, d - c0);          // a multiple of 128
  const int pc = PART * part;                // the warp's part of it
  const bool mine = pc < cols;
  const int fin = part * ranks + rank;       // the warp finishes n-tile `fin` of its slab if fin < NT

  // tile `it` into buffer it % NB (nothing past the last); one commit group either way
  auto stage_stream = [&](int it) {
    if (it <= last) {
      float* y = str + (it % NB) * BUF;
      stage_slice<RS, TN>(y, s0p + c0, s0s, b, hh, it * TN, s, s0v, cols);
      stage_slice<RS, TN>(y + TN * RS, s1p + c0, s1s, b, hh, it * TN, s, s1v, cols);
      if constexpr (DKV) {
        float* st = y + 2 * TN * RS;
        for (int i = threadIdx.x; i < 2 * TN; i += THREADS) {
          const int r = it * TN + (i % TN);
          const bool in = r < s;
          const float* src = (i < TN ? lse : delta) + static_cast<size_t>(bh) * s;
          cp_async4(st + i, in ? src + r : src, in);
        }
      }
    }
    cp_async_commit();
  };
  // a slab with no key <= row in tile it, or no row < S, skips it in every
  // block of the cluster alike; its warps still meet every barrier
  auto live = [&](int it) {
    const int n_lo = it * TN;
    return DKV ? !(slab_lo > n_lo + TN - 1 || n_lo >= s) : !(n_lo > slab_lo + 15 || slab_lo >= s);
  };

  stage_slice<RS, TM>(res0, r0p + c0, r0s, b, hh, row_m0, s, r0v, cols);
  stage_slice<RS, TM>(res1, r1p + c0, r1s, b, hh, row_m0, s, r1v, cols);
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_stream(first + i);  // the resident slices go with the first

  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = slab_lo + gq + 8 * e;
      if (row < s) {
        lse_r[e] = lse[static_cast<size_t>(bh) * s + row];
        dl_r[e] = delta[static_cast<size_t>(bh) * s + row];
      }
    }
  }

  float acc0[CT][4], acc1[DKV ? CT : 1][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[c][e] = acc1[DKV ? c : 0][e] = 0.f;
  float4* xw = xch + (slab * WS + part) * 2 * NT * 32 + lane;  // the warp's partials
  const float4* xs = xch + slab * WS * 2 * NT * 32 + lane;     // the slab's, part 0

  // ---- the warp's partial scores and g v^T of tile it over its PART
  // columns, in fresh fragments
  float sc[NT][4], dp[NT][4];
  auto partials = [&](int it) {
    const float* y0 = str + (it % NB) * BUF;
    const float* y1 = y0 + TN * RS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    if (!(live(it) && mine)) return;
#pragma unroll 2
    for (int kk = pc; kk < pc + PART; kk += 8) {
      const FragA xa = load_a<RS, true>(res0 + m0 * RS + kk, gq, tq);
      const FragA wa = load_a<RS, true>(res1 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB y0b, y1b, z0b, z1b;
        load_b_rows2<RS, true>(y0b, y1b, y0 + 8 * j * RS + kk, gq, tq);
        load_b_rows2<RS, true>(z0b, z1b, y1 + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], xa, y0b);
        mma3(dp[j], wa, z0b);
        mma3(sc[j + 1], xa, y1b);
        mma3(dp[j + 1], wa, z1b);
      }
    }
  };

  // ---- reduce-scatter of tile it: n-tile j = fin of the slab, summed over
  // each rank's parts in a fresh sum, the ranks added in rank order; then P
  // and dS, handed over in A-fragment order
  auto finish = [&](int it) {
    if (!(live(it) && fin < NT)) return;
    const int j = fin;
    const int n_lo = it * TN;
    const float* st = str + (it % NB) * BUF + 2 * TN * RS;
    constexpr int RG = DKV ? 1 : 8 / WS;  // ranks whose partials are loaded at once (K5-dkv: registers)
    float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), td = ts;
    for (int r0 = 0; r0 < ranks; r0 += RG) {
      float4 ps[RG][WS], pd[RG][WS];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int p = 0; p < WS; ++p)
          if (r0 + rr < ranks && PART * p < min(SL, d - (r0 + rr) * SL)) {
            ps[rr][p] = ld_cluster(xs + (2 * p * NT + j) * 32, r0 + rr);
            pd[rr][p] = ld_cluster(xs + ((2 * p + 1) * NT + j) * 32, r0 + rr);
          }
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int r = r0 + rr, parts = r < ranks ? min(SL, d - r * SL) / PART : 0;
#pragma unroll
        for (int p = 1; p < WS; ++p)
          if (p < parts) add4(ps[rr][0], ps[rr][p]), add4(pd[rr][0], pd[rr][p]);
        if (r == 0) {
          ts = ps[rr][0], td = pd[rr][0];
        } else if (r < ranks) {
          add4(ts, ps[rr][0]), add4(td, pd[rr][0]);
        }
      }
    }
    float fs[4] = {ts.x, ts.y, ts.z, ts.w}, fd[4] = {td.x, td.y, td.z, td.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = slab_lo + gq + 8 * (e >> 1);
      const int n = n_lo + 8 * j + 2 * tq + (e & 1);
      const int key = DKV ? m : n, row = DKV ? n : m;
      const float l = DKV ? st[n - n_lo] : lse_r[e >> 1];
      const float dl = DKV ? st[TN + n - n_lo] : dl_r[e >> 1];
      const float p = key <= row && row < s ? __expf(fs[e] * scale - l) : 0.f;
      fs[e] = p;
      fd[e] = p * (fd[e] - dl);
    }
    float4* hw = hand + slab * HO * NT * 32 + lane;
    hw[j * 32] = make_float4(fd[0], fd[2], fd[1], fd[3]);
    if constexpr (DKV) hw[(NT + j) * 32] = make_float4(fs[0], fs[2], fs[1], fs[3]);
  };

  // ---- all-gather of tile it: the slab's dS (and P) from their finishers
  float4 dsj[NT], pj[DKV ? NT : 1];
  auto gather = [&](int it) {
    if (!(live(it) && mine)) return;
    const float4* hr = hand + slab * HO * NT * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      dsj[j] = ld_cluster(hr + j * 32, j % ranks);
      if constexpr (DKV) pj[j] = ld_cluster(hr + (NT + j) * 32, j % ranks);
    }
  };

  // ---- the outputs of tile it over the warp's PART columns: dV += P^T g
  // and dK += dS^T q (dkv), dQ += dS k (dq), over the tile's streamed rows
  // 8j .. 8j + 7 in order, in fresh fragments added to the running sums
  // after the tile
  auto outputs = [&](int it) {
    if (!(live(it) && mine)) return;
    const int n_lo = it * TN;
    const float* y0 = str + (it % NB) * BUF;
    const float* y1 = y0 + TN * RS;
    // K5-dkv in two groups of columns, each with its fresh fragments (the
    // sums per column are the same; fewer registers are live)
    constexpr int CH = DKV ? 2 : 1, CG = CT / CH;
#pragma unroll
    for (int hf = 0; hf < CH; ++hf) {
      float o0[CG][4], o1[DKV ? CG : 1][4];
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o0[c][e] = o1[DKV ? c : 0][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n8 = n_lo + 8 * j;
        if (DKV ? (n8 + 7 < slab_lo || n8 >= s) : (n8 > slab_lo + 15 || n8 >= s)) continue;
        const FragA dsa = split_a<true>(dsj[j].x, dsj[j].y, dsj[j].z, dsj[j].w);
        if constexpr (DKV) {
          const FragA pfa = split_a<true>(pj[j].x, pj[j].y, pj[j].z, pj[j].w);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const int col = pc + 8 * (hf * CG + c);
            mma3(o1[c], pfa, load_b_cols<RS, true>(y1 + 8 * j * RS + col, gq, tq));  // dV, g
            mma3(o0[c], dsa, load_b_cols<RS, true>(y0 + 8 * j * RS + col, gq, tq));  // dK, q
          }
        } else {
#pragma unroll
          for (int c = 0; c < CG; ++c)
            mma3(o0[c], dsa, load_b_cols<RS, true>(y0 + 8 * j * RS + pc + 8 * c, gq, tq));  // dQ, k
        }
      }
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc0[hf * CG + c][e] += o0[c][e];
          if constexpr (DKV) acc1[hf * CG + c][e] += o1[c][e];
        }
    }
  };

  // ---- the walk, one tile behind in the outputs: while a cluster barrier
  // is pending, the warps run the previous tile's outputs (barrier 0) or the
  // next tile's partials (barrier 1). A warp reads tile it - 1's hand-over
  // before it arrives at tile it's barrier 0, after which it is rewritten.
  if constexpr (NB == 3) cp_async_wait_prior();
  else cp_async_wait_all();
  __syncthreads();  // the resident slices and tile `first` have landed
  partials(first);
  for (int it = first; it <= last; ++it) {
    if (live(it) && mine) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        xw[j * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
        xw[(NT + j) * 32] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
      }
    }
    if (it > first) gather(it - 1);
    cluster_arrive();  // barrier 0: tile it's partials are in place; tile it - 1's P and dS are read
    if (it > first) outputs(it - 1);
    if constexpr (NB == 3) cp_async_wait_all();  // tile it + 1, staged a tile ago
    __syncthreads();  // every warp is done with tile it - 1's buffer (NB 3: tile it + 1 has landed)
    stage_stream(it - 1 + NB);
    cluster_wait();
    finish(it);
    cluster_arrive();  // barrier 1: tile it's P and dS are in place; tile it's partials are read
    if (it < last) {
      if constexpr (NB == 2) {
        cp_async_wait_all();
        __syncthreads();  // tile it + 1 has landed
      }
      partials(it + 1);
    }
    cluster_wait();
  }
  gather(last);
  outputs(last);
  cluster_arrive();  // no block leaves while another may still read its shared memory
  cluster_wait();

  if (!mine) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * d + static_cast<size_t>(hh) * d +
                      c0 + pc + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      *reinterpret_cast<float2*>(out_a + at + 8 * c) =
          make_float2(acc0[c][2 * e] * scale, acc0[c][2 * e + 1] * scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out_b + at + 8 * c) = make_float2(acc1[c][2 * e], acc1[c][2 * e + 1]);
    }
  }
}

template <int J, bool DKV>
int launch_cluster(const float* q, const float* k, const float* v, const float* g, const float* lse,
                   const float* delta, float* out_a, float* out_b, int b, int s, int h, int d, int ranks, Strides qs,
                   Strides ks, Strides vs, Strides gs, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  dim3 grid;
  cudaError_t err = causal_attention::attention_grid(b, s, h, wide::Cfg<J>::TM, ranks, grid);
  if (err == cudaSuccess)
    err = cluster_config(causal_bwd_cluster_kernel<J, DKV>, wide::bytes<J, DKV>(), grid, config, attr, stream);
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2 | vec16_ok(g, gs) << 3;
  return cudaLaunchKernelEx(&config, causal_bwd_cluster_kernel<J, DKV>, q, k, v, g, lse, delta, out_a, out_b, s, h,
                            d, qs, ks, vs, gs, scale, vec16);
}

template <bool DKV>
int launch_wide(const float* q, const float* k, const float* v, const float* g, const float* lse,
                const float* delta, float* out_a, float* out_b, int b, int s, int h, int d, Strides qs, Strides ks,
                Strides vs, Strides gs, float scale, cudaStream_t stream) {
  int j, ranks;
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL || !wide_plan(d, j, ranks))
    return cudaErrorInvalidValue;
  switch (j) {
    case 1: return launch_cluster<1, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, d, ranks, qs, ks, vs, gs, scale, stream);
    case 2: return launch_cluster<2, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, d, ranks, qs, ks, vs, gs, scale, stream);
    default: return launch_cluster<4, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, d, ranks, qs, ks, vs, gs, scale, stream);
  }
}

// The cluster kernel's build at width d (see cluster_attributes).
template <int J, bool DKV>
int wide_cluster(int ranks, int* out) {
  return cluster_attributes(causal_bwd_cluster_kernel<J, DKV>, wide::bytes<J, DKV>(), wide::Cfg<J>::SL, ranks, out);
}

template <int J, bool DKV>
int wide_attributes(int* out) {
  using C = wide::Cfg<J>;
  return kernel_attributes(causal_bwd_cluster_kernel<J, DKV>, wide::THREADS, wide::bytes<J, DKV>(), C::TM, C::TN, out);
}

template <bool DKV>
int dispatch(const float* q, const float* k, const float* v, const float* g, const float* lse,
             const float* delta, float* out_a, float* out_b, int b, int s, int h, int d, Strides qs,
             Strides ks, Strides vs, Strides gs, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 16: return launch<16, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 32: return launch<32, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 64: return launch<64, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 128: return launch<128, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 256: return launch<256, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    default: return launch_wide<DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, d, qs, ks, vs, gs, scale, st);
  }
}

template <int D, bool DKV>
int attributes(int* out) {
  using C = Tiles<D>;
  return kernel_attributes(causal_bwd_kernel<D, DKV>, C::THREADS, smem_bytes<D, DKV>(), C::TM, C::TN, out);
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v and g (the cotangent
// of out) are device pointers to strided (B, S, heads, D) f32 arrays whose
// D axis is contiguous, with their batch, sequence and head strides in
// elements; lse and delta are contiguous (B, heads, S); dk, dv and dq are
// contiguous (B, S, heads, D); D is 8, 16, 32, 64, 128, 256 or a multiple
// of 128 past 256 up to 8192. Each returns a cudaError_t; 0 means the
// launch was accepted.
extern "C" int causal_attention_bwd_dkv(const float* q, const float* k, const float* v, const float* g,
                                        const float* lse, const float* delta, float* dk, float* dv, int b,
                                        int s, int h, int d, long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                        long long v_ss, long long v_sh, long long g_sb, long long g_ss,
                                        long long g_sh, float scale, void* stream) {
  return dispatch<true>(q, k, v, g, lse, delta, dk, dv, b, s, h, d, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                        {v_sb, v_ss, v_sh}, {g_sb, g_ss, g_sh}, scale, stream);
}

extern "C" int causal_attention_bwd_dq(const float* q, const float* k, const float* v, const float* g,
                                       const float* lse, const float* delta, float* dq, int b, int s, int h,
                                       int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                       long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, long long g_sb, long long g_ss, long long g_sh,
                                       float scale, void* stream) {
  return dispatch<false>(q, k, v, g, lse, delta, dq, nullptr, b, s, h, d, {q_sb, q_ss, q_sh},
                         {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {g_sb, g_ss, g_sh}, scale, stream);
}

// The kernel of head width d (dkv != 0: K5-dkv, else K5-dq) as built: out
// receives registers a thread, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, blocks an SM, TM and TN. Returns a cudaError_t.
extern "C" int causal_attention_bwd_attributes(int d, int dkv, int* out) {
  switch (d) {
    case 8: return dkv ? attributes<8, true>(out) : attributes<8, false>(out);
    case 16: return dkv ? attributes<16, true>(out) : attributes<16, false>(out);
    case 32: return dkv ? attributes<32, true>(out) : attributes<32, false>(out);
    case 64: return dkv ? attributes<64, true>(out) : attributes<64, false>(out);
    case 128: return dkv ? attributes<128, true>(out) : attributes<128, false>(out);
    case 256: return dkv ? attributes<256, true>(out) : attributes<256, false>(out);
    default: {
      int j, ranks;
      if (!wide_plan(d, j, ranks)) return cudaErrorInvalidValue;
      if (j == 1) return dkv ? wide_attributes<1, true>(out) : wide_attributes<1, false>(out);
      if (j == 2) return dkv ? wide_attributes<2, true>(out) : wide_attributes<2, false>(out);
      return dkv ? wide_attributes<4, true>(out) : wide_attributes<4, false>(out);
    }
  }
}

// The cluster kernel of head width d past 256 (dkv != 0: K5-dkv, else
// K5-dq): out receives the blocks of a cluster, the slice width at most,
// and the clusters the card can hold at once (0: it cannot launch).
// Returns a cudaError_t.
extern "C" int causal_attention_bwd_cluster(int d, int dkv, int* out) {
  int j, ranks;
  if (!wide_plan(d, j, ranks)) return cudaErrorInvalidValue;
  if (j == 1) return dkv ? wide_cluster<1, true>(ranks, out) : wide_cluster<1, false>(ranks, out);
  if (j == 2) return dkv ? wide_cluster<2, true>(ranks, out) : wide_cluster<2, false>(ranks, out);
  return dkv ? wide_cluster<4, true>(ranks, out) : wide_cluster<4, false>(ranks, out);
}
