// Causal flash attention, forward (K5-fwd), for Hopper (sm_90a).
//
// Replaces the Mosaic TPU kernel `_flash_attention_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py) that
// hopvae_tpu/ops/attention.py:flash_causal_attention calls for the
// Transformer prior. For one (batch, head) of q, k, v (S, D) it computes
//
//     out = softmax(scale * q k^T, causal) v      lse = log sum_j exp(...)
//
// row by row, with an online softmax, and writes out (B, S, heads, D) and
// the row log-sum-exp lse (B, heads, S), natural log, that the backward
// kernels (causal_attention_bwd.cu) rebuild the probabilities from.
//
// What bounds it on an H100: the tensor cores. It does two products over
// the causal triangle (q k^T and P v), 2 * D * S(S+1)/2 FLOPs each per
// head, and both run as mma.sync m16n8k8 on TF32 operands in three passes
// (mma_tf32.cuh): each operand splits into big and small TF32 parts and
// small * big, big * small, big * big are summed in f32, which keeps about
// 21 bits, close to f32. The ceiling is then 495 / 3 = 165 TFLOP/s
// f32-equivalent: at B = 256, S = 867, 0.60 ms for one head of D = 256 and
// 0.30 ms for 4 heads of 32 or one of 128, against 0.27 ms and 0.14 ms of
// memory traffic (q, k, v read once, out and lse written once). One TF32
// pass (11 bits) would move out by 3.5e-4 to 5.6e-4 normwise and lse by up
// to 1.3e-3, far past the 1e-5 the port holds them to
// (tests/test_torch_attention_tf32.py emulates both).
//
// Design:
// - One block owns TM query rows of one (batch, head) and walks the key
//   tiles of TN up to its diagonal only; blocks with the most tiles launch
//   first. q loads once; each k and v tile arrives by cp.async into one of
//   two buffers while the other is multiplied: 16-byte copies where an
//   input's base and strides allow it, 4-byte ones where not. Rows past S
//   are zero-filled and never written.
// - A warp owns a 16-row slab of the block's query rows (the M of an m16
//   mma); with SPLIT warps a slab, each takes 1/SPLIT of the head width:
//   its part of the score depth and its part of the output columns. The
//   scores of a key tile land in C fragments; with SPLIT > 1 the warps'
//   partial sums meet in shared memory and every warp of the slab adds all
//   of them up in warp order, so each holds the slab's whole score tile,
//   bit for bit the same in each.
// - The online softmax runs on those fragments: a row lives in the quad
//   of lanes 4g .. 4g + 3, so its max takes two xor shuffles; each lane
//   keeps its part of the row's denominator, summed over the quad once at
//   the end. The causal mask applies on the slab's diagonal tile only.
// - P stays in registers: P v takes a permuted k (k = t is key 2t, k = t +
//   4 key 2t + 1), so P's C fragment (c0, c2, c1, c3) is its A fragment,
//   and v's B fragment is read from the same permuted rows.
// - P v of each key tile is summed in fresh fragments, then added to the
//   rescaled running output: the tensor cores' sums truncate, and short
//   chains keep that error small (one chain over a whole walk of the K5
//   backward left 1.5e-5 normwise).
// - Up to D = 64 each q fragment is split into its TF32 parts once per
//   block and kept in registers; wider, and for k and v, each fragment is
//   split where it is used.
// - Shared memory holds f32 only, rows D + 4 floats apart
//   (causal_attention.cuh): conflict-free ldmatrix by row and scalar loads
//   by permuted row.
// - No float atomics: every output belongs to one warp and every sum runs
//   in a fixed order, so two launches give the same bits.
//
// Tiles per width (TM query rows, TN keys, warps a slab):
//   D       TM  TN  SPLIT  warps  shared bytes
//   8..64   64  64  1      4      1280 (D + 4)
//   128     64  32  1      4      101,376
//   256     64  32  2      8      216,064
// - Up to D = 64 a warp holds its slab's outputs over the full width and
//   q's split fragments (at most 64 registers each); 64-key tiles halve the
//   barriers and softmax rounds a key of 32-key ones.
// - At 128 the slab's 16 x 128 outputs take 64 accumulators a lane and the
//   tile's partial sums 64 more, so q is split per use and the key tiles
//   hold 32: with 64 the kernel reached 255 registers and ran slower.
// - At 256 two warps share a slab, 128 columns each, so that 64 query rows
//   (four slabs) share each k and v tile: q, two buffers of k and v, and
//   the exchange fill 216,064 of the 232,448 bytes a block may have.
// - Past 256 (any multiple of 128 up to 8192; the cluster kernel below,
//   the width a runtime argument) q no longer fits one block beside the k
//   and v tiles, so the depth is split across the blocks of a thread-block
//   cluster, on the backward's plan (cluster.cuh: slices
//   of 128, 256 or 512, up to 16 blocks): block rank r keeps its slice of
//   q for the whole walk and streams that slice of each key tile's k and v
//   into one of NB buffers. Per key tile each warp (a 16-row slab, a
//   64-column part of the slice) computes its partial q k^T over its 64
//   columns in a fresh sum; the slab's parts are added in part order in
//   shared memory (the rank sum); after one cluster barrier every warp
//   reads every rank's sums of its slab over DSMEM and adds them in rank
//   order: the backward's order, so every rank and warp holds the same
//   scores bit for bit, and the same m and l. Each warp then runs P v on
//   its own 64 columns of the v slice already in its shared memory; rank 0
//   writes lse. q is read once, k and v once per query tile, and no block
//   recomputes the scores. The operands split with the small part
//   truncated (split<true>), as the backward's cluster kernels do.
// - Latency bounds it (8 warps an SM, every one in step with the cluster
//   barrier), so each wait has work beside it: the barrier is split into
//   arrive and wait, with the previous tile's P v between them (the rank
//   sums double-buffered, P v one tile behind); the rank sums are loaded
//   (up to 16 float4 a lane at once) before the next tile's partial
//   scores, which run while they are in flight; with four buffers (slices
//   of 128 and 256) tile t + 2's copies go into tile t - 2's buffer after
//   tile t's barrier, which also makes tile t + 1's copies visible, so the
//   walk has no block barrier of its own. Shared bytes 201,728 / 178,688 /
//   175,360 (two buffers) at slices of 128 / 256 / 512; one block an SM.
//   Measured on an H100 (PERF.md): reading the rank sums after the partial
//   scores, two ranks at a time, ran 7% to 9% slower; three buffers and a
//   block barrier a tile up to 11% slower at 384 (within noise at 512);
//   two blocks an SM, with 16-key tiles (100,864 bytes, 128 registers,
//   152 bytes of spill) 8% to 11% slower, with 4 warps and 32 query rows
//   a block (100,864 bytes, the same bits) 4% to 11% slower.
// - Past 8192 a cluster would need more than 16 blocks; there the window
//   kernel runs (a route by width), on causal scores computed once, split
//   over the card (causal_attention_split.cuh): slab after slab of query
//   tiles within SPLIT_BYTES of scratch (and, where one tile's depth chunks
//   alone pass it, in rounds of chunks), a first pass computes each depth
//   chunk of 64 of every (query tile, key tile) pair in a fresh sum, chunks
//   in groups on a grid sized to the card; a second adds the chunks in
//   order into S; then a block owns 64 query rows and one window of 128
//   output columns (a grid axis), replays the online softmax key tile by
//   key tile from S and runs P v on its 128 columns of v, one item a tile.
//   Every score is the same chunk sums in the same order on every plan, so
//   m and l agree across windows; the first writes lse. Shared bytes:
//   52,224.
// tools/torch_attention_fwd_variants.py times this source against copies
// of it with other tiles; PERF.md has the times, and registers, spills and
// blocks an SM from causal_attention_fwd_attributes.

#include <algorithm>
#include <cstdint>

#include "causal_attention_cluster.cuh"
#include "causal_attention_split.cuh"

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

constexpr unsigned FULL = 0xffffffffu;
constexpr float MASKED = -1e30f;

// The online softmax of a slab's 16 x 8NT scores of one key tile, in C
// fragments: element e of n-tile j is row slab_lo + gq + 8 (e >> 1), key
// n_lo + 8j + 2tq + (e & 1). The scores are scaled and masked (some key
// of the tile exceeds some row of the slab on its diagonal tile only); a
// row's max takes two xor shuffles over its quad. m_r is the running max,
// l_r the lane's part of the denominator, alpha the factor that rescales
// the running output (0 on the slab's first tile), and sc becomes
// P = exp(score - max), 0 where masked: the slab's first live tile holds
// a key at or before each of its rows, so the max is finite.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&sc)[NT][4], float (&m_r)[2], float (&l_r)[2],
                                               float (&alpha)[2], int n_lo, int slab_lo, float scale, int gq,
                                               int tq) {
  const bool diag = n_lo + 8 * NT - 1 > slab_lo;
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = sc[j][e] * scale;
      if (diag && n_lo + 8 * j + 2 * tq + (e & 1) > slab_lo + gq + 8 * (e >> 1)) val = MASKED;
      sc[j][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    alpha[i] = __expf(m_r[i] - mx[i]);
    m_r[i] = mx[i];
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(sc[j][e] - mx[e >> 1]);
      sc[j][e] = p;
      rsum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rsum[i];
}

template <int D>
struct Tiles {
  static constexpr int SPLIT = D > 128 ? 2 : 1;              // warps of a 16-row slab
  static constexpr int TM = 64;                                // query rows of a block
  static constexpr int TN = D > 64 ? 32 : 64;                  // keys of a streamed tile
  static constexpr int NT = TN / 8;                            // n-tiles of a 16 x TN score slab
  static constexpr int WARPS = TM / 16 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RS = D + 4;                             // row stride in shared memory
  static constexpr int KD = D / SPLIT;  // a warp's depth of the scores and columns of the output
  static constexpr int CT = KD / 8;     // its k-steps of q k^T and its output n-tiles
  static constexpr bool Q_REGS = KD <= 64;  // q split once, into registers
  static constexpr int XCH = TM / 16 * SPLIT * NT * 128;        // floats of the exchange
  static_assert(KD % 8 == 0 && NT % 2 == 0, "tiles");
};

// floats of shared memory: the q tile, two buffers of a k and a v tile,
// and, when SPLIT > 1, the exchange of partial scores
template <int D>
constexpr size_t smem_bytes() {
  using C = Tiles<D>;
  return sizeof(float) * ((C::TM + 4 * C::TN) * C::RS + (C::SPLIT > 1 ? C::XCH : 0));
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
causal_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ out, float* __restrict__ lse, int s, int h, Strides qs, Strides ks,
                  Strides vs, float scale, unsigned vec16) {
  using C = Tiles<D>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, RS = C::RS, SPLIT = C::SPLIT, THREADS = C::THREADS;
  constexpr int CT = C::CT;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kv_s = q_s + TM * RS;                              // buffer u: k at kv_s + u * 2 * TN * RS, then v
  float4* xch = reinterpret_cast<float4*>(kv_s + 4 * TN * RS);  // the exchange, SPLIT > 1

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / SPLIT, part = warp % SPLIT;
  const int m0 = 16 * slab;  // the warp's query rows in the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int row_m0 = (gridDim.y - 1 - blockIdx.y) * TM;  // the longest walks first
  const int last = (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;  // the slab's first query row
  const int kd0 = C::KD * part;     // the warp's first column of depth and of output
  float4* x = xch + slab * SPLIT * NT * 32;  // the slab's exchange, [warp][n-tile][lane]
  const int bar = 1 + slab;                  // the slab's named barrier

  stage<D, TM, THREADS>(q_s, q, qs, b, hh, row_m0, s, vec16 & 1u);
  cp_async_commit();
  auto stage_kv = [&](int it, int u) {
    float* y = kv_s + u * 2 * TN * RS;
    stage<D, TN, THREADS>(y, k, ks, b, hh, it * TN, s, vec16 >> 1 & 1u);
    stage<D, TN, THREADS>(y + TN * RS, v, vs, b, hh, it * TN, s, vec16 >> 2 & 1u);
    cp_async_commit();
  };
  stage_kv(0, 0);

  // q's A fragments over the warp's depth, split once while tile 0 lands
  FragA qf[C::Q_REGS ? CT : 1];
  if constexpr (C::Q_REGS) {
    cp_async_wait_prior();
    __syncthreads();  // q has landed
#pragma unroll
    for (int c = 0; c < CT; ++c) qf[c] = load_a<RS>(q_s + m0 * RS + kd0 + 8 * c, gq, tq);
  }

  // rows gq and gq + 8 of the slab: the running max of the scaled scores,
  // the lane's part of the denominator, and the output over the warp's
  // columns kd0 + 8c + 2tq and + 1
  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it <= last; ++it) {
    const int u = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and the exchange
    if (it < last) stage_kv(it + 1, u ^ 1);
    const float* kt = kv_s + u * 2 * TN * RS;
    const float* vt = kt + TN * RS;
    const int n_lo = it * TN;  // the tile's first key

    // a slab whose rows all precede the tile's keys (or lie past S) skips
    // it with all its warps; otherwise key n_lo <= every row of the slab
    // (both are multiples of 16), so every row has a finite max
    if (n_lo > slab_lo + 15 || slab_lo >= s) continue;

    // ---- the warp's part of the slab's 16 x TN scores, C layout
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (C::Q_REGS) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB b0, b1;
          load_b_rows2<RS>(b0, b1, kt + 8 * j * RS + kd0 + 8 * c, gq, tq);
          mma3(sc[j], qf[c], b0);
          mma3(sc[j + 1], qf[c], b1);
        }
    } else {
#pragma unroll 2
      for (int c = 0; c < CT; ++c) {
        const FragA qa = load_a<RS>(q_s + m0 * RS + kd0 + 8 * c, gq, tq);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB b0, b1;
          load_b_rows2<RS>(b0, b1, kt + 8 * j * RS + kd0 + 8 * c, gq, tq);
          mma3(sc[j], qa, b0);
          mma3(sc[j + 1], qa, b1);
        }
      }
    }

    // ---- the slab's whole scores: the SPLIT partials added in warp order
    // (the exchange is free again after the next __syncthreads)
    if constexpr (SPLIT > 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        x[(part * NT + j) * 32 + lane] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      named_barrier(bar, 32 * SPLIT);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float4 a = x[j * 32 + lane];
#pragma unroll
        for (int p = 1; p < SPLIT; ++p) {
          const float4 y = x[(p * NT + j) * 32 + lane];
          a.x += y.x, a.y += y.y, a.z += y.z, a.w += y.w;
        }
        sc[j][0] = a.x, sc[j][1] = a.y, sc[j][2] = a.z, sc[j][3] = a.w;
      }
    }

    float alpha[2];
    online_softmax(sc, m_r, l_r, alpha, n_lo, slab_lo, scale, gq, tq);

    // ---- P v over the tile's keys 8j .. 8j + 7 in order, into fresh
    // fragments, then out = alpha out + P v
    float o[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      if (n8 > slab_lo + 15 || n8 >= s) continue;  // P = 0 for every row < S of the slab
      const FragA pa = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
#pragma unroll
      for (int c = 0; c < CT; ++c) mma3(o[c], pa, load_b_cols<RS>(vt + 8 * j * RS + kd0 + 8 * c, gq, tq));
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  }

  // ---- the denominators over the quad (every lane ends with the same
  // sum: each step adds the same two operands, and float addition
  // commutes); out = acc / l and lse = m + log l, rows < S only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = out_offset<D>(b, row, hh, s, h) + kd0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      *reinterpret_cast<float2*>(out + at + 8 * c) =
          make_float2(acc[c][2 * e] / l_r[e], acc[c][2 * e + 1] / l_r[e]);
    if (part == 0 && tq == 0) lse[static_cast<size_t>(bh) * s + row] = m_r[e] + logf(l_r[e]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int b, int s, int h,
           Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  const int m_tiles = (s + C::TM - 1) / C::TM;
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL || m_tiles > 65535)
    return cudaErrorInvalidValue;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2;
  auto kernel = causal_fwd_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * h, m_tiles), C::THREADS, bytes, stream>>>(q, k, v, out, lse, s, h, qs, ks, vs, scale, vec16);
  return cudaGetLastError();
}

template <int D>
int attributes(int* out) {
  using C = Tiles<D>;
  return tf32x3::kernel_attributes(causal_fwd_kernel<D>, C::THREADS, smem_bytes<D>(), C::TM, C::TN, out);
}


// ---- head widths past 8192: the window kernel, one instance for every
// multiple of 128 past 256 (the width d is a runtime argument), on the
// causal scores split over the card first (causal_attention_split.cuh)
namespace window {
using causal_split::RSC;
using causal_split::THREADS;
using causal_split::TM;
using causal_split::TN;
using causal_split::NT;
constexpr int CW = 128;               // output columns of a block: its window
constexpr int CT = CW / 8;            // a warp's output n-tiles
constexpr int RW = CW + 4;            // row stride of a v window
constexpr int SLOT = TM * RSC + TN * RW;  // one buffer: a tile of the scores, then the tile's v window
constexpr size_t BYTES = sizeof(float) * 2 * SLOT;
constexpr int STEP = 128;             // the wide widths: multiples of this past 256
}  // namespace window

// Block (x, y) of a slab of `units` units from u0 (causal_split's units:
// query tiles of B heads = bhs heads): the unit's TM query rows, window y
// of 128 output columns. It walks the key tiles up to its diagonal, one
// item a tile: the tile of the slab's scores S (B heads ... by unit, TM, S)
// and the tile's v window; the online softmax on the scores, then P v on
// the window.
__global__ void __launch_bounds__(window::THREADS)
causal_fwd_window_kernel(const float* __restrict__ v, const float* __restrict__ S, float* __restrict__ out,
                         float* __restrict__ lse, int s, int h, int d, int bhs, int u0, int units, Strides vs,
                         float scale, bool vv) {
  using namespace window;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * SLOT

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's query rows in the tile
  const int ul = causal_split::slab_unit<false>(units);
  const int u = u0 + ul, mt = u / bhs, bh = u - mt * bhs;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int row_m0 = mt * TM;
  const int col0 = blockIdx.y * CW;  // the block's window
  const int last = (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;
  const float* sb = S + static_cast<size_t>(ul) * TM * s;  // the unit's scores

  auto stage_item = [&](int it, int u) {
    float* y = buf + u * SLOT;
    causal_split::stage_sums(y, sb, it, s);
    stage<CW, TN, THREADS>(y + TM * RSC, v + col0, vs, b, hh, it * TN, s, vv);
    cp_async_commit();
  };
  stage_item(0, 0);

  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f};
  float acc[CT][4], sc[NT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it <= last; ++it) {
    const int u = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_item(it + 1, u ^ 1);
    const float* y = buf + u * SLOT;
    const int n_lo = it * TN;
    if (causal_split::slab_skips<false>(slab_lo, n_lo, s)) continue;  // as in causal_fwd_kernel

    // ---- online softmax on the tile's scores, then P v on the window
    causal_split::load_sums(sc, y, m0, gq, tq);
    y += TM * RSC;
    float alpha[2];
    online_softmax(sc, m_r, l_r, alpha, n_lo, slab_lo, scale, gq, tq);

    float o[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      if (n8 > slab_lo + 15 || n8 >= s) continue;
      const FragA pa = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
#pragma unroll
      for (int c = 0; c < CT; ++c) mma3(o[c], pa, load_b_cols<RW>(y + 8 * j * RW + 8 * c, gq, tq));
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * d + static_cast<size_t>(hh) * d +
                      col0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      *reinterpret_cast<float2*>(out + at + 8 * c) =
          make_float2(acc[c][2 * e] / l_r[e], acc[c][2 * e + 1] / l_r[e]);
    if (blockIdx.y == 0 && tq == 0) lse[static_cast<size_t>(bh) * s + row] = m_r[e] + logf(l_r[e]);
  }
}

// Past 8192: slab after slab, the causal scores split over the card into
// work (causal_split::split_slab), then the window kernel on them.
int launch_window(const float* q, const float* k, const float* v, float* out, float* lse, float* work, int b, int s,
                  int h, int d, Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  using namespace window;
  causal_split::Plan plan;
  if (b <= 0 || s <= 0 || h <= 0 || d <= 256 || d % STEP != 0 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      d / CW > 65535 || !causal_split::split_plan(b, s, h, d, 1, plan) || work == nullptr)
    return cudaErrorInvalidValue;
  const causal_split::Product scores{q, k, qs, ks, vec16_ok(q, qs) | vec16_ok(k, ks) << 1};
  cudaError_t err = cudaFuncSetAttribute(causal_fwd_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(BYTES));
  if (err != cudaSuccess) return err;
  const int bhs = b * h;
  const long long units = static_cast<long long>(bhs) * ((s + TM - 1) / TM);
  for (long long u0 = 0; u0 < units; u0 += plan.slab) {
    const int n = static_cast<int>(std::min<long long>(plan.slab, units - u0));
    err = causal_split::split_slab<false>(scores, scores, 1, plan, work, s, h, bhs, d, static_cast<int>(u0), n,
                                          stream);
    if (err != cudaSuccess) return err;
    causal_fwd_window_kernel<<<dim3(n, d / CW), THREADS, BYTES, stream>>>(v, work, out, lse, s, h, d, bhs,
                                                                         static_cast<int>(u0), n, vs, scale,
                                                                         vec16_ok(v, vs));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}


// ---- head widths past 256 up to 8192: the cluster kernel (see the
// header), one instance for each slice of at most J chunks of 128 (the
// width d is a runtime argument); its shared memory is cluster.cuh's Fwd
namespace wide = causal_attention::wide;

template <int J>
__global__ void __launch_bounds__(wide::THREADS, 1)
causal_fwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          float* __restrict__ out, float* __restrict__ lse, int s, int h, int d, Strides qs,
                          Strides ks, Strides vs, float scale, unsigned vec16) {
  using namespace wide;
  using C = Cfg<J>;
  using F = Fwd<J>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, WS = C::WS, SL = C::SL, RS = C::RS, PART = C::PART;
  constexpr int NB = fwd_buffers<J>();  // streamed buffers
  constexpr int CT = PART / 8;          // a warp's output n-tiles
  constexpr int RG = F::RG;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);                // the resident q slice
  float* str = q_s + TM * RS;                                   // buffer u at str + u * BUF: k, then v
  float4* xch = reinterpret_cast<float4*>(str + NB * F::BUF);  // the warps' partial scores
  float4* sums = xch + F::XCH;                                  // [tile & 1][slab][n-tile][lane]

  const int rank = cluster_rank(), ranks = cluster_ranks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / WS, part = warp % WS;
  const int m0 = 16 * slab;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int row_m0 = (gridDim.y - 1 - blockIdx.y) * TM;  // the longest walks first
  const int last = (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;
  const int c0 = rank * SL;          // the block's slice: columns c0 .. c0 + cols
  const int cols = min(SL, d - c0);  // a multiple of 128
  const int parts = cols / PART;     // the slab's warps with columns in this slice
  const int pc = PART * part;        // the warp's part of it
  const bool mine = part < parts;
  float4* xs = xch + slab * WS * NT * 32 + lane;  // the slab's partials, [part][n-tile]

  // tile `it` into buffer it % NB (nothing past the last); one commit group either way
  auto stage_kv = [&](int it) {
    if (it <= last) {
      float* y = str + (it % NB) * F::BUF;
      stage_slice<RS, TN>(y, k + c0, ks, b, hh, it * TN, s, vec16 >> 1 & 1u, cols);
      stage_slice<RS, TN>(y + TN * RS, v + c0, vs, b, hh, it * TN, s, vec16 >> 2 & 1u, cols);
    }
    cp_async_commit();
  };
  // a slab whose rows all precede tile it's keys, or lie past S, skips it
  // in every block of the cluster alike; its warps still meet every
  // cluster barrier
  auto live = [&](int it) { return !(it * TN > slab_lo + 15 || slab_lo >= s); };

  stage_slice<RS, TM>(q_s, q + c0, qs, b, hh, row_m0, s, vec16 & 1u, cols);
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) stage_kv(i);  // the q slice goes with the first

  // rows gq and gq + 8 of the slab: the running max, the lane's part of
  // the denominator, the last tile's rescale, the output over the warp's
  // columns c0 + pc + 8c + 2tq and + 1
  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float sc[NT][4];  // the warp's partial scores of the next tile
  float pr[NT][4];  // the slab's whole scores of a tile, then its P

  // ---- the warp's partial scores of tile it over its PART columns, in a
  // fresh sum (chains of 8 steps, as the backward's)
  auto partials = [&](int it) {
    const float* y = str + (it % NB) * F::BUF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (!(live(it) && mine)) return;
#pragma unroll 2
    for (int kk = pc; kk < pc + PART; kk += 8) {
      const FragA qa = load_a<RS, true>(q_s + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<RS, true>(b0, b1, y + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], qa, b0);
        mma3(sc[j + 1], qa, b1);
      }
    }
  };

  // ---- the slab's rank sum of tile it: the parts' partials added in part
  // order, n-tile j by the slab's warp j % WS, into sums buffer it & 1
  auto rank_sum = [&](int it) {
    if (!live(it)) return;
    if (mine) {
#pragma unroll
      for (int j = 0; j < NT; ++j) xs[(part * NT + j) * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    named_barrier(1 + slab, 32 * WS);
    float4* sw = sums + ((it & 1) * C::SLABS + slab) * NT * 32 + lane;
    for (int j = part; j < NT; j += WS) {
      float4 a = xs[j * 32];
      for (int p = 1; p < parts; ++p) add4(a, xs[(p * NT + j) * 32]);
      sw[j * 32] = a;
    }
  };

  // ---- the slab's whole scores of tile it: every rank's sums, read over
  // DSMEM RG ranks at a time and added in rank order, so every rank and
  // every warp of the slab holds the same bits; then the online softmax
  // turns them into P. The first group is loaded before the next tile's
  // partials, which hide its latency.
  float4 ps[RG][NT];
  auto load_group = [&](int it, int r0) {
    const float4* sr = sums + ((it & 1) * C::SLABS + slab) * NT * 32 + lane;
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (r0 + rr < ranks) ps[rr][j] = ld_cluster(sr + j * 32, r0 + rr);
  };
  auto softmax = [&](int it) {
    float4 t[NT];
    for (int r0 = 0; r0 < ranks; r0 += RG) {
      if (r0 > 0) load_group(it, r0);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (r0 + rr == 0) {
            t[j] = ps[rr][j];
          } else if (r0 + rr < ranks) {
            add4(t[j], ps[rr][j]);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) pr[j][0] = t[j].x, pr[j][1] = t[j].y, pr[j][2] = t[j].z, pr[j][3] = t[j].w;
    online_softmax(pr, m_r, l_r, alpha, it * TN, slab_lo, scale, gq, tq);
  };

  // ---- P v of tile it over the warp's PART columns of the v slice, the
  // tile's keys 8j .. 8j + 7 in order, in fresh fragments; then
  // out = alpha out + P v
  auto pv = [&](int it) {
    if (!(live(it) && mine)) return;
    const int n_lo = it * TN;
    const float* y = str + (it % NB) * F::BUF + TN * RS;
    float o[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      if (n8 > slab_lo + 15 || n8 >= s) continue;  // P = 0 for every row < S of the slab
      const FragA pa = split_a<true>(pr[j][0], pr[j][2], pr[j][1], pr[j][3]);
#pragma unroll
      for (int c = 0; c < CT; ++c) mma3(o[c], pa, load_b_cols<RS, true>(y + 8 * j * RS + pc + 8 * c, gq, tq));
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  };

  // ---- the walk, one tile behind in P v: while tile it's cluster barrier
  // is pending, the warps run tile it - 1's P v; after it, tile it + 1's
  // partials run while tile it's rank sums are in flight. A warp reads
  // tile it's rank sums before it arrives at tile it + 1's barrier, and
  // they are rewritten (tile it + 2) only after it. With four buffers the
  // cluster barrier also orders the copies: each thread waits for its own
  // copies of tile it + 1 before it arrives at tile it's barrier (they are
  // everyone's after it), and tile it + 2 goes into tile it - 2's buffer,
  // whose P v every warp ran before arriving at it.
  if constexpr (NB == 4) cp_async_wait_prior();
  else cp_async_wait_all();
  __syncthreads();  // the q slice and tile 0 have landed
  partials(0);
  for (int it = 0; it <= last; ++it) {
    rank_sum(it);
    if constexpr (NB == 4) cp_async_wait_all();  // this thread's copies of tile it + 1
    cluster_arrive();  // tile it's rank sums are in place; tile it - 1's are read
    if (it > 0) pv(it - 1);
    if constexpr (NB == 2) {
      __syncthreads();  // every warp is done with tile it - 1's buffer
      stage_kv(it + 1);
    }
    cluster_wait();
    if constexpr (NB == 4) stage_kv(it + 2);
    const bool own = live(it) && mine;
    if (own) load_group(it, 0);
    if (it < last) {
      if constexpr (NB == 2) {
        cp_async_wait_all();
        __syncthreads();  // tile it + 1 has landed
      }
      partials(it + 1);
    }
    if (own) softmax(it);
  }
  pv(last);
  cluster_arrive();  // no block leaves while another may still read its shared memory
  cluster_wait();

  if (!mine) return;
  // ---- the denominators over the quad; out = acc / l and lse = m + log l
  // (rank 0's first warp of the slab), rows < S only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * d + static_cast<size_t>(hh) * d +
                      c0 + pc + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      *reinterpret_cast<float2*>(out + at + 8 * c) =
          make_float2(acc[c][2 * e] / l_r[e], acc[c][2 * e + 1] / l_r[e]);
    if (rank == 0 && part == 0 && tq == 0) lse[static_cast<size_t>(bh) * s + row] = m_r[e] + logf(l_r[e]);
  }
}

template <int J>
int launch_cluster(const float* q, const float* k, const float* v, float* out, float* lse, int b, int s, int h, int d,
                   int ranks, Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  dim3 grid;
  cudaError_t err = causal_attention::attention_grid(b, s, h, wide::Cfg<J>::TM, ranks, grid);
  if (err == cudaSuccess)
    err = cluster_config(causal_fwd_cluster_kernel<J>, wide::fwd_bytes<J>(), grid, config, attr, stream);
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2;
  return cudaLaunchKernelEx(&config, causal_fwd_cluster_kernel<J>, q, k, v, out, lse, s, h, d, qs, ks, vs, scale,
                            vec16);
}

// Past 256: the cluster kernel up to 8192, the window kernel past it (a
// route by width: a cluster of more than 16 blocks cannot launch).
int launch_wide(const float* q, const float* k, const float* v, float* out, float* lse, float* work, int b, int s,
                int h, int d, Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  int j, ranks;
  if (!wide_plan(d, j, ranks)) return launch_window(q, k, v, out, lse, work, b, s, h, d, qs, ks, vs, scale, stream);
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (j) {
    case 1: return launch_cluster<1>(q, k, v, out, lse, b, s, h, d, ranks, qs, ks, vs, scale, stream);
    case 2: return launch_cluster<2>(q, k, v, out, lse, b, s, h, d, ranks, qs, ks, vs, scale, stream);
    default: return launch_cluster<4>(q, k, v, out, lse, b, s, h, d, ranks, qs, ks, vs, scale, stream);
  }
}

template <int J>
int wide_attributes(int* out) {
  using C = wide::Cfg<J>;
  return kernel_attributes(causal_fwd_cluster_kernel<J>, wide::THREADS, wide::fwd_bytes<J>(), C::TM, C::TN, out);
}

template <int J>
int wide_cluster(int ranks, int* out) {
  return cluster_attributes(causal_fwd_cluster_kernel<J>, wide::fwd_bytes<J>(), wide::Cfg<J>::SL, ranks, out);
}
}  // namespace

// Floats of device scratch that causal_attention_fwd needs at (B, S,
// heads, D): past 8192, the split scores of a slab and the parts of a
// round of chunks (causal_attention_split.cuh), at most SPLIT_BYTES; 0 at
// other widths, and -1 where the plan refuses the shape.
extern "C" long long causal_attention_fwd_workspace(int b, int s, int h, int d) {
  int j, ranks;
  causal_split::Plan plan;
  if (b <= 0 || s <= 0 || h <= 0 || d <= 256 || d % window::STEP != 0 || wide_plan(d, j, ranks)) return 0;
  return causal_split::split_plan(b, s, h, d, 1, plan) ? plan.floats : -1;
}

// The split plan of (B, S, heads, D) past 8192: out receives the slabs,
// the units (query tiles of 64 rows of one head) of a slab, the rounds of
// depth chunks and the chunks of a round. Returns a cudaError_t
// (cudaErrorInvalidValue where the plan refuses the shape).
extern "C" int causal_attention_fwd_plan(int b, int s, int h, int d, int* out) {
  int j, ranks;
  causal_split::Plan plan;
  if (d <= 256 || d % window::STEP != 0 || wide_plan(d, j, ranks) || !causal_split::split_plan(b, s, h, d, 1, plan))
    return cudaErrorInvalidValue;
  out[0] = plan.slabs, out[1] = plan.slab, out[2] = plan.rounds, out[3] = plan.round;
  return cudaSuccess;
}

// Plain C entry point (bound with ctypes). q, k, v are device pointers to
// strided (B, S, heads, D) f32 arrays whose D axis is contiguous, with
// their batch, sequence and head strides in elements; out is a contiguous
// (B, S, heads, D) and lse a contiguous (B, heads, S); work is the
// scratch of causal_attention_fwd_workspace (null where that is 0); D is
// 8, 16, 32, 64, 128, 256 or a multiple of 128 past 256 (the cluster
// kernel up to 8192, the window kernel past it). Returns a cudaError_t; 0
// means the launch was accepted; a cluster that fails to launch returns
// its error.
extern "C" int causal_attention_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
                                    float* work, int b, int s, int h, int d, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float scale,
                                    void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 16: return launch<16>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 32: return launch<32>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 64: return launch<64>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 128: return launch<128>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 256: return launch<256>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    default: return launch_wide(q, k, v, out, lse, work, b, s, h, d, qs, ks, vs, scale, st);
  }
}

// The kernel of head width d as built: out receives registers a thread,
// dynamic shared bytes, local (spill) bytes a thread, threads a block,
// blocks an SM, TM and TN. Returns a cudaError_t.
extern "C" int causal_attention_fwd_attributes(int d, int* out) {
  switch (d) {
    case 8: return attributes<8>(out);
    case 16: return attributes<16>(out);
    case 32: return attributes<32>(out);
    case 64: return attributes<64>(out);
    case 128: return attributes<128>(out);
    case 256: return attributes<256>(out);
    default: {
      int j, ranks;
      if (wide_plan(d, j, ranks)) return j == 1 ? wide_attributes<1>(out) : j == 2 ? wide_attributes<2>(out)
                                                                                    : wide_attributes<4>(out);
      if (d <= 256 || d % window::STEP != 0) return cudaErrorInvalidValue;
      return tf32x3::kernel_attributes(causal_fwd_window_kernel, window::THREADS, window::BYTES, window::TM,
                                       window::TN, out);
    }
  }
}

// The cluster kernel of head width d past 256 up to 8192: out receives the
// blocks of a cluster, the slice width at most, and the clusters the card
// can hold at once (0: it cannot launch). Returns a cudaError_t.
extern "C" int causal_attention_fwd_cluster(int d, int* out) {
  int j, ranks;
  if (!wide_plan(d, j, ranks)) return cudaErrorInvalidValue;
  if (j == 1) return wide_cluster<1>(ranks, out);
  if (j == 2) return wide_cluster<2>(ranks, out);
  return wide_cluster<4>(ranks, out);
}
