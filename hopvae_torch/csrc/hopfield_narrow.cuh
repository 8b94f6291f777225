// The wide streaming Hopfield lookups where the clusters
// (hopfield_cluster.cuh) do not run: one side at most 128 and the other
// past 256, or a side past 8192. This header holds the forward K1
// (hopfield_stream_fwd.cu) with K4's wide stages
// (hopfield_bottleneck_fused.cu), the route of the wide forward
// (launch_fwd), and the pieces that the narrow-side kernels of K2
// (hopfield_stream_bwd_dx.cu) and K3 (hopfield_stream_bwd_dku.cu) share
// with it: the ordered depth parts, the staging sized to the live columns
// and the split of a product (the scores, or K2's g U^T) over the card,
// which K2 and K3 run in slabs of tiles (slab_plan).
//
// It replaces the window kernels (K1's stream_fwd_wide_kernel and K2's
// stream_bwd_dq_wide_kernel; K3's likewise), the forward's of which padded
// the narrow side to a window of 128 output columns (at d_out 3, 16
// n-tiles of P U of which 1 is live) and to chunks of 64 of the depth (at d_in 3, 8 k-steps of
// which 1 is live), ran ceil(N / 64) blocks whatever the card (64 at N
// 4,096, one at N 37) and waited on a barrier at every chunk of a
// two-buffer ring. What bounds these lookups on an H100 is latency: the
// products are a few microseconds at the TF32 rate (phase 2 of
// chip_smoke.py), and what the card waits on is the chain of mma.sync of a
// part, the copies and the barriers. So the kernels here:
// - size the narrow side to its width: the output window is a template
//   width of 8, 16, 32, 64 or 128 columns (the output width padded to 8,
//   up to 128), and a product's depth runs only the k-steps below its
//   width; the copies stage the live columns only (to a power of two from
//   8, zero-filled past the width);
// - keep the 64-column parts of the depth as the window kernels had them (each part's
//   three-pass TF32 products in a fresh sum of their own), and sum them in
//   the order that the backward K2 and K3 use at the same widths
//   (score_order), on whichever route they run: the window kernels' order
//   (part after part) where d_in is at most 128 or a side passes 8192, so
//   that the scores, m and l keep the window kernels' bits there; the
//   cluster's slices' (groups of 2J parts, a slice, each group summed in
//   order, the groups in order, the small TF32 parts truncated) where
//   hopfield_cluster::slices takes the widths, as on the cluster. Either
//   way the rows K2 and K3 rebuild from K1's m and l meet scores summed as
//   K1 summed them;
// - fill the card from the token count: where ceil(N / 64) blocks leave
//   SMs idle and the depth has more than one group, the scores are split
//   (split_scores): a first pass computes each group's sum of every
//   (token tile, pattern tile) on a grid as wide as the card wants, a
//   second adds the groups in order into S = q K^T (N, M), and the
//   forward then reads S in place of its parts. The sums are the same
//   operations in the same order: the same bits as without the split.
//   The plan (fwd_window_plan) comes from N, M, the widths and the SMs;
//   the scratch is capped at SPLIT_BYTES. Where the groups' sums pass it,
//   S is computed once all the same, slab after slab of token tiles
//   within SPLIT_BYTES (fwd_slab_plan): a score pass in which each block
//   owns its tiles of S and adds every part in registers in the walk's
//   order, then the forward on the slab's S; no part reaches memory, and
//   the pass's grid fills the card where ceil(N / 64) walking blocks
//   would not (at (8320, 3), N 256, M 2,048: 256 blocks, not 4). A split
//   over a thread-block cluster of the groups, their sums meeting over
//   DSMEM in rank order at each tile, lost to it on an H100 (K1 at (384,
//   3), N 4,096, 0.143 against 0.114 ms; at (1280, 3), N 37, 0.144
//   against 0.070; PERF.md):
//   every tile waits on a cluster barrier, and rank 0's softmax and P U
//   on the other ranks' sums, so the groups' walks never overlap;
// - stream part items (a part of the resident rows and of the tile, or
//   the tile's window) through two buffers, one block barrier an item. A
//   ring of three (78,336 shared bytes, 2 blocks an SM) lost to two
//   (52,224 bytes, 4 blocks an SM at a window of 8) on an H100: K1 at
//   (384, 3), N 73,984, 9.89 against 7.56 ms; in the score pass rings of
//   three and four ran no faster, and 1.3 times slower at (384, 3), N
//   4,096, M 4,096 (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//
// Every product is mma.sync m16n8k8 on TF32 operands in three passes; f32
// sums in a fixed order, no float atomics: every output has the same bits
// in every run. Shared bytes: 52,224 (two buffers of a 64 + 32 row part
// item), whatever the widths; pass 1 of the split 26,112 more for each
// part of its group of q.

#pragma once

#include <algorithm>

#include "hopfield_cluster.cuh"
#include "hopfield_stream.cuh"
#include "hopfield_wide.cuh"

namespace hopfield_narrow {

using namespace hopfield_stream;
using namespace tf32x3;
using hopfield_wide::Epilogue;
using hopfield_wide::PLAIN;
using hopfield_wide::QUANTIZE;
using hopfield_wide::SHIFT;

constexpr int TM = 64;    // resident rows of a block: tokens (K1, K4) or patterns (K3)
constexpr int TN = 32;    // streamed rows of a tile: patterns (K1, K4) or tokens (K3)
constexpr int NT = TN / 8;
constexpr int PART = 64;  // columns of a part of a product's depth
constexpr int THREADS = 32 * TM / 16;  // a warp a 16-row slab
constexpr int NB = 2;     // buffers: item i + 1 is staged while item i is used (three lost; see above)
constexpr int RP = PART + 4;  // row stride of a part item (TM resident and TN streamed rows)
constexpr int RSC = TN + 4;   // row stride of a staged tile of split sums (TM resident rows, TN streamed)
constexpr int SLOT = (TM + TN) * RP;  // floats of a buffer
static_assert(TM * RSC + TN * (128 + 4) <= SLOT, "K1's scores and a window of U fit a buffer");
static_assert(TN * (128 + 4) + 3 * TN <= SLOT, "K3's window and the row stats fit a buffer");
constexpr size_t BYTES = sizeof(float) * NB * SLOT;
// the split's scratch at most: K1's groups' sums and S; a slab's of K2 and K3
constexpr long long SPLIT_BYTES = 64ll << 20;

__host__ __device__ inline int parts_of(int d) { return (d + PART - 1) / PART; }
__host__ __device__ inline int windows_of(int d, int cw) { return (d + cw - 1) / cw; }
// the staged width of `cols` live columns: the next power of two from 8
__host__ __device__ inline int staged(int cols) {
  int w = 8;
  while (w < cols) w <<= 1;
  return w;
}

// The order in which a lookup of widths (d_in, d_out) sums the parts of
// its scores: `group` parts summed in order make a group, the groups add
// in order; trunc: the small TF32 parts truncated. The order of K1, K2 and
// K3 at the same widths, whatever their routes: the cluster's slices'
// where hopfield_cluster::slices takes the widths (a slice of 128 J
// columns is 2J parts), else one part a group, rounded (the former window
// kernels' order). It reads the slices, not the route: where the
// narrow-side K2 and K3 replace the cluster they keep its order, in which
// K1's bits were made.
struct Order {
  int group;
  bool trunc;
};
inline Order score_order(int d_in, int d_out) {
  int j, ranks;
  if (hopfield_cluster::slices(d_in, d_out, j, ranks)) return {2 * j, true};
  return {1, false};
}
inline int groups_of(int d_in, Order o) { return (parts_of(d_in) + o.group - 1) / o.group; }

inline int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return sms;
}

// Whether the scores of a depth of `groups` groups are computed apart
// before the forward, when `blocks` blocks would walk them in one pass:
// more than one group, and fewer blocks than the card holds at two an SM.
inline bool split_pays(int groups, long long blocks, int sms) { return groups >= 2 && blocks < 2ll * sms; }
// Whether the split (split_scores) of n token rows by m patterns fits:
// every group's sums and S within SPLIT_BYTES.
inline bool split_fits(int n, int m, int groups) { return 4ll * (groups + 1) * n * m <= SPLIT_BYTES; }
// floats of the split's scratch: each group's sums, then S
inline long long split_floats(int n, int m, int groups) { return static_cast<long long>(groups + 1) * n * m; }

// Rows [row0, row0 + ROWS) of columns [c0, c0 + w) of a row-major (rows,
// d) array into a tile of row stride rs by cp.async (the caller commits);
// w is a power of two from 8, zeros past d and past `rows`. vec16:
// 16-byte copies (the base on 16 bytes, d and c0 multiples of 4). NTH:
// the block's threads.
template <int ROWS, int NTH = THREADS>
__device__ __forceinline__ void stage(float* dst, int rs, const float* __restrict__ src, int d, int c0, int w,
                                      int row0, int rows, bool vec16) {
  if (vec16) {
    const int sh = 29 - __clz(w);  // log2(w / 4)
    for (int i = threadIdx.x; i < (ROWS << sh); i += NTH) {
      const int r = i >> sh;
      const int c = (i & ((1 << sh) - 1)) << 2;
      const bool in = row0 + r < rows && c0 + c < d;
      cp_async16(dst + r * rs + c, in ? src + static_cast<size_t>(row0 + r) * d + c0 + c : src, in);
    }
  } else {
    const int sh = 31 - __clz(w);
    for (int i = threadIdx.x; i < (ROWS << sh); i += NTH) {
      const int r = i >> sh;
      const int c = i & (w - 1);
      const bool in = row0 + r < rows && c0 + c < d;
      cp_async4(dst + r * rs + c, in ? src + static_cast<size_t>(row0 + r) * d + c0 + c : src, in);
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// The slab's 16 x TN product of a part item over its first ks k-steps, in
// a fresh sum: the A rows at a, the B rows at b, both of row stride RP.
template <bool TRUNC>
__device__ __forceinline__ void part_product(float (&part)[NT][4], const float* a, const float* b, int ks, int gq,
                                             int tq) {
  zero(part);
#pragma unroll 2
  for (int c = 0; c < ks; ++c) {
    const FragA fa = load_a<RP, TRUNC>(a + 8 * c, gq, tq);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      FragB b0, b1;
      load_b_rows2<RP, TRUNC>(b0, b1, b + 8 * j * RP + 8 * c, gq, tq);
      mma3(part[j], fa, b0);
      mma3(part[j + 1], fa, b1);
    }
  }
}

// The k-steps of part p of a depth d: its live columns rounded up to 8.
__device__ __forceinline__ int part_steps(int d, int p) { return (min(PART, d - p * PART) + 7) / 8; }

// Part p's fresh sum pp into the running sums in `group` order: gs, the
// open group's, takes the group's parts in order; sc, the scores', the
// groups in order (the first group is sc itself).
__device__ __forceinline__ void add_part(float (&sc)[NT][4], float (&gs)[NT][4], const float (&pp)[NT][4], int p,
                                         int group, int parts) {
  const int k = p % group;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gs[j][e] = k == 0 ? pp[j][e] : gs[j][e] + pp[j][e];
  if (k == group - 1 || p == parts - 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = p < group ? gs[j][e] : sc[j][e] + gs[j][e];
  }
}

// ---- the split: S = q K^T (n, m) of the built q (n, d_in)

// Pass 1: the sums of group g0 + blockIdx.z of the block's TM token rows
// and pattern tiles [blockIdx.y per, + per) into parts (round's groups, n,
// m). The group's parts of q stay in shared memory for the whole walk, a
// TM x RP tile each; the parts of K stream through the ring, a TN x RP
// item each.
__global__ void __launch_bounds__(THREADS)
partial_scores_kernel(const float* __restrict__ q, const float* __restrict__ K, float* __restrict__ parts, int n,
                      int m_patterns, int d_in, int per, int group, int trunc, unsigned vec16, int g0) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = blockIdx.x * TM;
  const int p0 = (g0 + blockIdx.z) * group;
  const int np = min(group, parts_of(d_in) - p0);
  float* q_s = reinterpret_cast<float*>(smem4);  // part k of the group at q_s + k TM RP
  float* buf = q_s + np * TM * RP;               // buffer u at buf + u TN RP
  const int t0 = blockIdx.y * per;
  const int t1 = min((m_patterns + TN - 1) / TN, t0 + per);
  const int items = (t1 - t0) * np;
  const bool qv = vec16 & 1u, kv = vec16 >> 1 & 1u;

  for (int k = 0; k < np; ++k) {
    const int c0 = (p0 + k) * PART;
    stage<TM>(q_s + k * TM * RP, RP, q, d_in, c0, staged(min(PART, d_in - c0)), row0, n, qv);
  }
  auto stage_item = [&](int i) {
    if (i < items) {
      const int it = t0 + i / np, c0 = (p0 + i % np) * PART;
      stage<TN>(buf + (i % NB) * TN * RP, RP, K, d_in, c0, staged(min(PART, d_in - c0)), it * TN, m_patterns, kv);
    }
    cp_async_commit();  // the group's q goes with the first
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_item(i);

  float gs[NT][4], pp[NT][4];
  zero(gs);
  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    stage_item(i + NB - 1);
    const float* y = buf + (i % NB) * TN * RP;
    const int k = i % np;
    const float* a = q_s + k * TM * RP + m0 * RP;
    if (trunc) part_product<true>(pp, a, y, part_steps(d_in, p0 + k), gq, tq);
    else part_product<false>(pp, a, y, part_steps(d_in, p0 + k), gq, tq);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[j][e] = k == 0 ? pp[j][e] : gs[j][e] + pp[j][e];
    if (k < np - 1) continue;
    const int p_lo = (t0 + i / np) * TN;
    float* out = parts + static_cast<size_t>(blockIdx.z) * n * m_patterns;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + m0 + gq + 8 * (e >> 1), col = p_lo + 8 * j + 2 * tq + (e & 1);
        if (row < n && col < m_patterns) out[static_cast<size_t>(row) * m_patterns + col] = gs[j][e];
      }
  }
}

// shared bytes of pass 1 for groups of `group` parts: the group's q and
// the ring of K's parts
inline size_t partial_bytes(int group) { return sizeof(float) * (group * TM + NB * TN) * RP; }

// Pass 2: the groups' sums added in order, in f32, into S: onto S as it
// stands, or, for the first groups (`first`), from the first group's sums.
// Re-reading an f32 from memory changes no bit, so S is the same whatever
// the rounds of groups.
__global__ void sum_groups_kernel(const float* __restrict__ parts, int groups, long long count,
                                  float* __restrict__ S, bool first) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float t = first ? parts[i] : S[i] + parts[i];
    for (int g = 1; g < groups; ++g) t += parts[g * count + i];
    S[i] = t;
  }
}

// S = q K^T (n, m_patterns) in the order o, through `work` (the groups'
// sums, split_floats(...) - n m floats): pass 1 on about three blocks an
// SM, then the ordered sum. With a `round` of groups from g0 (0: the rest),
// only those, added onto S in order (g0 0: S starts from them), through
// round n m floats of `work`.
inline cudaError_t split_scores(const float* q, const float* K, float* S, float* work, int n, int m_patterns,
                                int d_in, Order o, int sms, cudaStream_t stream, int g0 = 0, int round = 0) {
  const int groups = round > 0 ? std::min(round, groups_of(d_in, o) - g0) : groups_of(d_in, o) - g0;
  if (groups < 1 || groups > 65535) return cudaErrorInvalidValue;
  const int group = std::min(o.group, parts_of(d_in));
  const size_t bytes = partial_bytes(group);
  cudaError_t err =
      cudaFuncSetAttribute(partial_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int rt = (n + TM - 1) / TM, tiles = (m_patterns + TN - 1) / TN;
  const long long units = static_cast<long long>(rt) * tiles * groups;
  const int per =
      static_cast<int>(std::min<long long>(tiles, std::max<long long>(1, units / (3ll * std::max(sms, 1)))));
  const unsigned vec16 = vec16_ok(q, d_in) | vec16_ok(K, d_in) << 1;
  partial_scores_kernel<<<dim3(rt, (tiles + per - 1) / per, groups), THREADS, bytes, stream>>>(
      q, K, work, n, m_patterns, d_in, per, o.group, o.trunc, vec16, g0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(n) * m_patterns;
  constexpr int T = 256;
  const long long blocks = std::min<long long>((count + T - 1) / T, 8ll * std::max(sms, 1));
  sum_groups_kernel<<<static_cast<int>(blocks), T, 0, stream>>>(work, groups, count, S, g0 == 0);
  return cudaGetLastError();
}

// ---- the split products of K2 and K3 in slabs
//
// K2 (hopfield_stream_bwd_dx.cu) and K3 (hopfield_stream_bwd_dku.cu) split
// their products over the card in slabs. A unit is one tile of TM resident
// rows whose sums span every column: token rows in K2 (S = q K^T and
// P = g U^T over the M patterns), pattern rows in K3 (S^T = K q^T and
// P^T = U g^T over the N tokens, the orientation of its own walk). A slab
// is a run of units. For each slab and each of its products in turn:
// rounds of the product's groups (S: score_order's groups of parts of 64;
// P: one part a group, rounded), each round's groups apart (pass 1), then
// added in order onto the product's sums (pass 2; the first round from
// group 0's sums); then the window kernel reads the slab's sums. Every
// entry is the groups' sum in order, as the walk adds them in registers,
// whatever the slabs and rounds. Every
// output row of K2 (dq of a token) and of K3 (dK and dU of a pattern)
// belongs to one unit, so a slab finishes its rows: nothing carries across
// launches, and no float atomics.
//
//   sums  [products][slab's rows][cols]
//   parts [round's parts][slab's rows][cols]   (one product's at a time)
struct SlabPlan {
  int slab;          // units of a slab (the last may hold fewer)
  int slabs;
  int round;         // parts of a round (the last may hold fewer)
  int rounds;
  long long floats;  // the scratch: the sums, then a round's parts
};

// The plan of `rows` resident rows (units of TM) by `cols` columns for
// `products` products of at most `parts` groups: slabs of the most units
// whose sums and every part fit SPLIT_BYTES; where those are fewer than
// `fill` units (as many as keep the window kernel at two blocks an SM),
// slabs of `fill` units, or as many as their sums and one group allow, in
// rounds of the most groups that fit; balanced. false, p untouched, where
// one unit's sums and one group pass the cap.
inline bool slab_plan(int rows, int cols, int products, int parts, long long fill, SlabPlan& p) {
  if (rows <= 0 || cols <= 0 || products <= 0 || parts <= 0) return false;
  const long long units = (rows + TM - 1) / TM, unit = static_cast<long long>(TM) * cols;
  const long long cap = SPLIT_BYTES / static_cast<long long>(sizeof(float));
  const long long want = std::min(units, std::max(fill, 1ll));
  long long per = std::min(units, cap / ((products + parts) * unit)), round = parts;
  if (per < want) {
    per = std::min(want, cap / ((products + 1) * unit));
    if (per < 1) return false;
    round = std::min<long long>(parts, cap / (per * unit) - products);
  }
  const long long slabs = (units + per - 1) / per, rounds = (parts + round - 1) / round;
  p.slabs = static_cast<int>(slabs);
  p.slab = static_cast<int>((units + slabs - 1) / slabs);
  p.rounds = static_cast<int>(rounds);
  p.round = static_cast<int>((parts + rounds - 1) / rounds);
  p.floats = (products + p.round) * std::min<long long>(static_cast<long long>(p.slab) * TM, rows) * cols;
  return true;
}

// One slab's product a b^T, a (rows, d) resident and b (cols, d) streamed,
// into sums (rows, cols) in the order o: rounds of `round` groups through
// `parts`.
inline cudaError_t split_slab(const float* a, const float* b, float* sums, float* parts, int rows, int cols, int d,
                              Order o, int round, int sms, cudaStream_t stream) {
  for (int g0 = 0; g0 < groups_of(d, o); g0 += round) {
    const cudaError_t err = split_scores(a, b, sums, parts, rows, cols, d, o, sms, stream, g0, round);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- the whole window: K2's and K3's plan where all of d_in fits a block
//
// Where d_in passes 256 and d_out is narrow, dq (K2) and dK (K3) need
// ceil(d_in / 128) windows, and the narrow-side plan splits the scores
// over the card first so that no window recomputes them: at (384, 3), N
// 73,984, M 4,096 the groups' sums and S move about 12 GB through device
// memory. The whole window instead keeps one block's 64 resident rows by
// all of d_in: eight warps, a 16-row slab and half of the output columns
// each; per streamed tile each warp computes two n-tiles of its slab's
// scores (ordered_pair, every part in registers) and hands them, as dS
// (K3: A^T and dS^T), to the slab's other warp through shared memory.
// Every score is computed once and none reaches device memory. It takes
// d_in up to 384 with d_out up to 8, and up to 320 with d_out up to 64
// (whole_fits): the resident rows, two streamed tiles and the exchange
// fill about 210 KB of shared memory, one block an SM, 96 accumulators a
// thread at 384.
constexpr int WHOLE_THREADS = 256;
constexpr int DS = TN + 4;  // row stride of the exchanged tiles (TM resident rows by TN streamed)

// The whole window's instance at (d_in, d_out) past 256: dw, the staged
// depth (384 where d_out is at most 8, 320 up to 64), and wo, the staged
// width of g and U; false where no instance takes the widths.
inline bool whole_fits(int d_in, int d_out, int& dw, int& wo) {
  if (d_in <= 256) return false;
  if (d_in <= 384 && d_out <= 8) {
    dw = 384, wo = 8;
    return true;
  }
  if (d_in <= 320 && d_out <= 64) {
    dw = 320, wo = 64;
    return true;
  }
  return false;
}

// f(DW, WO) as std::integral_constants for whole_fits' dw.
template <typename F>
auto with_whole(int dw, F&& f) {
  if (dw == 384) return f(std::integral_constant<int, 384>{}, std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 320>{}, std::integral_constant<int, 64>{});
}

// Two n-tiles (the 16 streamed rows at b) of the 16-row slab at a of a
// part of a b^T, both of row stride RS, over its first ks k-steps in a
// fresh sum: per k-step the same three passes in the same order as
// part_product, so each entry has part_product's bits.
template <int RS, bool TRUNC>
__device__ __forceinline__ void pair_part(float (&pp)[2][4], const float* a, const float* b, int ks, int gq, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pp[j][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < ks; ++c) {
    const FragA fa = load_a<RS, TRUNC>(a + 8 * c, gq, tq);
    FragB b0, b1;
    load_b_rows2<RS, TRUNC>(b0, b1, b + 8 * c, gq, tq);
    mma3(pp[0], fa, b0);
    mma3(pp[1], fa, b1);
  }
}

// The same two n-tiles of a b^T over the depth d in the order (group,
// trunc): the parts of PART columns, each in a fresh sum, summed as
// add_part sums them, so each score has the walk's bits.
template <int RS>
__device__ __forceinline__ void ordered_pair(float (&sc)[2][4], const float* a, const float* b, int d, int group,
                                             int trunc, int gq, int tq) {
  float gs[2][4], pp[2][4];
  const int np = parts_of(d);
  for (int p = 0; p < np; ++p) {
    if (trunc) pair_part<RS, true>(pp, a + p * PART, b + p * PART, part_steps(d, p), gq, tq);
    else pair_part<RS, false>(pp, a + p * PART, b + p * PART, part_steps(d, p), gq, tq);
    const int k = p % group;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[j][e] = k == 0 ? pp[j][e] : gs[j][e] + pp[j][e];
    if (k == group - 1 || p == np - 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = p < group ? gs[j][e] : sc[j][e] + gs[j][e];
    }
  }
}

// A warp's C fragment (rows gq, gq + 8 of the slab at t; columns 2 tq,
// + 1 of n-tile j) into an exchanged tile, and the slab's A fragment of
// k-step j back, over the permuted k (the C layout read as (c0, c2, c1,
// c3), as load_b_cols pairs it).
__device__ __forceinline__ void put_pair(float* t, int j, const float (&v)[4], int gq, int tq) {
  float* r = t + gq * DS + 8 * j + 2 * tq;
  *reinterpret_cast<float2*>(r) = make_float2(v[0], v[1]);
  *reinterpret_cast<float2*>(r + 8 * DS) = make_float2(v[2], v[3]);
}
__device__ __forceinline__ FragA get_pair(const float* t, int j, int gq, int tq) {
  const float* r = t + gq * DS + 8 * j + 2 * tq;
  const float2 a = *reinterpret_cast<const float2*>(r), b = *reinterpret_cast<const float2*>(r + 8 * DS);
  return split_a(a.x, b.x, a.y, b.y);
}

// Stage the rows [row0, row0 + ROWS) of all d columns of src (rows, d)
// into a tile of row stride rs, part by part (zeros past d within the
// last part's staged width, and past `rows`).
template <int ROWS>
__device__ __forceinline__ void stage_whole(float* dst, int rs, const float* __restrict__ src, int d, int row0,
                                            int rows, bool vec16) {
  for (int c0 = 0; c0 < d; c0 += PART)
    stage<ROWS, WHOLE_THREADS>(dst + c0, rs, src, d, c0, staged(min(PART, d - c0)), row0, rows, vec16);
}

// ---- the forward

// The forward's routes where its cluster does not run, by the codes of
// hopfield_stream_fwd_plan: one pass (the walk), the scores split over
// groups first (split_scores), or S by the score pass in slabs of token
// tiles (4 and 5 are K2's and K3's codes).
enum FwdRoute { WALK = 2, SPLIT = 3, SLABS = 6 };

// K1's slabs past the split's cap: the most token tiles whose S (TM rows
// by m_patterns) fits SPLIT_BYTES, balanced, in s (no rounds: the score
// pass keeps every part in registers); and `per`, the pattern tiles a
// block of the score pass, the fewest runs of them that put two blocks an
// SM on a slab's grid where the tiles allow, balanced. false where one
// tile's S passes the cap (m_patterns past 262,144).
inline bool fwd_slab_plan(int n, int m_patterns, int sms, SlabPlan& s, int& per) {
  const long long units = (n + TM - 1) / TM, unit = static_cast<long long>(TM) * m_patterns;
  const long long most = std::min(units, SPLIT_BYTES / static_cast<long long>(sizeof(float)) / unit);
  if (most < 1) return false;
  const long long slabs = (units + most - 1) / most;
  s.slabs = static_cast<int>(slabs);
  s.slab = static_cast<int>((units + slabs - 1) / slabs);
  s.round = s.rounds = 0;
  s.floats = std::min<long long>(static_cast<long long>(s.slab) * TM, n) * m_patterns;
  const long long tiles = (m_patterns + TN - 1) / TN;
  const long long runs = std::min(tiles, (2ll * std::max(sms, 1) + s.slab - 1) / s.slab);
  per = static_cast<int>((tiles + runs - 1) / runs);
  return true;
}

// The forward's plan where its cluster does not run: the output window
// (d_out padded to 8 up to 128, else 128), the parts' order, and its
// route: where ceil(n / TM) blocks a window leave the card idle
// (split_pays), the split if it fits, else the slabs; else the walk.
struct FwdPlan {
  int cw;
  Order order;
  int route;
  SlabPlan slabs;  // SLABS: slabs of token tiles
  int per;         // SLABS: pattern tiles a block of the score pass
};
inline FwdPlan fwd_window_plan(int n, int m_patterns, int d_in, int d_out, int sms) {
  FwdPlan p{};
  p.cw = d_out <= 128 ? padded_width(d_out) : 128;
  p.order = score_order(d_in, d_out);
  p.route = WALK;
  const int groups = groups_of(d_in, p.order);
  const long long blocks = static_cast<long long>((n + TM - 1) / TM) * windows_of(d_out, p.cw);
  if (!split_pays(groups, blocks, sms)) return p;
  if (split_fits(n, m_patterns, groups)) p.route = SPLIT;
  else if (fwd_slab_plan(n, m_patterns, sms, p.slabs, p.per)) p.route = SLABS;
  return p;
}

// The score pass: S = q K^T of the block's TM token rows of q (n, d_in)
// and pattern tiles [blockIdx.y per, + per) into S (n, m_patterns). Each
// tile's part items (a part of the rows of q and of the tile of K) stream
// through the ring, as the walk of stream_fwd_narrow_kernel streams them;
// each part's product in a fresh sum, added in the order (group, trunc)
// in registers (add_part), then the tile's scores written. The same
// operations in the same order as the walk: the same bits.
__global__ void __launch_bounds__(THREADS)
slab_scores_kernel(const float* __restrict__ q, const float* __restrict__ K, float* __restrict__ S, int n,
                   int m_patterns, int d_in, int per, int group, int trunc, unsigned vec16) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * SLOT
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = blockIdx.x * TM;
  const int np = parts_of(d_in);
  const int t0 = blockIdx.y * per;
  const int items = (min((m_patterns + TN - 1) / TN, t0 + per) - t0) * np;
  const bool qv = vec16 & 1u, kv = vec16 >> 1 & 1u;

  auto stage_item = [&](int i) {
    if (i < items) {
      float* y = buf + (i % NB) * SLOT;
      const int it = t0 + i / np, c0 = i % np * PART, w = staged(min(PART, d_in - c0));
      stage<TM>(y, RP, q, d_in, c0, w, row0, n, qv);
      stage<TN>(y + TM * RP, RP, K, d_in, c0, w, it * TN, m_patterns, kv);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_item(i);

  float sc[NT][4], gs[NT][4], pp[NT][4];
  zero(sc);
  zero(gs);
  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    stage_item(i + NB - 1);
    const float* y = buf + (i % NB) * SLOT;
    const int sub = i % np;
    if (trunc) part_product<true>(pp, y + m0 * RP, y + TM * RP, part_steps(d_in, sub), gq, tq);
    else part_product<false>(pp, y + m0 * RP, y + TM * RP, part_steps(d_in, sub), gq, tq);
    add_part(sc, gs, pp, sub, group, np);
    if (sub < np - 1) continue;
    const int p_lo = (t0 + i / np) * TN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + m0 + gq + 8 * (e >> 1), col = p_lo + 8 * j + 2 * tq + (e & 1);
        if (row < n && col < m_patterns) S[static_cast<size_t>(row) * m_patterns + col] = sc[j][e];
      }
  }
}

// The narrow-side forward: out = softmax(beta q K^T) U / l for the block's
// TM token rows of the built q (n, d_in) and the window [col0, col0 + CW)
// of U. Per pattern tile: the parts of q and K (their columns below d_in),
// summed in the plan's order into the scores, or, where the scores were
// split, the tile of S; then the window of U (its live columns), the
// online softmax on the fragments (the denominator a compensated sum) and
// P U over the window's live n-tiles in fresh fragments, as the former window
// kernel, whose bits it keeps where its order is the window kernels'. The
// epilogue is MODE's (hopfield_wide.cuh; the first window writes m and l).
template <int CW, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
stream_fwd_narrow_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                         const float* __restrict__ S, const float* __restrict__ bias, float* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ zn_out, int n,
                         int m_patterns, int d_in, int d_out, float beta, float levels, int group, int trunc,
                         unsigned vec16) {
  constexpr int CO = CW / 8, RW = CW + 4;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * SLOT

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * CW;
  const int np = S ? 0 : parts_of(d_in);  // part items a tile
  const int per_tile = np + 1;
  const int items = (m_patterns + TN - 1) / TN * per_tile;
  const int u_cols = min(CW, d_out - col0);
  const int wu = staged(u_cols), co = (u_cols + 7) / 8;  // the window's staged columns and live n-tiles
  const bool qv = vec16 & 1u, kv = vec16 >> 1 & 1u, uv = vec16 >> 2 & 1u, sv = vec16 >> 3 & 1u;

  auto stage_item = [&](int i) {
    if (i < items) {
      float* y = buf + (i % NB) * SLOT;
      const int it = i / per_tile, sub = i - it * per_tile;
      if (sub < np) {
        const int c0 = sub * PART, w = staged(min(PART, d_in - c0));
        stage<TM>(y, RP, q, d_in, c0, w, row0, n, qv);
        stage<TN>(y + TM * RP, RP, K, d_in, c0, w, it * TN, m_patterns, kv);
      } else {
        if (S) stage<TM>(y, RSC, S, m_patterns, it * TN, TN, row0, n, sv);
        stage<TN>(y + (S ? TM * RSC : 0), RW, U, d_out, col0, wu, it * TN, m_patterns, uv);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_item(i);

  float m_r[2], l_r[2], l_lo[2], acc[CO][4], sc[NT][4], gs[NT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) m_r[e] = MASKED, l_r[e] = 0.f, l_lo[e] = 0.f;
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  zero(sc);
  zero(gs);

  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    stage_item(i + NB - 1);
    const float* y = buf + (i % NB) * SLOT;
    const int it = i / per_tile, sub = i - it * per_tile;
    if (sub < np) {
      float pp[NT][4];
      if (trunc) part_product<true>(pp, y + m0 * RP, y + TM * RP, part_steps(d_in, sub), gq, tq);
      else part_product<false>(pp, y + m0 * RP, y + TM * RP, part_steps(d_in, sub), gq, tq);
      add_part(sc, gs, pp, sub, group, np);
      continue;
    }
    const float* ut = y;
    if (S) {  // the tile's scores, rows gq and gq + 8 of the slab
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(y + (m0 + gq + 8 * r) * RSC + 8 * j + 2 * tq);
          sc[j][2 * r] = v.x;
          sc[j][2 * r + 1] = v.y;
        }
      ut = y + TM * RSC;
    }
    const int p_lo = it * TN;

    // ---- online softmax on the whole scores
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = p_lo + 8 * j + 2 * tq + (e & 1) < m_patterns ? sc[j][e] * beta : MASKED;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = __expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
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
    for (int r = 0; r < 2; ++r) {  // the compensated sum of hopfield_stream_fwd.cuh
      const float a = __fmul_rn(l_r[r], alpha[r]);
      const float b = __fadd_rn(__fmul_rn(l_lo[r], alpha[r]), rsum[r]);
      const float sum = __fadd_rn(a, b);
      const float bb = __fsub_rn(sum, a);
      l_lo[r] = __fadd_rn(__fsub_rn(a, __fsub_rn(sum, bb)), __fsub_rn(b, bb));
      l_r[r] = sum;
    }

    // ---- P U over the window's live n-tiles, into fresh fragments
    float o[CO][4];
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (p_lo + 8 * j >= m_patterns) continue;
      const FragA pa = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
      if (co == CO) {  // a whole window
#pragma unroll
        for (int c = 0; c < CO; ++c) mma3(o[c], pa, load_b_cols<RW>(ut + 8 * j * RW + 8 * c, gq, tq));
      } else {
#pragma unroll
        for (int c = 0; c < CO; ++c)
          if (c < co) mma3(o[c], pa, load_b_cols<RW>(ut + 8 * j * RW + 8 * c, gq, tq));
      }
    }
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += l_lo[r];
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + m0 + gq + 8 * e;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = col0 + 8 * c + 2 * tq + hh;
        if (col >= d_out) continue;
        const size_t at = static_cast<size_t>(row) * d_out + col;
        const float v = acc[c][2 * e + hh] / l_r[e];
        if constexpr (MODE == PLAIN) {
          out[at] = v;
        } else if constexpr (MODE == SHIFT) {
          out[at] = v + bias[col];
        } else {
          const float zq = rintf(1.f / (1.f + expf(-(v + bias[col]))) * levels);
          out[at] = zq;
          zn_out[at] = zq / levels;
        }
      }
    if (MODE == PLAIN && blockIdx.y == 0 && tq == 0) {
      m_out[row] = m_r[e];
      l_out[row] = l_r[e];
    }
  }
}

// f(std::integral_constant<int, CW>{}) for a window width of 8, 16, 32, 64 or 128.
template <typename F>
auto with_window(int cw, F&& f) {
  switch (cw) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

// Floats of scratch the wide forward needs past the built q: the split's
// or a slab's S, where its plan takes either route.
inline long long fwd_split_floats(int n, int m_patterns, int d_in, int d_out) {
  int j, ranks;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks)) return 0;
  const FwdPlan p = fwd_window_plan(n, m_patterns, d_in, d_out, sm_count());
  if (p.route == SPLIT) return split_floats(n, m_patterns, groups_of(d_in, p.order));
  return p.route == SLABS ? p.slabs.floats : 0;
}

// The wide forward over the built q (n, d_in), the route past 256: the
// cluster kernel where plan takes the widths, else the narrow-side
// kernel on its plan, through `work` (fwd_split_floats floats): the split
// scores (the groups' sums, then S), or slab after slab of token tiles
// the score pass into a slab's S, then the kernel on the slab's rows
// (every output row belongs to one slab). A refused launch returns its
// error.
template <int MODE>
cudaError_t launch_fwd(const float* q, const float* K, const float* U, const float* bias, float* out, float* m,
                       float* l, float* zn, float* work, int n, int m_patterns, int d_in, int d_out, float beta,
                       float levels, cudaStream_t stream) {
  int j, ranks;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks))
    return hopfield_cluster::launch_fwd_cluster<MODE>(q, K, U, bias, out, m, l, zn, n, m_patterns, d_in, d_out,
                                                      beta, levels, stream);
  const int sms = sm_count();
  const FwdPlan p = fwd_window_plan(n, m_patterns, d_in, d_out, sms);
  if (windows_of(d_out, p.cw) > 65535) return cudaErrorInvalidValue;
  // the kernel on rows [r0, r0 + rows), S (rows, m_patterns) their scores or null
  auto window = [&](const float* S, size_t r0, int rows) {
    return with_window(p.cw, [&](auto c) {
      constexpr int CW = decltype(c)::value;
      auto kernel = stream_fwd_narrow_kernel<CW, MODE>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(BYTES));
      if (err != cudaSuccess) return err;
      const float* qr = q + r0 * d_in;
      const unsigned vec16 = vec16_ok(qr, d_in) | vec16_ok(K, d_in) << 1 | vec16_ok(U, d_out) << 2 |
                             (S ? vec16_ok(S, m_patterns) : 0u) << 3;
      kernel<<<dim3((rows + TM - 1) / TM, windows_of(d_out, CW)), THREADS, BYTES, stream>>>(
          qr, K, U, S, bias, out + r0 * d_out, m ? m + r0 : m, l ? l + r0 : l, zn ? zn + r0 * d_out : zn, rows,
          m_patterns, d_in, d_out, beta, levels, p.order.group, p.order.trunc, vec16);
      return cudaGetLastError();
    });
  };
  if (p.route == SPLIT) {
    float* S = work + static_cast<size_t>(groups_of(d_in, p.order)) * n * m_patterns;
    const cudaError_t err = split_scores(q, K, S, work, n, m_patterns, d_in, p.order, sms, stream);
    return err != cudaSuccess ? err : window(S, 0, n);
  }
  if (p.route != SLABS) return window(nullptr, 0, n);
  cudaError_t err = cudaFuncSetAttribute(slab_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(BYTES));
  const int runs = ((m_patterns + TN - 1) / TN + p.per - 1) / p.per;
  const size_t step = static_cast<size_t>(p.slabs.slab) * TM;
  for (size_t r0 = 0; r0 < static_cast<size_t>(n) && err == cudaSuccess; r0 += step) {
    const int rows = static_cast<int>(std::min(step, n - r0));
    const float* qr = q + r0 * d_in;
    slab_scores_kernel<<<dim3((rows + TM - 1) / TM, runs), THREADS, BYTES, stream>>>(
        qr, K, work, rows, m_patterns, d_in, p.per, p.order.group, p.order.trunc,
        vec16_ok(qr, d_in) | vec16_ok(K, d_in) << 1);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = window(work, r0, rows);
  }
  return err;
}

// The forward's narrow-side kernel (MODE's instance) for a window of d_out
// as the card reports it: tf32x3::kernel_attributes into out[0..6].
template <int MODE>
cudaError_t fwd_window_attributes(int d_out, int* out) {
  return with_window(d_out <= 128 ? padded_width(d_out) : 128, [&](auto c) {
    return kernel_attributes(stream_fwd_narrow_kernel<decltype(c)::value, MODE>, THREADS, BYTES, TM, TN, out);
  });
}

}  // namespace hopfield_narrow
