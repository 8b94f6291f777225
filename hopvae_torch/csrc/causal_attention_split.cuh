// The causal scores of K5's window kernels (head widths past 8192, where a
// cluster would need more than 16 blocks), computed once and split over
// the card: the forward's S = q k^T (causal_attention_fwd.cu) and the
// backward's S and dP = g v^T (causal_attention_bwd.cu; K5-dkv's as
// S^T = k q^T and dP^T = v g^T, its keys resident). dP on (g, v) is the
// same chunk product that S is on (q, k).
//
// A unit is one tile of TM resident rows of one (batch, head): query rows
// in K5-fwd and K5-dq, keys in K5-dkv, numbered tile-major (u = tile *
// B heads + bh). A slab is a run of units whose scratch fits SPLIT_BYTES:
//
//   sums  [products][slab's units][TM][S]             (S, then dP)
//   parts [products][round's chunks][slab's units][TM][S]
//
// For each round of depth chunks of 64, a first pass computes each chunk
// of every causal (resident tile, streamed tile) pair of the slab in a
// fresh sum, chunks in groups on a grid sized to the card; a second adds
// the round's chunks in chunk order into the sums (the first round starts
// from chunk 0's part), writing 0 where a row lies past S or the streamed
// tile past the diagonal for the row's 16-row slab. So every entry is the
// chunks' sum in chunk order whatever the slabs and rounds (re-reading an
// f32 from memory changes no bit). The window kernel of each .cu then
// reads the slab's sums. Every output row belongs to one unit, so a slab
// finishes its rows: no sums carry across launches, and no float atomics.
//
// The plan (split_plan): slabs of the most units whose parts of every chunk
// and sums fit, balanced; where one unit's do not, slabs of one unit and
// rounds of the most chunks that fit, balanced. Past that (one unit's sums
// and one chunk's parts do not fit: S past 131,072 in the forward, past
// 65,536 in the backward) the shape is refused.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "causal_attention.cuh"

namespace causal_split {

using causal_attention::load_a;
using causal_attention::load_b_rows2;
using causal_attention::stage;
using causal_attention::Strides;
using tf32x3::FragA;
using tf32x3::FragB;

constexpr int TM = 64;                // resident rows of a unit, a warp a 16-row slab
constexpr int TN = 32;                // streamed rows of a tile
constexpr int NT = TN / 8;            // n-tiles of a 16 x TN score slab
constexpr int DC = 64;                // depth of a chunk
constexpr int THREADS = 32 * TM / 16;
constexpr int RC = DC + 4;            // row stride of a staged chunk
constexpr int RSC = TN + 4;           // row stride of a staged tile of the sums
constexpr size_t PART_BYTES = sizeof(float) * 2 * (TM + TN) * RC;  // two buffers of a chunk of each operand
constexpr long long SPLIT_BYTES = 64ll << 20;  // the scratch at most

// One product a * b^T over the depth: a's rows resident, b's streamed;
// vec16 bit 0 for a, bit 1 for b (16-byte copies).
struct Product {
  const float* a;
  const float* b;
  Strides as, bs;
  unsigned vec16;
};

struct Plan {
  int slab;          // units of a slab (the last may hold fewer)
  int slabs;
  int round;         // chunks of a round (the last may hold fewer)
  int rounds;
  long long floats;  // the scratch
};

// The plan of (b, s, h, d) for `products` products; false where one unit's
// sums and one chunk's parts pass the cap.
inline bool split_plan(int b, int s, int h, int d, int products, Plan& p) {
  if (b <= 0 || s <= 0 || h <= 0 || d <= 0 || d % DC != 0) return false;
  const long long units = static_cast<long long>(b) * h * ((s + TM - 1) / TM);
  if (units > 0x7fffffffLL) return false;
  const long long unit = static_cast<long long>(products) * TM * s;  // floats of one unit's sums
  const long long cap = SPLIT_BYTES / static_cast<long long>(sizeof(float));
  const int chunks = d / DC;
  long long per = cap / ((chunks + 1) * unit);  // units whose every chunk and sums fit
  long long round = chunks;
  if (per < 1) {
    per = 1;
    round = cap / unit - 1;
    if (round < 1) return false;
  }
  const long long slabs = (units + per - 1) / per;
  const long long rounds = (chunks + round - 1) / round;
  p.slabs = static_cast<int>(slabs);
  p.slab = static_cast<int>((units + slabs - 1) / slabs);
  p.rounds = static_cast<int>(rounds);
  p.round = static_cast<int>((chunks + rounds - 1) / rounds);
  p.floats = (p.round + 1ll) * p.slab * unit;
  return true;
}

// A chunk item's part of a slab's 16 x TN products (TM resident rows at y,
// the TN streamed rows after them, row stride RC) in a fresh sum.
__device__ __forceinline__ void chunk_scores(float (&part)[NT][4], const float* y, int m0, int gq, int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DC / 8; ++c) {
    const FragA qa = load_a<RC>(y + m0 * RC + 8 * c, gq, tq);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      FragB b0, b1;
      load_b_rows2<RC>(b0, b1, y + TM * RC + 8 * j * RC + 8 * c, gq, tq);
      tf32x3::mma3(part[j], qa, b0);
      tf32x3::mma3(part[j + 1], qa, b1);
    }
  }
}

// The unit of the slab's block x: the longest walks first (DOWN: streamed
// tiles from the resident tile's diagonal to the end, the first tiles
// longest; else up to the diagonal, the last longest).
template <bool DOWN>
__device__ __forceinline__ int slab_unit(int units) {
  return DOWN ? blockIdx.x : units - 1 - blockIdx.x;
}

// A warp's 16-row slab from slab_lo skips streamed tile n_lo: no pair of
// the tile is causal (DOWN: every key of the slab exceeds every query row
// of the tile; else the reverse), or the slab lies past S.
template <bool DOWN>
__device__ __forceinline__ bool slab_skips(int slab_lo, int n_lo, int s) {
  return slab_lo >= s || (DOWN ? slab_lo > n_lo + TN - 1 : n_lo > slab_lo + 15);
}

// The first pass: product z (grid z) of each chunk of the block's group of
// `group` chunks of the round [c0, c0 + round) (grid y), for every causal
// streamed tile of the block's unit (grid x, of `units` from u0), into
// parts. Chunk after chunk, each chunk's tiles in order.
template <bool DOWN>
__global__ void __launch_bounds__(THREADS)
split_parts_kernel(Product p0, Product p1, float* __restrict__ parts, int s, int h, int bhs, int u0, int units,
                   int c0, int round, int group) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * (TM + TN) * RC
  const Product pr = blockIdx.z ? p1 : p0;

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int ul = slab_unit<DOWN>(units);
  const int u = u0 + ul, mt = u / bhs, bh = u - mt * bhs;
  const int b = bh / h, hh = bh - b * h;
  const int row_m0 = mt * TM;
  const int slab_lo = row_m0 + m0;
  const int first = DOWN ? row_m0 / TN : 0;
  const int tiles = (DOWN ? (s - 1) / TN : (min(row_m0 + TM, s) - 1) / TN) - first + 1;
  const int cg = c0 + blockIdx.y * group;
  const int items = min(group, c0 + round - cg) * tiles;
  const size_t plane = static_cast<size_t>(units) * TM * s;  // floats of one chunk's parts
  float* out0 = parts + static_cast<size_t>(blockIdx.z) * round * plane + static_cast<size_t>(ul) * TM * s;
  const bool va = pr.vec16 & 1u, vb = pr.vec16 >> 1 & 1u;

  auto stage_item = [&](int i, int u) {
    float* y = buf + u * (TM + TN) * RC;
    const int c = cg + i / tiles, it = first + i % tiles;
    stage<DC, TM, THREADS>(y, pr.a + c * DC, pr.as, b, hh, row_m0, s, va);
    stage<DC, TN, THREADS>(y + TM * RC, pr.b + c * DC, pr.bs, b, hh, it * TN, s, vb);
    tf32x3::cp_async_commit();
  };
  stage_item(0, 0);
  for (int i = 0; i < items; ++i) {
    const int u = i & 1;
    tf32x3::cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    if (i + 1 < items) stage_item(i + 1, u ^ 1);
    const float* y = buf + u * (TM + TN) * RC;
    const int c = cg + i / tiles, n_lo = (first + i % tiles) * TN;
    if (slab_skips<DOWN>(slab_lo, n_lo, s)) continue;
    float part[NT][4];
    chunk_scores(part, y, m0, gq, tq);
    float* out = out0 + static_cast<size_t>(c - c0) * plane;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + gq + 8 * (e >> 1), n = n_lo + 8 * j + 2 * tq + (e & 1);
        if (row_m0 + r < s && n < s) out[static_cast<size_t>(r) * s + n] = part[j][e];
      }
  }
}

// The second pass: the round's chunks added in chunk order into the sums
// (`first`: the first round, which starts from chunk 0's part); 0 where the
// first pass skips an entry's tile or its row lies past S, so no read of
// the sums or the parts meets memory that nothing wrote.
template <bool DOWN>
__global__ void split_sum_kernel(const float* __restrict__ parts, float* __restrict__ sums, int round, bool first,
                                 long long count, int products, int s, int bhs, int u0) {
  const long long unit = static_cast<long long>(TM) * s;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < products * count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = i / count, j = i - p * count, ul = j / unit, at = j - ul * unit;
    const int r = static_cast<int>(at / s), n = static_cast<int>(at - static_cast<long long>(r) * s);
    const int row = static_cast<int>((u0 + ul) / bhs) * TM + r;
    if (row >= s || (DOWN ? row / 16 * 16 > n / TN * TN + TN - 1 : n / TN * TN > row / 16 * 16 + 15)) {
      sums[i] = 0.f;
      continue;
    }
    const float* pp = parts + p * round * count + j;
    float t = first ? pp[0] : sums[i] + pp[0];
    for (int c = 1; c < round; ++c) t += pp[c * count];
    sums[i] = t;
  }
}

inline int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 1;
  return sms > 0 ? sms : 1;
}

// The sums of the slab of `units` units from u0 (of b h = bhs heads) into
// work (then the parts), round after round; `products` is 1 (p0) or 2.
template <bool DOWN>
cudaError_t split_slab(const Product& p0, const Product& p1, int products, const Plan& plan, float* work, int s,
                       int h, int bhs, int d, int u0, int units, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(split_parts_kernel<DOWN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(PART_BYTES));
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(units) * TM * s;
  float* parts = work + products * count;
  const int chunks = d / DC, sms = sm_count();
  for (int c0 = 0; c0 < chunks; c0 += plan.round) {
    const int round = std::min(plan.round, chunks - c0);
    const long long items = static_cast<long long>(units) * products * round;
    const int group = static_cast<int>(std::min<long long>(round, std::max<long long>(1, items / (3ll * sms))));
    split_parts_kernel<DOWN><<<dim3(units, (round + group - 1) / group, products), THREADS, PART_BYTES, stream>>>(
        p0, p1, parts, s, h, bhs, u0, units, c0, round, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr int T = 256;
    const long long total = products * count;
    split_sum_kernel<DOWN><<<static_cast<int>(std::min<long long>((total + T - 1) / T, 8ll * sms)), T, 0, stream>>>(
        parts, work, round, c0 == 0, count, products, s, bhs, u0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Stage the TM x TN tile of a unit's sums at `sums` (row stride S) for
// streamed tile `it` into shared memory (rows RSC apart), zeros past S.
__device__ __forceinline__ void stage_sums(float* dst, const float* __restrict__ sums, int it, int s) {
  for (int e = threadIdx.x; e < TM * TN; e += THREADS) {
    const int r = e / TN, c = e - r * TN;
    const bool in = it * TN + c < s;
    tf32x3::cp_async4(dst + r * RSC + c, in ? sums + static_cast<size_t>(r) * s + it * TN + c : sums, in);
  }
}

// The C fragments of a warp's 16 x TN slab (rows m0..) of a staged tile of
// the sums: element e of n-tile j is row m0 + gq + 8 (e >> 1), column
// 8j + 2tq + (e & 1).
__device__ __forceinline__ void load_sums(float (&sc)[NT][4], const float* y, int m0, int gq, int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 t = *reinterpret_cast<const float2*>(y + (m0 + gq + 8 * r) * RSC + 8 * j + 2 * tq);
      sc[j][2 * r] = t.x;
      sc[j][2 * r + 1] = t.y;
    }
}

}  // namespace causal_split
