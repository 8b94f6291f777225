// The pattern walk of a streaming Hopfield lookup on Hopper's tensor
// cores, shared by the forward K1 (hopfield_stream_fwd.cu) and the fused
// bottleneck forward K4 (hopfield_bottleneck_fused.cu), which runs it once
// for each of its three lookups.
//
// A block of 4 warps holds the queries q of 64 token rows (TM) in shared
// memory, a warp a 16-row slab, and walks the pattern tiles of TN: each K
// tile and the tile's window of U arrive by double-buffered cp.async. Per
// tile a warp computes its 16 x TN scores q K^T as C fragments, runs the
// online softmax on them (a row lives in the 4 lanes of a quad: its max is
// two xor shuffles; each lane keeps its part of the denominator), and adds
// P U, with P kept in registers as the A operand through the permuted k
// (mma_tf32.cuh, load_b_cols). Every product is mma.sync m16n8k8 on TF32
// operands in three passes (f32 grade: K2 and K3 rebuild the attention
// from the row stats this walk gives). P U of each tile is summed in fresh
// fragments, then added to the rescaled running output: the tensor cores'
// sums truncate, and short chains keep that error small. The denominator
// is carried as a compensated sum (its rounding error kept beside it, both
// rescaled together): a plain running sum over 64 tiles leaves about 4e-7
// of relative error in l, which K2's and K3's rebuilt attention rows then
// carry; compensated, about 1e-7, as a single f32 sum of the row
// (tests/test_torch_hopfield_tf32.py).
//
// q is fixed for the whole walk: up to a width of 64 each of its A
// fragments is split into its TF32 parts once, into registers (at most 64
// a thread); wider, each is loaded and split where it is used, as K2 and
// K5-fwd do. Splitting it once into shared memory would double q's bytes,
// and K4 at width 256 holds two query tiles and the K and U buffers in
// 200 KB already.
//
// A walk computes a window of CW <= 128 output columns: at d_out 256 the
// callers run two windows (K1 as blocks of their own, K4 one after the
// other), each of which recomputes the scores, so that a thread holds at
// most 64 accumulators and 64 fresh sums.

#pragma once

#include "hopfield_stream.cuh"

namespace hopfield_fwd {

using namespace hopfield_stream;
using namespace tf32x3;

constexpr int TM = 64;                // token rows of a block
constexpr int THREADS = 32 * TM / 16; // a warp a 16-row slab

// the output columns of one walk for a padded output width
template <int PO>
__host__ __device__ constexpr int window() { return PO > 128 ? 128 : PO; }

template <int PI, int CW>
struct Walk {
  // patterns of a streamed tile: 64 up to widths of 64 (half the barriers
  // and softmax rounds a pattern of 32-pattern tiles, as in K5-fwd); 32
  // above; 16 where q K^T and the window sum past 256 (shared memory)
  static constexpr int TN = (PI <= 64 && CW <= 64) ? 64 : (PI + CW <= 256 ? 32 : 16);
  static constexpr int NT = TN / 8;  // n-tiles of a warp's 16 x TN scores
  static constexpr int QS = PI + 4;  // q rows and K rows in shared memory
  static constexpr int US = CW + 4;  // rows of U's window
  static constexpr int CT = PI / 8;  // k-steps of q K^T
  static constexpr int CO = CW / 8;  // n-tiles of the output window
  static constexpr bool Q_REGS = PI <= 64;
  static constexpr int BUF = TN * (QS + US);  // floats of one buffer: a K tile and its U window
  static_assert(NT % 2 == 0 && CW <= 128, "tiles");
};

// The walk of the block's TM queries (q_s, row stride PI + 4) over every
// pattern tile of K (m_patterns, d_in) against the columns
// [col0, col0 + CW) of U (m_patterns, d_out), streamed through buf (two
// buffers of Walk::BUF floats). Out: for the warp's rows gq and gq + 8,
// the running max m_r of the scaled scores, the lane's part of the
// denominator l_r (the caller sums it over the quad), and the unnormalized
// output acc over columns col0 + 8c + 2tq and + 1 (c < CO; columns past
// d_out read 0). Patterns past M are masked here. Every thread of the
// block calls it, after a barrier that makes q_s visible; it ends with a
// barrier, after which buf and q_s may be written.
template <int PI, int CW>
__device__ __forceinline__ void walk(const float* q_s, float* buf, const float* __restrict__ K,
                                     const float* __restrict__ U, int m_patterns, int d_in, int d_out, int col0,
                                     float beta, bool k16, bool u16,
                                     float (&acc)[Walk<PI, CW>::CO][4], float (&m_r)[2], float (&l_r)[2]) {
  using W = Walk<PI, CW>;
  constexpr int TN = W::TN, NT = W::NT, QS = W::QS, US = W::US, CT = W::CT, CO = W::CO;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's slab
  const int u_cols = min(CW, d_out - col0);
  const int last = (m_patterns + TN - 1) / TN - 1;

  auto stage_tile = [&](int it, int u) {
    float* kt = buf + u * W::BUF;
    stage_async<PI, TN, THREADS>(kt, K, d_in, it * TN, m_patterns, k16);
    stage_async<CW, TN, THREADS>(kt + TN * QS, U + col0, u_cols, it * TN, m_patterns, u16, d_out);
    cp_async_commit();
  };
  stage_tile(0, 0);

  FragA qf[W::Q_REGS ? CT : 1];
  if constexpr (W::Q_REGS) {
#pragma unroll
    for (int c = 0; c < CT; ++c) qf[c] = load_a<QS>(q_s + m0 * QS + 8 * c, gq, tq);
  }
  float l_lo[2];  // the rounding error of l_r: l_r + l_lo is the lane's denominator
#pragma unroll
  for (int e = 0; e < 2; ++e) m_r[e] = MASKED, l_r[e] = 0.f, l_lo[e] = 0.f;
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = 0; it <= last; ++it) {
    const int u = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_tile(it + 1, u ^ 1);
    const float* kt = buf + u * W::BUF;
    const float* ut = kt + TN * QS;
    const int p_lo = it * TN;

    // ---- the slab's 16 x TN scores q K^T, C layout
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (W::Q_REGS) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB b0, b1;
          load_b_rows2<QS>(b0, b1, kt + 8 * j * QS + 8 * c, gq, tq);
          mma3(sc[j], qf[c], b0);
          mma3(sc[j + 1], qf[c], b1);
        }
    } else {
#pragma unroll 2
      for (int c = 0; c < CT; ++c) {
        const FragA qa = load_a<QS>(q_s + m0 * QS + 8 * c, gq, tq);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB b0, b1;
          load_b_rows2<QS>(b0, b1, kt + 8 * j * QS + 8 * c, gq, tq);
          mma3(sc[j], qa, b0);
          mma3(sc[j + 1], qa, b1);
        }
      }
    }

    // ---- online softmax: element e of n-tile j is row gq + 8 (e >> 1),
    // pattern p_lo + 8j + 2tq + (e & 1)
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
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = __expf(m_r[i] - mx[i]);  // 0 on the first tile: every tile holds a pattern
      m_r[i] = mx[i];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[j][e] - mx[e >> 1]);  // 0 where masked
        sc[j][e] = p;
        rsum[e >> 1] += p;
      }
    // (l_r + l_lo) alpha + rsum as a compensated sum: a + b by TwoSum,
    // with _rn intrinsics, which the compiler neither fuses nor reorders
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a = __fmul_rn(l_r[i], alpha[i]);
      const float b = __fadd_rn(__fmul_rn(l_lo[i], alpha[i]), rsum[i]);
      const float sum = __fadd_rn(a, b);
      const float bb = __fsub_rn(sum, a);
      l_lo[i] = __fadd_rn(__fsub_rn(a, __fsub_rn(sum, bb)), __fsub_rn(b, bb));
      l_r[i] = sum;
    }

    // ---- P U over the tile's patterns 8j .. 8j + 7 in order, into fresh
    // fragments, then acc = alpha acc + P U
    float o[CO][4];
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (p_lo + 8 * j >= m_patterns) continue;  // P = 0 past M
      const FragA pa = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
#pragma unroll
      for (int c = 0; c < CO; ++c) mma3(o[c], pa, load_b_cols<US>(ut + 8 * j * US + 8 * c, gq, tq));
    }
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] += l_lo[i];
  __syncthreads();  // every warp is done with the last tile and with q_s
}

// l_r summed over the quad of lanes that shares a row: every lane ends
// with the same sum (each step adds the same two operands, and float
// addition commutes)
__device__ __forceinline__ void quad_denominators(float (&l_r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(FULL, l_r[i], 2);
  }
}

// q = LN(x) * s + t of the block's TM rows from row0 of x (n, d_in) into
// q_s (row stride PI + 4, zeros past d_in and n), by cp.async, then the
// state LayerNorm in double over the real width; ends with a barrier.
template <int PI>
__device__ __forceinline__ void load_queries(float* q_s, const float* __restrict__ x, const float* __restrict__ s,
                                             const float* __restrict__ t, int d_in, int row0, int n, bool x16) {
  stage_async<PI, TM, THREADS>(q_s, x, d_in, row0, n, x16);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  layer_norm_rows<TM, PI + 4, THREADS>(q_s, d_in, s, t);
  __syncthreads();
}

}  // namespace hopfield_fwd
