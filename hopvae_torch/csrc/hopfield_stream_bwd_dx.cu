// Streaming modern-Hopfield lookup, backward for the token side (K2), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_stream_bwd_dx_kernel` (with `_recompute_attn`)
// of hopvae_tpu/ops/hopfield_pallas.py, launched in `_attn_ln_stream_bwd`.
// With the forward's q = LN(x) * s + t, scores beta * q K^T, row stats m
// and l, the cotangent g (N, d_out) of out and delta = rowsum(g * out)
// (computed by the caller), it rebuilds each attention tile and computes
//
//     A   = exp(beta * q K^T - m) / l
//     dS  = A * (g U^T - delta) * beta
//     dq  = dS K                                  (N, d_in)
//     dx  = inv * (dq*s - mean(dq*s) - xhat * mean(dq*s * xhat))
//     ds  = sum over tokens of dq * xhat,   dt = sum over tokens of dq
//
// where xhat = (x - mean) * inv is the normalized input. The (N, M)
// attention never reaches device memory.
//
// What bounds it on an H100: the tensor cores. It does three products,
// 2*N*M*(2*d_in + d_out) FLOPs (q K^T, g U^T, dS K), each as mma.sync
// m16n8k8 on TF32 operands in three passes (mma_tf32.cuh), so the ceiling
// is 495 / 3 = 165 TFLOP/s: at N = 73,984, M = 4096, d_in = d_out = 64,
// 0.71 ms, against N*M exps (under 0.1 ms on the SFUs) and about 40 MB of
// memory traffic. One TF32 pass would move dx by about 1e-3 normwise,
// past the 5e-5 the port holds it to; three passes land where f32 does
// (tests/test_torch_hopfield_tf32.py emulates both). A is rebuilt with
// scores from these products, not K1's FMA sums: the two differ by about
// 1e-7 relative, which moves A by about 1e-6.
//
// Design (after K5-dq, causal_attention_bwd.cu):
// - Widths: any d_in, d_out from 1 to 256. A width is padded with zeros in
//   shared memory (never in device memory) to the instance built for it
//   (hopfield_stream.cuh, with_widths: 8 to 128 each side; 256 with 8 or
//   256); the LayerNorm's mean and variance, and beta = 1/sqrt(d_in), use
//   the real width.
// - One block of 4 warps owns 64 token rows (TM), a warp a 16-row slab.
//   q (the state LayerNorm in double, over the real width, rounded once:
//   hopfield_stream.cuh) and g stay in shared memory for the whole walk
//   over the pattern tiles of 32 (TN; 16 where d_in' + d_out' pass 256,
//   for shared memory), whose K and U arrive by
//   double-buffered cp.async (16-byte copies where the base and width
//   allow, 4-byte where not). Patterns past M and rows past N are masked
//   to A = 0 here; the caller pads nothing.
// - The warp's q K^T and g U^T come out as C fragments; A and dS are
//   computed on them in registers. dS then becomes the A operand of
//   dq += dS K through the permuted k (C's (c0, c2, c1, c3)), with the K
//   tile as the B operand: no trip through shared memory.
// - dq is summed over each pattern tile one n-tile at a time in a fresh
//   fragment, added to the running sum after the tile: the tensor cores'
//   sums truncate, and a chain over all 4096 patterns would carry that
//   error far past a tile's 12 mma. One n-tile at a time needs 4 fresh
//   registers where a whole fresh row would need d_in / 2.
// - At d_in 256 a warp's dq would take 128 accumulators: two blocks share
//   the token rows, each summing half of dq's columns and each computing
//   the scores in full.
// - Few token blocks (the MNIST batch, a ragged call) leave SMs idle, and
//   a last wave of blocks that is mostly empty idles them at the end, so
//   the pattern axis is split where that ends the waves sooner, from the
//   blocks an SM the card reports for the instance (plan_for): each split
//   writes its partial dq, and a second kernel sums the splits in a fixed
//   order and runs the LayerNorm backward in double (4 lanes a row),
//   writing dx and per-block partial rows of ds and dt, which a third
//   pass sums in order. No float atomics: every output has the same bits
//   in every run.
//
//   Shared bytes: 4 (64 + 2 TN) (d_in' + d_out' + 8) for padded widths
//   d_in', d_out' (q, g, two buffers of K and U): 69,632 at 64 -> 64,
//   199,680 at 256 -> 256. Registers and
//   blocks an SM per width are in PERF.md, from
//   hopfield_stream_bwd_dx_attributes on the card.
// - Past 256 on either side q is built first into the scratch
//   (hopfield_wide.cuh). Up to 8192 on the wider side, with d_in and
//   d_out past 128, dq runs on a thread-block cluster
//   (hopfield_cluster.cuh): the depth split across the blocks of a
//   cluster, each tile's scores computed once, every output column summed
//   by the block whose slice holds it (at 512 -> 512, N 4,096, M 512 on an
//   H100: 0.47 ms against the former window kernel's 0.80; PERF.md).
//   Where d_in passes 256 with d_out up to 8, or 64 at a d_in up to 320,
//   the whole window (stream_bwd_dq_whole_kernel, hopfield_narrow.cuh):
//   one block's 64 token rows by all of d_in, each score computed once in
//   registers (at (384, 3) on an H100: N 4,096, 0.182 ms against the
//   cluster's 0.365 and the split scores' 0.243; N 73,984, 16.7 against
//   36.5 to 37.1 and 25.1 to 25.5; PERF.md). Elsewhere (d_in up to 128,
//   d_out up to 128, or a side past 8192) the narrow-side kernel
//   (stream_bwd_dq_narrow_kernel, on the pieces of hopfield_narrow.cuh),
//   which replaces the window kernel there and keeps its order where d_in
//   is at most 128 or past 8192, else sums the score parts in the
//   cluster's order (score_order), as K1 did: dq's window is a template width, d_in
//   padded to 8 up to 128 (one window: nothing is recomputed), else 128 on
//   a grid axis; per group of pattern tiles the parts of q and K, then of
//   g and U, stream through, their k-steps and copies below the widths
//   only, each part's products in a fresh sum added to each tile's in
//   order; then the group's windows of K. A group is 4 tiles where
//   nothing is split, the order is the window kernels' and the window is
//   at most 32 columns (GROUP): each
//   part of q and g is staged once for the 4 tiles, where a tile at a time
//   restaged all of g's parts for every 32 patterns (at (3, 384) on an
//   H100: N 4,096, 0.083 ms against 0.098 a tile at a time and the window
//   kernel's 0.112; N 73,984, 7.53 against 8.41 and 12.28; two tiles a
//   group 0.086 and 8.03; PERF.md). Its 128 score and g U^T fragments
//   take 255 registers with 96 bytes of spill at a window of 8. At
//   windows of 64 and 128 a group is 2 tiles (WIDE_GROUP; 235 and 254
//   registers, no spill): on an H100 at (64, 384), N 4,096 0.102 to
//   0.105 ms against 0.114 to 0.116 a tile at a time and the window
//   kernel's 0.108 to 0.111; at (8320, 3), N 4,096, M 64 (the scores
//   recomputed in each of 65 windows) 9.63 against 11.06 to 11.11 and
//   10.40 to 10.46.
//   Where dq has more than one window, S = q K^T is split over the card
//   once (hopfield_narrow::split_scores: each part apart, then added in
//   order, the same bits) and every window reads it instead of
//   recomputing it, and so is P = g U^T, which is also split where the
//   blocks leave the card idle (a route by plan: dx_window_plan,
//   hopfield_stream_bwd_dx_plan). The split runs slab after slab of token
//   tiles within SPLIT_BYTES of scratch (hopfield_narrow::slab_plan), in
//   rounds of parts where a slab's parts pass it, each slab's window
//   kernel after its split: at (8320, 3), N 4,096, M 64 the parts' sums
//   take 137 MB, where every window recomputed the scores; in 3 slabs of
//   22 tiles the call took 1.55 ms against 9.49 to 9.61 on an H100, the
//   split passes 0.24 and the window kernel 0.36 of it (PERF.md). Only where one token tile's sums and one part pass the
//   cap (M past 87,381 with both products, 131,072 with one) do the
//   windows compute the products themselves. At d_in up to 128 the cluster ran
//   slower (at (3, 384): 0.268 ms against the former window kernel's
//   0.113), and at d_out up to 128 too, so the route is by width. The
//   splits of the pattern axis plan
//   from the clusters the card holds at once, or on the narrow-side kernel
//   from two blocks an SM (PLAN_PER_SM), the window kernel's, whatever the
//   narrow kernel's occupancy: they fix the order of dq's sums, so dx, ds
//   and dt keep the window kernel's bits. The finishing pass, a warp a
//   row, reads x and the splits' dq from device memory, keeps dq in q's
//   scratch and dq * xhat over split 0's partial for the column sums (with
//   4 lanes a row it took 0.26 ms of 0.71 at 512 -> 512, N 4,096; a warp a
//   row 0.034).

#include <algorithm>

#include "hopfield_cluster.cuh"
#include "hopfield_narrow.cuh"
#include "hopfield_stream.cuh"
#include "hopfield_wide.cuh"

namespace {

using namespace hopfield_stream;
using namespace tf32x3;

constexpr int TM = 64;             // token rows of a block
constexpr int THREADS = 32 * TM / 16;
constexpr int FIN_ROWS = 32;       // token rows of a block of the finishing pass
constexpr int FIN_THREADS = 4 * FIN_ROWS;

template <int PI, int PO>
struct Tiles {
  static constexpr int TN = PI + PO > 256 ? 16 : 32;  // patterns of a streamed tile
  static constexpr int NT = TN / 8;                     // n-tiles of a warp's 16 x TN scores
  static constexpr int PARTS = PI > 128 ? 2 : 1;        // blocks that share the token rows, a part of dq each
  static constexpr int CTP = PI / 8 / PARTS;            // a block's n-tiles of dq
  static constexpr int QS = PI + 4;  // q rows and K rows in shared memory
  static constexpr int GS = PO + 4;  // g rows and U rows
  static constexpr int BUF = TN * (QS + GS);  // one buffer of a K and a U tile
  static constexpr size_t BYTES = sizeof(float) * (TM * (QS + GS) + 2 * BUF);
};

// The pattern axis in `splits` runs of `per` tiles (the last may be short).
struct Plan {
  int splits, per;
};

// The splits of the pattern axis whose waves of blocks end soonest: s
// splits take ceil(T s / C) waves of blocks 1/s as long, for T blocks (of
// tokens, times the column parts) and C blocks the card runs at once. At
// N = 73,984 (T = 1156) and C = 264, two splits take 4.5 block-times where
// one takes 5; below a wave (MNIST, ragged calls) the splits fill the
// card. The fewest splits win a tie; every split holds a tile at least.
Plan plan_for(int blocks, int tiles, int concurrent) {
  const int c = concurrent > 0 ? concurrent : 1;
  int limit = (4 * c + blocks - 1) / blocks;
  limit = limit > 4 ? limit : 4;
  limit = limit < tiles ? limit : tiles;
  int best = 1;
  long long best_waves = (blocks + c - 1) / c;
  for (int s = 2; s <= limit; ++s) {
    const long long waves = (static_cast<long long>(blocks) * s + c - 1) / c;
    if (waves * best < best_waves * s) best = s, best_waves = waves;
  }
  const int per = (tiles + best - 1) / best;
  return {(tiles + per - 1) / per, per};
}

template <int PI, int PO>
__global__ void __launch_bounds__(THREADS, 2)
stream_bwd_dq_kernel(const float* __restrict__ x, const float* __restrict__ K, const float* __restrict__ U,
                     const float* __restrict__ s, const float* __restrict__ t, const float* __restrict__ g,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta, float* __restrict__ dq_part, int n, int m_patterns,
                     int d_in, int d_out, int per, float beta, unsigned vec16) {
  using C = Tiles<PI, PO>;
  constexpr int QS = C::QS, GS = C::GS, TN = C::TN, NT = C::NT, CTP = C::CTP;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + TM * QS;
  float* str = g_s + TM * GS;  // buffer u: K tile at str + u * BUF, its U tile TN * QS after

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's slab in the block's rows
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * CTP;  // the block's first n-tile of dq
  const int first = split * per;
  const int last = min((m_patterns + TN - 1) / TN, first + per) - 1;

  stage_async<PI, TM, THREADS>(q_s, x, d_in, row0, n, vec16 & 1u);
  stage_async<PO, TM, THREADS>(g_s, g, d_out, row0, n, vec16 >> 1 & 1u);
  cp_async_commit();
  auto stage_tile = [&](int it, int u) {
    float* kt = str + u * C::BUF;
    stage_async<PI, TN, THREADS>(kt, K, d_in, it * TN, m_patterns, vec16 >> 2 & 1u);
    stage_async<PO, TN, THREADS>(kt + TN * QS, U, d_out, it * TN, m_patterns, vec16 >> 3 & 1u);
    cp_async_commit();
  };
  stage_tile(first, 0);

  // m, 1/l and delta of the warp's rows gq and gq + 8
  bool live[2];
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + m0 + gq + 8 * e;
    live[e] = row < n;
    m_r[e] = live[e] ? m_in[row] : 0.f;
    il_r[e] = live[e] ? 1.f / l_in[row] : 0.f;
    dl_r[e] = live[e] ? delta[row] : 0.f;
  }

  cp_async_wait_prior();  // x and g have landed; the first K, U tile may not have
  __syncthreads();
  layer_norm_rows<TM, QS, THREADS>(q_s, d_in, s, t);
  // the first tile's barrier orders these writes before any read

  float acc[CTP][4];
#pragma unroll
  for (int c = 0; c < CTP; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_tile(it + 1, u ^ 1);
    const float* kt = str + u * C::BUF;
    const float* ut = kt + TN * QS;
    const int p_lo = it * TN;

    // ---- the slab's scores q K^T and g U^T over the tile, C layout
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PI; kk += 8) {
      const FragA a = load_a<QS>(q_s + m0 * QS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<QS>(b0, b1, kt + 8 * j * QS + kk, gq, tq);
        mma3(sc[j], a, b0);
        mma3(sc[j + 1], a, b1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PO; kk += 8) {
      const FragA a = load_a<GS>(g_s + m0 * GS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<GS>(b0, b1, ut + 8 * j * GS + kk, gq, tq);
        mma3(dp[j], a, b0);
        mma3(dp[j + 1], a, b1);
      }
    }

    // ---- A and dS on the fragments (rows gq, gq + 8; patterns 8j + 2tq,
    // + 1), split as A operands of dS K over the permuted k
    FragA dsa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool in = live[r] && p_lo + 8 * j + 2 * tq + (e & 1) < m_patterns;
        const float a = in ? __expf(sc[j][e] * beta - m_r[r]) * il_r[r] : 0.f;
        v[e] = a * (dp[j][e] - dl_r[r]) * beta;
      }
      dsa[j] = split_a(v[0], v[2], v[1], v[3]);
    }

    // ---- dq += dS K over the tile's patterns, one n-tile of dq at a time
    // in a fresh fragment, added to the running sum after the tile
#pragma unroll
    for (int c = 0; c < CTP; ++c) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, dsa[j], load_b_cols<QS>(kt + 8 * j * QS + 8 * (c0 + c), gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += o[e];
    }
  }

  // ---- this split's partial dq, (splits, n, PI), rows < n, the block's columns
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live[e]) continue;
    float* out = dq_part + (static_cast<size_t>(split) * n + row0 + m0 + gq + 8 * e) * PI + 8 * c0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < CTP; ++c)
      *reinterpret_cast<float2*>(out + 8 * c) = make_float2(acc[c][2 * e], acc[c][2 * e + 1]);
  }
}

constexpr size_t FIN_BYTES = sizeof(float) * 2 * FIN_ROWS * MAX_WIDTH;

// dq = the sum of the splits' partials in order (in double, rounded once),
// then the LayerNorm backward in double, 4 lanes a row: dx, and this
// block's partial rows of ds and dt, each summed over its rows in order.
__global__ void __launch_bounds__(FIN_THREADS)
stream_bwd_dx_finish_kernel(const float* __restrict__ x, const float* __restrict__ s,
                            const float* __restrict__ dq_part, int splits, int pd, int n, int d_in,
                            float* __restrict__ dx, float* __restrict__ ds_part, float* __restrict__ dt_part) {
  extern __shared__ float fin_s[];
  float* x_s = fin_s;                          // x, then dq * xhat
  float* dq_s = fin_s + FIN_ROWS * MAX_WIDTH;  // dq
  const int row0 = blockIdx.x * FIN_ROWS;
  const int rows_here = min(FIN_ROWS, n - row0);
  for (int i = threadIdx.x; i < FIN_ROWS * d_in; i += FIN_THREADS) {
    const int r = i / d_in;
    const int k = i - r * d_in;
    float xv = 0.f, dqv = 0.f;
    if (r < rows_here) {
      xv = x[static_cast<size_t>(row0) * d_in + i];
      double sum = 0.0;
      for (int sp = 0; sp < splits; ++sp) sum += dq_part[(static_cast<size_t>(sp) * n + row0 + r) * pd + k];
      dqv = static_cast<float>(sum);
    }
    x_s[r * MAX_WIDTH + k] = xv;
    dq_s[r * MAX_WIDTH + k] = dqv;
  }
  __syncthreads();

  {
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    const bool live = r < rows_here;
    float* xrow = x_s + r * MAX_WIDTH;
    const float* dqrow = dq_s + r * MAX_WIDTH;
    double mean, inv;
    ln_stats(xrow, d_in, part, mean, inv);
    double m1 = 0.0, m2 = 0.0;
    for (int k = part; k < d_in; k += 4) {
      const double xhat = (xrow[k] - mean) * inv;
      const double dxh = static_cast<double>(dqrow[k]) * s[k];
      m1 += dxh;
      m2 += dxh * xhat;
    }
    m1 = quad_sum(m1) / d_in;
    m2 = quad_sum(m2) / d_in;
    for (int k = part; k < d_in; k += 4) {
      const double xhat = (xrow[k] - mean) * inv;
      const double dq = dqrow[k];
      if (live) dx[static_cast<size_t>(row0 + r) * d_in + k] = static_cast<float>(inv * (dq * s[k] - m1 - xhat * m2));
      xrow[k] = live ? static_cast<float>(dq * xhat) : 0.f;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < d_in; k += FIN_THREADS) {
    double ds_acc = 0.0, dt_acc = 0.0;
    for (int r = 0; r < FIN_ROWS; ++r) {
      ds_acc += x_s[r * MAX_WIDTH + k];
      dt_acc += dq_s[r * MAX_WIDTH + k];  // rows past N hold dq = 0
    }
    ds_part[static_cast<size_t>(blockIdx.x) * d_in + k] = static_cast<float>(ds_acc);
    dt_part[static_cast<size_t>(blockIdx.x) * d_in + k] = static_cast<float>(dt_acc);
  }
}

struct Args {
  const float *x, *K, *U, *s, *t, *g, *m, *l, *delta;
  float *dx, *ds, *dt, *workspace;
  int n, m_patterns, d_in, d_out;
  cudaStream_t stream;
};

int fin_blocks(int n) { return (n + FIN_ROWS - 1) / FIN_ROWS; }

// the plan of the instance for padded widths PI, PO on the current card
template <int PI, int PO>
Plan plan_of(int n, int m_patterns) {
  using C = Tiles<PI, PO>;
  return plan_for((n + TM - 1) / TM * C::PARTS, (m_patterns + C::TN - 1) / C::TN,
                  concurrent_blocks(stream_bwd_dq_kernel<PI, PO>, THREADS, C::BYTES));
}

template <int PI, int PO>
int launch(const Args& a) {
  using C = Tiles<PI, PO>;
  auto kernel = stream_bwd_dq_kernel<PI, PO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const Plan p = plan_of<PI, PO>(a.n, a.m_patterns);
  const unsigned vec16 = vec16_ok(a.x, a.d_in) | vec16_ok(a.g, a.d_out) << 1 | vec16_ok(a.K, a.d_in) << 2 |
                         vec16_ok(a.U, a.d_out) << 3;
  float* dq_part = a.workspace;
  float* ds_part = dq_part + static_cast<size_t>(p.splits) * a.n * PI;
  float* dt_part = ds_part + static_cast<size_t>(fin_blocks(a.n)) * a.d_in;
  kernel<<<dim3((a.n + TM - 1) / TM, p.splits, C::PARTS), THREADS, C::BYTES, a.stream>>>(
      a.x, a.K, a.U, a.s, a.t, a.g, a.m, a.l, a.delta, dq_part, a.n, a.m_patterns, a.d_in, a.d_out, p.per,
      beta_of(a.d_in), vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stream_bwd_dx_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(FIN_BYTES));
  if (err != cudaSuccess) return err;
  stream_bwd_dx_finish_kernel<<<fin_blocks(a.n), FIN_THREADS, FIN_BYTES, a.stream>>>(
      a.x, a.s, dq_part, p.splits, PI, a.n, a.d_in, a.dx, ds_part, dt_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_rows(ds_part, fin_blocks(a.n), a.d_in, a.ds, a.stream);
  if (err != cudaSuccess) return err;
  return sum_rows(dt_part, fin_blocks(a.n), a.d_in, a.dt, a.stream);
}


// ---- past 256: the cluster (hopfield_cluster.cuh) or the narrow-side
// kernel (the pieces of hopfield_narrow.cuh)

// The narrow-side K2: dq over the window [col0, col0 + CW) of d_in for the
// block's TM token rows of the built q, over its split of the pattern
// tiles, G tiles at a time. Per group of tiles: the parts of q and K
// (their columns below d_in), then those of g and U (below d_out), each
// part's products in a fresh sum added to each tile's running one in
// order (the window kernels' order; with G = 1 the scores' parts in the
// order (group, trunc), score_order's), or, where they were split (G = 1),
// the tile of S = q K^T and of P = g U^T (the slab's, whose rows start at
// row_base; the grid's x axis is the slab's token tiles); then the windows of K of the
// group's tiles (their live columns). A and dS on the fragments, then dq
// over the window's live n-tiles, a tile at a time in order, each in a
// fresh fragment added to the running sum after the tile. A buffer holds
// a part item (the resident rows and G tiles), or the window item: the S
// and P tiles (TM x RSC each) where split, and the group's K windows.
// A group shares each part of the resident rows among its G tiles: one
// copy of g's parts where each tile restaged them.
template <int CW, int G>
__global__ void __launch_bounds__(hopfield_narrow::THREADS, 2)
stream_bwd_dq_narrow_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                            const float* __restrict__ g, const float* __restrict__ S, const float* __restrict__ P,
                            const float* __restrict__ m_in, const float* __restrict__ l_in,
                            const float* __restrict__ delta, float* __restrict__ dq_part, int n, int m_patterns,
                            int d_in, int d_out, int per, int slot, int row_base, float beta, int group, int trunc,
                            unsigned vec16) {
  using namespace hopfield_narrow;
  constexpr int CO = CW / 8, RW = CW + 4, GT = G * TN;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * slot

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = row_base + blockIdx.x * hopfield_narrow::TM;  // S and P hold the slab's rows from row_base
  const int split = blockIdx.y;
  const int col0 = blockIdx.z * CW;
  const int first = split * per;
  const int last = min((m_patterns + TN - 1) / TN, first + per) - 1;
  const int w_cols = min(CW, d_in - col0);
  const int ww = staged(w_cols), co = (w_cols + 7) / 8;  // the window's staged columns and live n-tiles
  const int nqi = S ? 0 : parts_of(d_in), ngo = P ? 0 : parts_of(d_out);
  const int per_group = nqi + ngo + 1;
  const int items = (last - first + G) / G * per_group;
  const bool qv = vec16 & 1u, gv = vec16 >> 1 & 1u, kv = vec16 >> 2 & 1u, uv = vec16 >> 3 & 1u,
             sv = vec16 >> 4 & 1u, pv = vec16 >> 5 & 1u;

  auto stage_item = [&](int i) {
    if (i < items) {
      float* y = buf + (i % NB) * slot;
      const int it0 = first + i / per_group * G, sub = i % per_group;
      if (sub < nqi) {
        const int c0 = sub * PART, w = staged(min(PART, d_in - c0));
        stage<hopfield_narrow::TM>(y, RP, q, d_in, c0, w, row0, n, qv);
        stage<GT>(y + hopfield_narrow::TM * RP, RP, K, d_in, c0, w, it0 * TN, m_patterns, kv);
      } else if (sub < nqi + ngo) {
        const int c0 = (sub - nqi) * PART, w = staged(min(PART, d_out - c0));
        stage<hopfield_narrow::TM>(y, RP, g, d_out, c0, w, row0, n, gv);
        stage<GT>(y + hopfield_narrow::TM * RP, RP, U, d_out, c0, w, it0 * TN, m_patterns, uv);
      } else {
        if (S) {
          stage<hopfield_narrow::TM>(y, RSC, S, m_patterns, it0 * TN, TN, row0 - row_base, n - row_base, sv);
          y += hopfield_narrow::TM * RSC;
        }
        if (P) {
          stage<hopfield_narrow::TM>(y, RSC, P, m_patterns, it0 * TN, TN, row0 - row_base, n - row_base, pv);
          y += hopfield_narrow::TM * RSC;
        }
        stage<GT>(y, RW, K, d_in, col0, ww, it0 * TN, m_patterns, kv);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_item(i);

  bool live[2];
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + m0 + gq + 8 * e;
    live[e] = row < n;
    m_r[e] = live[e] ? m_in[row] : 0.f;
    il_r[e] = live[e] ? 1.f / l_in[row] : 0.f;
    dl_r[e] = live[e] ? delta[row] : 0.f;
  }
  float acc[CO][4], sc[G][NT][4], dp[G][NT][4], gs[NT][4];
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    zero(sc[t]);
    zero(dp[t]);
  }
  zero(gs);

  // the slab's rows gq and gq + 8 of a TM x RSC tile of S or P into a C fragment
  auto load_tile = [&](float (&f)[NT][4], const float* t) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(t + (m0 + gq + 8 * r) * RSC + 8 * j + 2 * tq);
        f[j][2 * r] = v.x;
        f[j][2 * r + 1] = v.y;
      }
  };

  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    stage_item(i + NB - 1);
    const float* y = buf + (i % NB) * slot;
    const int it0 = first + i / per_group * G, sub = i % per_group;
    const int gt = min(G, last - it0 + 1);  // the group's tiles
    if (sub < nqi + ngo) {  // a part of q K^T, or of g U^T, for each tile in a fresh sum added to its running one
      const bool score = sub < nqi;
      const int steps = score ? part_steps(d_in, sub) : part_steps(d_out, sub - nqi);
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t >= gt) break;
        float pp[NT][4];
        const float* b = y + (hopfield_narrow::TM + t * TN) * RP;
        if (score && trunc) part_product<true>(pp, y + m0 * RP, b, steps, gq, tq);
        else part_product<false>(pp, y + m0 * RP, b, steps, gq, tq);
        if (score && G == 1) {  // the order's groups (one part a group: part after part)
          add_part(sc[0], gs, pp, sub, group, nqi);
        } else if (score) {  // the window kernels' order, part after part (the plan's groups of tiles)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[t][j][e] = sub == 0 ? pp[j][e] : sc[t][j][e] + pp[j][e];
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[t][j][e] = sub == nqi ? pp[j][e] : dp[t][j][e] + pp[j][e];
        }
      }
      continue;
    }
    if (S) {
      load_tile(sc[0], y);
      y += hopfield_narrow::TM * RSC;
    }
    if (P) {
      load_tile(dp[0], y);
      y += hopfield_narrow::TM * RSC;
    }

    // ---- per tile of the group, in order: A and dS on the fragments, then
    // dq += dS K over the window's live n-tiles
#pragma unroll
    for (int t = 0; t < G; ++t) {
      if (t >= gt) break;
      const int p_lo = (it0 + t) * TN;
      FragA dsa[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool in = live[r] && p_lo + 8 * j + 2 * tq + (e & 1) < m_patterns;
          const float a = in ? __expf(sc[t][j][e] * beta - m_r[r]) * il_r[r] : 0.f;
          v[e] = a * (dp[t][j][e] - dl_r[r]) * beta;
        }
        dsa[j] = split_a(v[0], v[2], v[1], v[3]);
      }
      const float* kw = y + t * TN * RW;
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        if (c >= co) continue;
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma3(o, dsa[j], load_b_cols<RW>(kw + 8 * j * RW + 8 * c, gq, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] += o[e];
      }
    }
  }

  // ---- this split's partial dq, (splits, n, d_in), the window's columns < d_in
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live[e]) continue;
    float* out = dq_part + (static_cast<size_t>(split) * n + row0 + m0 + gq + 8 * e) * d_in;
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = col0 + 8 * c + 2 * tq + hh;
        if (col < d_in) out[col] = acc[c][2 * e + hh];
      }
  }
}

// The whole window (hopfield_narrow.cuh): dq over all of d_in (staged to
// DW) for the block's TM token rows of the built q, over its split of the
// pattern tiles. Warp w holds the 16-row slab w & 3 and half w >> 2 of
// dq's n-tiles, CT each. q and g stay in shared memory for the walk; each
// pattern tile's K (every column) and U arrive in one of two buffers. Per
// tile each warp computes two n-tiles of its slab's scores (patterns 16 h
// to 16 h + 15 of the tile) in the order (group, trunc) and of g U^T (one
// part, rounded), A and dS on them, and hands dS to the slab's other warp
// through shared memory (a named barrier of the two); then dq += dS K over
// its half's live n-tiles, the tile in a fresh fragment added to the
// running sum after the tile.
template <int DW, int WO>
__global__ void __launch_bounds__(hopfield_narrow::WHOLE_THREADS, 1)
stream_bwd_dq_whole_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                           const float* __restrict__ g, const float* __restrict__ m_in,
                           const float* __restrict__ l_in, const float* __restrict__ delta,
                           float* __restrict__ dq_part, int n, int m_patterns, int d_in, int d_out, int per,
                           float beta, int group, int trunc, unsigned vec16) {
  using namespace hopfield_narrow;
  constexpr int QS = DW + 4, GS = WO + 4, CT = DW / 16, BUF = TN * (QS + GS);
  constexpr int TM = hopfield_narrow::TM;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + TM * QS;
  float* ds_s = g_s + TM * GS;
  float* str = ds_s + TM * DS;  // buffer u: K tile at str + u * BUF, its U tile TN * QS after

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), h = warp >> 2;
  const int row0 = blockIdx.x * TM;
  const int first = blockIdx.y * per;
  const int last = min((m_patterns + TN - 1) / TN, first + per) - 1;
  const int co = (d_in + 7) / 8, ks_out = (d_out + 7) / 8;  // dq's live n-tiles; g U^T's k-steps
  const bool qv = vec16 & 1u, gv = vec16 >> 1 & 1u, kv = vec16 >> 2 & 1u, uv = vec16 >> 3 & 1u;

  stage_whole<TM>(q_s, QS, q, d_in, row0, n, qv);
  stage<TM, WHOLE_THREADS>(g_s, GS, g, d_out, 0, staged(d_out), row0, n, gv);
  auto stage_tile = [&](int it, int u) {
    float* kt = str + u * BUF;
    stage_whole<TN>(kt, QS, K, d_in, it * TN, m_patterns, kv);
    stage<TN, WHOLE_THREADS>(kt + TN * QS, GS, U, d_out, 0, staged(d_out), it * TN, m_patterns, uv);
    cp_async_commit();
  };
  stage_tile(first, 0);  // one group with q and g

  bool live[2];
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + m0 + gq + 8 * e;
    live[e] = row < n;
    m_r[e] = live[e] ? m_in[row] : 0.f;
    il_r[e] = live[e] ? 1.f / l_in[row] : 0.f;
    dl_r[e] = live[e] ? delta[row] : 0.f;
  }
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and its dS
    if (it < last) stage_tile(it + 1, u ^ 1);
    const float* kt = str + u * BUF;
    const float* ut = kt + TN * QS;

    // ---- the warp's two n-tiles of the scores and of g U^T, A and dS on
    // them, into the slab's dS tile
    float sc[2][4], dp[2][4];
    ordered_pair<QS>(sc, q_s + m0 * QS, kt + 16 * h * QS, d_in, group, trunc, gq, tq);
    pair_part<GS, false>(dp, g_s + m0 * GS, ut + 16 * h * GS, ks_out, gq, tq);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool in = live[r] && it * TN + 16 * h + 8 * j + 2 * tq + (e & 1) < m_patterns;
        const float a = in ? __expf(sc[j][e] * beta - m_r[r]) * il_r[r] : 0.f;
        v[e] = a * (dp[j][e] - dl_r[r]) * beta;
      }
      put_pair(ds_s + m0 * DS, 2 * h + j, v, gq, tq);
    }
    named_barrier(1 + (warp & 3), 64);  // the slab's two warps have written its dS

    // ---- dq += dS K over the half's live n-tiles
    FragA dsa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) dsa[j] = get_pair(ds_s + m0 * DS, j, gq, tq);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int ct = h * CT + c;
      if (ct >= co) break;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, dsa[j], load_b_cols<QS>(kt + 8 * j * QS + 8 * ct, gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += o[e];
    }
  }

  // ---- this split's partial dq, (splits, n, d_in), the half's columns < d_in
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live[e]) continue;
    float* out = dq_part + (static_cast<size_t>(blockIdx.y) * n + row0 + m0 + gq + 8 * e) * d_in;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 8 * (h * CT + c) + 2 * tq + hh;
        if (col < d_in) out[col] = acc[c][2 * e + hh];
      }
  }
}

// Shared bytes of the whole window's instance: q and g, the dS tile, two
// buffers of a K and a U tile.
template <int DW, int WO>
constexpr size_t whole_bytes() {
  using namespace hopfield_narrow;
  return sizeof(float) * (hopfield_narrow::TM * (DW + 4 + WO + 4 + DS) + 2 * TN * (DW + 4 + WO + 4));
}

constexpr int WIDE_FIN_THREADS = 32 * FIN_ROWS;  // the wide finishing pass: a warp a row

// sum over the 32 lanes of a warp; the same in each
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The finishing pass of the wide variant: as stream_bwd_dx_finish_kernel,
// a warp a row, its lanes on neighbouring columns of x and of the splits'
// dq in device memory. dq (the splits summed in order, in double, rounded
// once) goes into dqs (n, d_in), dq * xhat over split 0's partial (each
// element read by its own lane first); then the block's column sums of
// both, over its rows in order.
__global__ void __launch_bounds__(WIDE_FIN_THREADS)
stream_bwd_dx_finish_wide_kernel(const float* __restrict__ x, const float* __restrict__ s, float* __restrict__ dq_part,
                                 int splits, int n, int d_in, float* __restrict__ dx, float* __restrict__ dqs,
                                 float* __restrict__ ds_part, float* __restrict__ dt_part) {
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * FIN_ROWS;
  const int rows_here = min(FIN_ROWS, n - row0);
  const int r = threadIdx.x >> 5;
  if (r < rows_here) {
    const size_t at = static_cast<size_t>(row0 + r) * d_in;
    const float* xrow = x + at;
    double sum = 0.0;
    for (int k = lane; k < d_in; k += 32) sum += xrow[k];
    const double mean = warp_sum(sum) / d_in;
    double var = 0.0;
    for (int k = lane; k < d_in; k += 32) {
      const double c = xrow[k] - mean;
      var += c * c;
    }
    const double inv = 1.0 / sqrt(warp_sum(var) / d_in + static_cast<double>(LN_EPS));
    double m1 = 0.0, m2 = 0.0;
    for (int k = lane; k < d_in; k += 32) {
      double acc = 0.0;
      for (int sp = 0; sp < splits; ++sp) acc += dq_part[static_cast<size_t>(sp) * n * d_in + at + k];
      const float dq = static_cast<float>(acc);
      dqs[at + k] = dq;
      const double xhat = (xrow[k] - mean) * inv;
      const double dxh = static_cast<double>(dq) * s[k];
      m1 += dxh;
      m2 += dxh * xhat;
    }
    m1 = warp_sum(m1) / d_in;
    m2 = warp_sum(m2) / d_in;
    for (int k = lane; k < d_in; k += 32) {
      const double xhat = (xrow[k] - mean) * inv;
      const double dq = dqs[at + k];
      dx[at + k] = static_cast<float>(inv * (dq * s[k] - m1 - xhat * m2));
      dq_part[at + k] = static_cast<float>(dq * xhat);
    }
  }
  __syncthreads();  // the block's rows of dqs and dq * xhat are written

  for (int k = threadIdx.x; k < d_in; k += WIDE_FIN_THREADS) {
    double ds_acc = 0.0, dt_acc = 0.0;
    for (int rr = 0; rr < rows_here; ++rr) {
      const size_t at = static_cast<size_t>(row0 + rr) * d_in + k;
      ds_acc += dq_part[at];
      dt_acc += dqs[at];
    }
    ds_part[static_cast<size_t>(blockIdx.x) * d_in + k] = static_cast<float>(ds_acc);
    dt_part[static_cast<size_t>(blockIdx.x) * d_in + k] = static_cast<float>(dt_acc);
  }
}

// The narrow-side plan: the order of the score parts (score_order); the
// whole window where whole_fits takes the widths (its splits of the
// pattern axis from one block an SM, the instance's occupancy; nothing
// split); else the window (d_in padded to 8 up to 128, else 128), the
// splits of the pattern axis, which products are split over the card
// first (hopfield_narrow::split_scores: each group's sums apart, then
// added in order, the same bits), and the split's slabs of token tiles
// and rounds of groups (hopfield_narrow::slab_plan, each slab at
// least as many tiles as keep the window kernel at PLAN_PER_SM blocks an
// SM where the cap allows). The splits plan from PLAN_PER_SM
// blocks an SM whatever the kernel's occupancy: they set the order of
// dq's sums (a split's tiles in f32, the splits in double), and so dx,
// ds and dt keep the bits that the window kernel (252 registers, two
// blocks an SM) gave them. S = q K^T splits where d_in has more than one
// part and dq more than one window (each would recompute it); P = g U^T
// where d_out has more than one part and dq more than one window, or the
// blocks, the pattern splits counted, leave SMs idle (fewer than one an
// SM: at (3, 8320), N 37, two blocks walked 130 parts each, 0.229 ms
// against the split's 0.015 on an H100; at (3, 384), N 4,096, 256 blocks
// fill the card and the split lost, 0.141 against 0.077; PERF.md). Where
// one token tile's sums and one part pass SPLIT_BYTES, nothing is split.
constexpr int PLAN_PER_SM = 2;
struct DxPlan {
  int cw;  // the window: on the whole window its staged depth
  hopfield_narrow::Order order;
  bool whole, split_s, split_p;
  Plan p;
  hopfield_narrow::SlabPlan slabs;
};
inline DxPlan dx_window_plan(int n, int m_patterns, int d_in, int d_out, int sms) {
  using namespace hopfield_narrow;
  DxPlan d{};
  d.order = score_order(d_in, d_out);
  const int token_tiles = (n + hopfield_narrow::TM - 1) / hopfield_narrow::TM, tiles = (m_patterns + TN - 1) / TN;
  int wo;
  if (whole_fits(d_in, d_out, d.cw, wo)) {
    d.whole = true;
    d.p = plan_for(token_tiles, tiles, std::max(sms, 1));
    return d;
  }
  d.cw = d_in <= 128 ? padded_width(d_in) : 128;
  const int windows = windows_of(d_in, d.cw);
  const int concurrent = PLAN_PER_SM * std::max(sms, 1);
  d.p = plan_for(token_tiles * windows, tiles, concurrent);
  const long long blocks = static_cast<long long>(token_tiles) * windows * d.p.splits;
  d.split_s = parts_of(d_in) >= 2 && windows > 1;
  d.split_p = parts_of(d_out) >= 2 && (windows > 1 || blocks < sms);
  if (d.split_s || d.split_p) {
    const long long per_tile = static_cast<long long>(windows) * d.p.splits;  // window blocks a token tile
    const int parts = std::max(d.split_s ? groups_of(d_in, d.order) : 0, d.split_p ? parts_of(d_out) : 0);
    if (!slab_plan(n, m_patterns, d.split_s + d.split_p, parts, (concurrent + per_tile - 1) / per_tile, d.slabs))
      d.split_s = d.split_p = false;
  }
  return d;
}

// The splits of the pattern axis past 256: from the cluster kernel's
// clusters of token tiles where it runs, else the narrow-side plan's.
Plan plan_wide(int n, int m_patterns, int d_in, int d_out) {
  int j, ranks;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks)) {
    int tm, tn;
    hopfield_cluster::tile_rows(j, tm, tn);
    return plan_for((n + tm - 1) / tm, (m_patterns + tn - 1) / tn,
                    hopfield_cluster::concurrent_clusters<false>(j, ranks));
  }
  return dx_window_plan(n, m_patterns, d_in, d_out, hopfield_narrow::sm_count()).p;
}

// Floats of the wide variant's scratch: q (n, d_in), later dq; each
// split's partial dq (n, d_in), split 0's later dq * xhat; one partial row
// of ds and of dt for each 32 tokens; on the narrow-side plan, from the
// next multiple of 4 floats, the split products' (a slab's S and P, then a
// round's parts: at most SPLIT_BYTES; none where nothing is split).
long long workspace_wide(int n, int m_patterns, int d_in, int d_out) {
  const int splits = plan_wide(n, m_patterns, d_in, d_out).splits;
  long long floats = static_cast<long long>(1 + splits) * n * d_in + 2LL * fin_blocks(n) * d_in;
  int j, ranks;
  if (!hopfield_cluster::plan(d_in, d_out, j, ranks))
    floats = (floats + 3) / 4 * 4 + dx_window_plan(n, m_patterns, d_in, d_out, hopfield_narrow::sm_count()).slabs.floats;
  return floats;
}

// Tiles of a group of the narrow-side kernel where nothing is split and
// the scores keep the window kernels' order: GROUP where dq's window is
// at most 32 columns (the group's K windows fit a part item's buffer),
// WIDE_GROUP at 64 and 128 (their accumulators leave room for two tiles'
// fragments, not four); else one (a tile's scores then take the order's
// groups in a sum of their own). (A K3-style group is what the split
// products replace: with them a tile has one item.)
constexpr int GROUP = 4, WIDE_GROUP = 2;
inline int group_of(const DxPlan& d) {
  if (d.split_s || d.split_p || d.order.group > 1 || d.order.trunc) return 1;
  return d.cw <= 32 ? GROUP : WIDE_GROUP;
}

// f on the narrow-side kernel of window CW for the plan's group.
template <int CW, class F>
int with_group(const DxPlan& d, F&& f) {
  if (group_of(d) > 1) return f(stream_bwd_dq_narrow_kernel<CW, (CW <= 32 ? GROUP : WIDE_GROUP)>);
  return f(stream_bwd_dq_narrow_kernel<CW, 1>);
}

// The narrow-side kernel's slot: a part item (the resident rows and a
// group's tiles), or the window item (the split products' tiles and the
// group's K windows, of 128 columns at most).
inline int narrow_slot(const DxPlan& d) {
  using namespace hopfield_narrow;
  const int g = group_of(d);
  return std::max((hopfield_narrow::TM + g * TN) * RP,
                  (d.split_s + d.split_p) * hopfield_narrow::TM * RSC + g * TN * (d.cw + 4));
}

// dq of every split past 256: the cluster kernel (hopfield_cluster.cuh)
// where its plan takes the widths, else the narrow-side plan: the whole
// window where it fits, or slab after slab of token tiles, the slab's
// split products first through `work` ([S | P | a round's groups]), then
// the narrow-side kernel over the slab's tiles.
int launch_dq_wide(const Args& a, const Plan& p, const float* q, float* dq_part, float* work) {
  const unsigned vec16 = vec16_ok(q, a.d_in) | vec16_ok(a.g, a.d_out) << 1 | vec16_ok(a.K, a.d_in) << 2 |
                         vec16_ok(a.U, a.d_out) << 3;
  int j, ranks;
  if (hopfield_cluster::plan(a.d_in, a.d_out, j, ranks)) {
    return hopfield_cluster::with_chunks(j, [&](auto jj) {
      constexpr int J = decltype(jj)::value;
      const int tiles = (a.n + cluster::Cfg<J>::TM - 1) / cluster::Cfg<J>::TM;
      return static_cast<int>(hopfield_cluster::launch_cluster<J, false>(
          dim3(tiles, p.splits, ranks), q, a.g, a.K, a.U, a.m, a.l, a.delta, dq_part, nullptr, a.n, a.m_patterns,
          a.d_in, a.d_out, p.per, beta_of(a.d_in), vec16, a.stream));
    });
  }
  using namespace hopfield_narrow;
  const int sms = sm_count();
  const DxPlan d = dx_window_plan(a.n, a.m_patterns, a.d_in, a.d_out, sms);
  if (d.whole)
    return with_whole(d.cw, [&](auto dw, auto wo) {
      constexpr int DW = decltype(dw)::value, WO = decltype(wo)::value;
      auto kernel = stream_bwd_dq_whole_kernel<DW, WO>;
      constexpr size_t bytes = whole_bytes<DW, WO>();
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<dim3((a.n + hopfield_narrow::TM - 1) / hopfield_narrow::TM, p.splits), WHOLE_THREADS, bytes, a.stream>>>(
          q, a.K, a.U, a.g, a.m, a.l, a.delta, dq_part, a.n, a.m_patterns, a.d_in, a.d_out, p.per, beta_of(a.d_in),
          d.order.group, d.order.trunc, vec16);
      return static_cast<int>(cudaGetLastError());
    });
  if (windows_of(a.d_in, d.cw) > 65535) return cudaErrorInvalidValue;
  const bool split = d.split_s || d.split_p;
  const int slab_rows = split ? std::min(d.slabs.slab * hopfield_narrow::TM, a.n) : a.n;
  const long long sums = static_cast<long long>(slab_rows) * a.m_patterns;  // floats of a product's sums
  float* S = d.split_s ? work : nullptr;
  float* P = d.split_p ? work + (d.split_s ? sums : 0) : nullptr;
  float* parts = work + (d.split_s + d.split_p) * sums;
  const int slot = narrow_slot(d);
  const size_t bytes = sizeof(float) * NB * slot;
  const unsigned svec16 = vec16 | (S ? vec16_ok(S, a.m_patterns) : 0u) << 4 | (P ? vec16_ok(P, a.m_patterns) : 0u) << 5;
  return with_window(d.cw, [&](auto c) {
    constexpr int CW = decltype(c)::value;
    auto launch_group = [&](auto kernel) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      for (int r0 = 0; err == cudaSuccess && r0 < a.n; r0 += slab_rows) {
        const int rows = std::min(slab_rows, a.n - r0);
        if (S) err = split_slab(q + static_cast<size_t>(r0) * a.d_in, a.K, S, parts, rows, a.m_patterns, a.d_in,
                                d.order, d.slabs.round, sms, a.stream);
        if (P && err == cudaSuccess)
          err = split_slab(a.g + static_cast<size_t>(r0) * a.d_out, a.U, P, parts, rows, a.m_patterns, a.d_out,
                           {1, false}, d.slabs.round, sms, a.stream);
        if (err != cudaSuccess) break;
        kernel<<<dim3((rows + hopfield_narrow::TM - 1) / hopfield_narrow::TM, p.splits, windows_of(a.d_in, CW)),
                 hopfield_narrow::THREADS, bytes, a.stream>>>(q, a.K, a.U, a.g, S, P, a.m, a.l, a.delta, dq_part,
                                                              a.n, a.m_patterns, a.d_in, a.d_out, p.per, slot, r0,
                                                              beta_of(a.d_in), d.order.group, d.order.trunc, svec16);
        err = cudaGetLastError();
      }
      return static_cast<int>(err);
    };
    return with_group<CW>(d, launch_group);
  });
}

int launch_wide(const Args& a) {
  const Plan p = plan_wide(a.n, a.m_patterns, a.d_in, a.d_out);
  float* q = a.workspace;
  float* dq_part = q + static_cast<size_t>(a.n) * a.d_in;
  float* ds_part = dq_part + static_cast<size_t>(p.splits) * a.n * a.d_in;
  float* dt_part = ds_part + static_cast<size_t>(fin_blocks(a.n)) * a.d_in;
  // the split products', from a 16-byte boundary (the workspace's base is one)
  float* work = a.workspace + (static_cast<size_t>(dt_part - a.workspace) + fin_blocks(a.n) * a.d_in + 3) / 4 * 4;
  cudaError_t err = hopfield_wide::build_queries(a.x, a.s, a.t, a.n, a.d_in, q, nullptr, nullptr, a.stream);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(launch_dq_wide(a, p, q, dq_part, work));
  if (err != cudaSuccess) return err;
  stream_bwd_dx_finish_wide_kernel<<<fin_blocks(a.n), WIDE_FIN_THREADS, 0, a.stream>>>(
      a.x, a.s, dq_part, p.splits, a.n, a.d_in, a.dx, q, ds_part, dt_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_rows(ds_part, fin_blocks(a.n), a.d_in, a.ds, a.stream);
  if (err != cudaSuccess) return err;
  return sum_rows(dt_part, fin_blocks(a.n), a.d_in, a.dt, a.stream);
}

}  // namespace

// Floats of device scratch that hopfield_stream_bwd_dx needs: each split's
// partial dq (at the padded width) and one partial row of ds and one of dt
// for each 32 tokens; past 256, the wide variant's (workspace_wide).
extern "C" long long hopfield_stream_bwd_dx_workspace(int n, int m_patterns, int d_in, int d_out) {
  if (n > 0 && m_patterns > 0 && d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out))
    return workspace_wide(n, m_patterns, d_in, d_out);
  if (!takes(n, m_patterns, d_in, d_out)) return 0;
  return with_widths(d_in, d_out, [&](auto pi, auto po) -> long long {
    constexpr int PI = decltype(pi)::value;
    const int splits = plan_of<PI, decltype(po)::value>(n, m_patterns).splits;
    return static_cast<long long>(splits) * n * PI + 2LL * fin_blocks(n) * d_in;
  });
}

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), g (n, d_out), m, l and delta (n),
// dx (n, d_in), ds and dt (d_in), and workspace (see above); any d_in,
// d_out >= 1 (past 256 the wide variant). Launches the kernel, the
// finishing pass and the fixed-order sums of the partial rows on
// `stream`. Returns a cudaError_t; 0 means every launch was accepted.
extern "C" int hopfield_stream_bwd_dx(const float* x, const float* K, const float* U, const float* s,
                                      const float* t, const float* g, const float* m, const float* l,
                                      const float* delta, float* dx, float* ds, float* dt, float* workspace, int n,
                                      int m_patterns, int d_in, int d_out, void* stream) {
  const Args a{x, K, U, s, t, g, m, l, delta, dx, ds, dt, workspace, n, m_patterns, d_in, d_out,
               static_cast<cudaStream_t>(stream)};
  if (n > 0 && m_patterns > 0 && d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out))
    return launch_wide(a);
  if (!takes(n, m_patterns, d_in, d_out)) return cudaErrorInvalidValue;
  return with_widths(d_in, d_out, [&](auto pi, auto po) { return launch<decltype(pi)::value, decltype(po)::value>(a); });
}

// The kernel built for (d_in, d_out) as the card reports it: out receives
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// threads a block, blocks an SM, TM and TN; past 256 the cluster kernel's
// where its plan takes the widths (hopfield_cluster::plan), the whole
// window's where it fits (hopfield_narrow::whole_fits), else the
// narrow-side kernel's where nothing is split (its group of tiles the
// streamed rows). Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dx_attributes(int d_in, int d_out, int* out) {
  int j, ranks, dw, wo;
  if (d_in >= 1 && d_out >= 1 && hopfield_cluster::plan(d_in, d_out, j, ranks))
    return static_cast<int>(hopfield_cluster::cluster_build<false>(d_in, d_out, true, out));
  if (d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out) && hopfield_narrow::whole_fits(d_in, d_out, dw, wo))
    return hopfield_narrow::with_whole(dw, [&](auto w, auto o) {
      constexpr int DW = decltype(w)::value, WO = decltype(o)::value;
      return static_cast<int>(kernel_attributes(stream_bwd_dq_whole_kernel<DW, WO>, hopfield_narrow::WHOLE_THREADS,
                                                whole_bytes<DW, WO>(), hopfield_narrow::TM, hopfield_narrow::TN, out));
    });
  if (d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out)) {  // on the plan of a call with nothing split
    DxPlan d{};
    d.cw = d_in <= 128 ? padded_width(d_in) : 128;
    d.order = hopfield_narrow::score_order(d_in, d_out);
    const size_t bytes = sizeof(float) * hopfield_narrow::NB * narrow_slot(d);
    return hopfield_narrow::with_window(d.cw, [&](auto c) {
      constexpr int CW = decltype(c)::value;
      auto attrs = [&](auto kernel) {
        return static_cast<int>(kernel_attributes(kernel, hopfield_narrow::THREADS, bytes, hopfield_narrow::TM,
                                                  group_of(d) * hopfield_narrow::TN, out));
      };
      return with_group<CW>(d, attrs);
    });
  }
  if (!takes(1, 1, d_in, d_out)) return cudaErrorInvalidValue;
  return with_widths(d_in, d_out, [&](auto pi, auto po) {
    constexpr int PI = decltype(pi)::value, PO = decltype(po)::value;
    using C = Tiles<PI, PO>;
    return static_cast<int>(kernel_attributes(stream_bwd_dq_kernel<PI, PO>, THREADS, C::BYTES, TM, C::TN, out));
  });
}

// The cluster kernel of (d_in, d_out) where its plan takes the widths
// (hopfield_cluster::plan; else cudaErrorInvalidValue): out receives the
// blocks of a cluster, the slice width at most, and the clusters the card
// can hold at once (0: it cannot launch). Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dx_cluster(int d_in, int d_out, int* out) {
  if (d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  return static_cast<int>(hopfield_cluster::cluster_build<false>(d_in, d_out, false, out));
}

// The route of (n, m_patterns, d_in, d_out) past 256, into out[0..8]: 1
// the cluster; on the narrow-side kernel 2, plus 1 where S = q K^T is
// split over the card first and 2 where P = g U^T is; 7 the whole window
// (0 up to 256: a built instance); then the narrow-side plan's window (the
// whole window's staged depth), the splits of the
// pattern axis and their pattern tiles each; where a product is split,
// its slabs, the token tiles of a slab, the rounds and the parts of a
// round, and the split's floats of scratch (0 where it does not run).
// Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dx_plan(int n, int m_patterns, int d_in, int d_out, int* out) {
  if (n <= 0 || m_patterns <= 0 || d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i) out[i] = 0;
  int j, ranks;
  if (!hopfield_wide::wide(d_in, d_out)) return cudaSuccess;
  out[0] = 1;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks)) return cudaSuccess;
  const DxPlan d = dx_window_plan(n, m_patterns, d_in, d_out, hopfield_narrow::sm_count());
  out[0] = d.whole ? 7 : 2 + d.split_s + 2 * d.split_p;
  out[1] = d.cw;
  out[2] = d.p.splits;
  out[3] = d.p.per;
  out[4] = d.slabs.slabs;
  out[5] = d.slabs.slab;
  out[6] = d.slabs.rounds;
  out[7] = d.slabs.round;
  out[8] = static_cast<int>(d.slabs.floats);
  return cudaSuccess;
}
