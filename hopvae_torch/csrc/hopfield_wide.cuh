// The streaming Hopfield kernels past a width of 256: the pieces of the
// wide variants of K1 (hopfield_stream_fwd.cu), K2
// (hopfield_stream_bwd_dx.cu), K3 (hopfield_stream_bwd_dku.cu) and K4
// (hopfield_bottleneck_fused.cu), one instance each for every width.
//
// The built instances (hopfield_stream.cuh, with_widths) keep 64 rows of
// q resident at the padded width and cap an output window at 128 columns;
// past 256 that no longer fits 227 KB beside two streamed buffers, and a
// warp's outputs would take too many registers. The wide variants
// therefore:
// - build q = LN(x) * s + t of every token first (build_queries), the
//   LayerNorm statistics in double over the full d_in, with the
//   arithmetic of layer_norm_rows, so the same bits;
// - stream every product's depth in chunks of DC = 64 columns: per
//   streamed tile, the chunks of the resident rows and of the tile arrive
//   by double-buffered cp.async one after the other, each chunk's
//   three-pass TF32 products summed in fresh fragments and added to the
//   score fragments before the exp (K1, K4) or the dS step (K2, K3);
// - cover the output columns in windows of CW = 128 on a grid axis (K1's
//   out, K2's dq, K3's dK and dU): each window block recomputes the scores
//   over the full depth, the window's tile arriving as the tile's last
//   item. They run only where the clusters (hopfield_cluster.cuh) do not:
//   K2 and K3 past 8192 or with d_in up to 128, K1 and K4's stages past
//   8192 or with d_in or d_out up to 128. There a lookup has one window
//   of its output, or scores at most 128 deep, and the window kernels ran
//   faster on an H100 (PERF.md).
// Shared bytes: 52,224 (two buffers of a 64 + 32 row chunk), whatever the
// widths. Registers and blocks an SM are in PERF.md, from the kernels'
// attributes entries on the card.

#pragma once

#include "hopfield_stream.cuh"

namespace hopfield_wide {

using namespace hopfield_stream;
using namespace tf32x3;

constexpr int TM = 64;   // resident rows of a block: tokens (K1, K2, K4) or patterns (K3)
constexpr int TN = 32;   // streamed rows of a tile: patterns (K1, K2, K4) or tokens (K3)
constexpr int NT = TN / 8;
constexpr int DC = 64;   // columns of a streamed chunk of a product's depth
constexpr int CW = 128;  // output columns of a block: its window
constexpr int CO = CW / 8;
constexpr int THREADS = 32 * TM / 16;  // a warp a 16-row slab
constexpr int RC = DC + 4, RW = CW + 4;  // row strides of a chunk and of a window tile
// one buffer: a chunk item (TM resident and TN streamed rows of DC
// columns) or a window item (TN rows of CW columns and 3 TN row stats)
constexpr int SLOT = (TM + TN) * RC;
static_assert(TN * RW + 3 * TN <= SLOT, "a window item fits a buffer");
constexpr size_t BYTES = sizeof(float) * 2 * SLOT;

// whether a lookup of widths (d_in, d_out) takes the wide variants
__host__ __device__ inline bool wide(int d_in, int d_out) { return d_in > MAX_WIDTH || d_out > MAX_WIDTH; }
__host__ __device__ inline int chunks(int d) { return (d + DC - 1) / DC; }
__host__ __device__ inline int windows(int d) { return (d + CW - 1) / CW; }

// Columns [c0, c0 + W) of rows [row0, row0 + ROWS) of a row-major (rows,
// d) array into a ROWS x (W + 4) tile by cp.async (the caller commits);
// zeros past d and past `rows`.
template <int W, int ROWS>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, int d, int c0, int row0,
                                           int rows, bool vec16) {
  stage_async<W, ROWS, THREADS>(dst, src + c0, min(W, d - c0), row0, rows, vec16, d);
}

__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// acc += the slab's 16 x TN product of a chunk item: the A rows at
// y + m0 RC (row stride RC), the B rows at y + TM RC. The chunk is summed
// in fresh fragments and then added in f32: the tensor cores' sums
// truncate, and one chain over a depth of 512 (192 mma) left l 1.3e-5
// from the plain version on an H100, past STAT_RTOL.
__device__ __forceinline__ void chunk_product(float (&acc)[NT][4], const float* y, int m0, int gq, int tq) {
  float part[NT][4];
  zero(part);
#pragma unroll 2
  for (int c = 0; c < DC / 8; ++c) {
    const FragA a = load_a<RC>(y + m0 * RC + 8 * c, gq, tq);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      FragB b0, b1;
      load_b_rows2<RC>(b0, b1, y + TM * RC + 8 * j * RC + 8 * c, gq, tq);
      mma3(part[j], a, b0);
      mma3(part[j + 1], a, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

constexpr int Q_ROWS = 32;  // token rows of a block of build_queries
constexpr int Q_THREADS = 4 * Q_ROWS;

// q = LN(x) * s + t of every row of x (n, d) into q (n, d), 4 lanes a row
// reading x from device memory, with layer_norm_rows' arithmetic; and,
// where il is given, il = 1 / l. Rows past n compute on row n - 1 (the
// shuffles need the whole warp) and write nothing.
__global__ void __launch_bounds__(Q_THREADS)
build_queries_kernel(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ t, int n,
                     int d, float* __restrict__ q, const float* __restrict__ l_in, float* __restrict__ il) {
  const int row = blockIdx.x * Q_ROWS + (threadIdx.x >> 2);
  const int part = threadIdx.x & 3;
  const bool live = row < n;
  const float* xr = x + static_cast<size_t>(live ? row : n - 1) * d;
  double mean, inv;
  ln_stats(xr, d, part, mean, inv);
  if (!live) return;
  for (int k = part; k < d; k += 4) q[static_cast<size_t>(row) * d + k] = static_cast<float>((xr[k] - mean) * inv * s[k] + t[k]);
  if (il != nullptr && part == 0) il[row] = 1.f / l_in[row];
}

inline cudaError_t build_queries(const float* x, const float* s, const float* t, int n, int d, float* q,
                                 const float* l_in, float* il, cudaStream_t stream) {
  build_queries_kernel<<<(n + Q_ROWS - 1) / Q_ROWS, Q_THREADS, 0, stream>>>(x, s, t, n, d, q, l_in, il);
  return cudaGetLastError();
}

// What the wide forward (the window kernel below, or the cluster's in
// hopfield_cluster.cuh) writes for out = softmax(beta q K^T) U / l: PLAIN
// (K1) out, and m and l (here from the first window); SHIFT (K4's e and
// r) out + b; QUANTIZE (K4's zq) rint(sigmoid(out + b) * levels), and zq /
// levels into zn.
enum Epilogue { PLAIN, SHIFT, QUANTIZE };

// The wide forward: K1's walk at any widths, for the block's TM token
// rows of the built q (n, d_in) and the window [col0, col0 + CW) of U.
// Per pattern tile: the chunks of q and K, then the U window; the online
// softmax and P U as in hopfield_stream_fwd.cuh (the denominator a
// compensated sum).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
stream_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                       const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ zn_out, int n, int m_patterns, int d_in,
                       int d_out, float beta, float levels, unsigned vec16) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * SLOT

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * CW;
  const int nc = chunks(d_in);
  const int per_tile = nc + 1;
  const int items = (m_patterns + TN - 1) / TN * per_tile;
  const bool qv = vec16 & 1u, kv = vec16 >> 1 & 1u, uv = vec16 >> 2 & 1u;

  auto stage_item = [&](int i, int u) {
    float* y = buf + u * SLOT;
    const int it = i / per_tile, sub = i - it * per_tile;
    if (sub < nc) {
      stage_cols<DC, TM>(y, q, d_in, sub * DC, row0, n, qv);
      stage_cols<DC, TN>(y + TM * RC, K, d_in, sub * DC, it * TN, m_patterns, kv);
    } else {
      stage_cols<CW, TN>(y, U, d_out, col0, it * TN, m_patterns, uv);
    }
    cp_async_commit();
  };
  stage_item(0, 0);

  float m_r[2], l_r[2], l_lo[2], acc[CO][4], sc[NT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) m_r[e] = MASKED, l_r[e] = 0.f, l_lo[e] = 0.f;
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  zero(sc);

  for (int i = 0; i < items; ++i) {
    const int u = i & 1;
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    if (i + 1 < items) stage_item(i + 1, u ^ 1);
    const float* y = buf + u * SLOT;
    const int it = i / per_tile, sub = i - it * per_tile;
    if (sub < nc) {
      if (sub == 0) zero(sc);
      chunk_product(sc, y, m0, gq, tq);
      continue;
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

    // ---- P U over the window, into fresh fragments
    float o[CO][4];
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (p_lo + 8 * j >= m_patterns) continue;
      const FragA pa = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
#pragma unroll
      for (int c = 0; c < CO; ++c) mma3(o[c], pa, load_b_cols<RW>(y + 8 * j * RW + 8 * c, gq, tq));
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

// Launch the wide forward over the built q (n, d_in); see Epilogue.
template <int MODE>
cudaError_t launch_fwd_wide(const float* q, const float* K, const float* U, const float* bias, float* out,
                            float* m, float* l, float* zn, int n, int m_patterns, int d_in, int d_out, float beta,
                            float levels, cudaStream_t stream) {
  auto kernel = stream_fwd_wide_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(BYTES));
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(q, d_in) | vec16_ok(K, d_in) << 1 | vec16_ok(U, d_out) << 2;
  kernel<<<dim3((n + TM - 1) / TM, windows(d_out)), THREADS, BYTES, stream>>>(
      q, K, U, bias, out, m, l, zn, n, m_patterns, d_in, d_out, beta, levels, vec16);
  return cudaGetLastError();
}

}  // namespace hopfield_wide
