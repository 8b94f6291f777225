// The streaming Hopfield kernels past a width of 256: the pieces that the
// wide variants of K1 (hopfield_stream_fwd.cu), K2
// (hopfield_stream_bwd_dx.cu), K3 (hopfield_stream_bwd_dku.cu) and K4
// (hopfield_bottleneck_fused.cu) share with the clusters
// (hopfield_cluster.cuh) and the narrow-side kernels (hopfield_narrow.cuh):
// the query build and the epilogues of the forward.
//
// The built instances (hopfield_stream.cuh, with_widths) keep 64 rows of
// q resident at the padded width and cap an output window at 128 columns;
// past 256 that no longer fits 227 KB beside two streamed buffers, and a
// warp's outputs would take too many registers. The wide variants
// therefore build q = LN(x) * s + t of every token first (build_queries),
// the LayerNorm statistics in double over the full d_in, with the
// arithmetic of layer_norm_rows, so the same bits; then the cluster
// kernels split the depth across the blocks of a cluster (up to 8192 on
// the wider side, d_in past 128; K1 also d_out past 128), and elsewhere
// the narrow-side kernels of K1, K2, K3 and K4's stages size their output
// window to the narrow side and stream the depth in parts of 64 columns.
// The former window kernels, which padded every product's depth to chunks of
// 64 and every output to windows of 128, each window recomputing the
// scores, are gone: the narrow-side kernels keep their parts and order.

#pragma once

#include <algorithm>

#include "hopfield_stream.cuh"

namespace hopfield_wide {

using namespace hopfield_stream;
using namespace tf32x3;

// whether a lookup of widths (d_in, d_out) takes the wide variants
__host__ __device__ inline bool wide(int d_in, int d_out) { return d_in > MAX_WIDTH || d_out > MAX_WIDTH; }

constexpr int Q_ROWS = 32;  // token rows of a block of build_queries
constexpr int Q_THREADS = 4 * Q_ROWS;

// Wait until at most `pending` of this thread's groups of copies are in
// flight (cp.async.wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// build_queries' chunk of QC columns: floats of a buffer (the block's
// rows, then the chunk's s and t) and buffers at most (227 KB)
template <int QC>
struct QueryChunk {
  static constexpr int RS = QC + 4;
  static constexpr int BUF = Q_ROWS * RS + 2 * QC;
  static constexpr int RING = QC == 128 ? 8 : 3;
  static_assert(RING * BUF * 4 <= 232448, "the ring fits shared memory");
};
// the chunk of rows of d: 512 columns past 1,024 (fewer chunks, fewer
// barriers), else 128 (a ring of 128 leaves room for more blocks an SM)
inline int query_chunk(int d) { return d > 1024 ? 512 : 128; }
// the widest row that build_queries reads from device memory directly: a
// staged chunk of 128 columns with 3 live ones, in three passes behind
// block barriers, made K2 at (3, 384), N 4,096, about 6% slower on an
// H100 (PERF.md)
constexpr int Q_DIRECT = 128;

// q = LN(x) * s + t of every row of x (n, d <= Q_DIRECT) into q (n, d), 4
// lanes a row reading x from device memory, with layer_norm_rows'
// arithmetic; and, where il is given, il = 1 / l. Rows past n compute on
// row n - 1 (the shuffles need the whole warp) and write nothing.
__global__ void __launch_bounds__(Q_THREADS)
build_queries_direct_kernel(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ t,
                            int n, int d, float* __restrict__ q, const float* __restrict__ l_in,
                            float* __restrict__ il) {
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

// q = LN(x) * s + t of every row of x (n, d > Q_DIRECT) into q (n, d), 4
// lanes a row, with layer_norm_rows' arithmetic; and, where il is given,
// il = 1 / l. A lane's sum is a chain of d / 4 adds in double. Read from device memory
// a column at a time, with s and t read there too for the write, a row of
// 8,320 took about 0.4 ms on an H100 (PERF.md): every step waited on its
// load. So the block stages its rows a chunk of QC columns at a time (and,
// for the write, the chunk's s and t) by cp.async into a ring of `nbuf`
// buffers (dynamic shared memory), nbuf - 1 chunks in flight while the
// lanes run the current one from shared memory, its steps unrolled, in
// three passes (the sum, the squares, the write). Each lane adds its
// columns in ln_stats' order: the same sums, the same bits. Rows past n
// compute on row n - 1 (the shuffles need the whole warp) and write
// nothing.
template <int QC>
__global__ void __launch_bounds__(Q_THREADS)
build_queries_kernel(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ t, int n,
                     int d, float* __restrict__ q, const float* __restrict__ l_in, float* __restrict__ il, int nbuf,
                     bool vec16) {
  using C = QueryChunk<QC>;
  constexpr int STEPS = QC / 4;  // a lane's columns of a whole chunk
  extern __shared__ float4 qsm4[];
  float* xs = reinterpret_cast<float*>(qsm4);  // chunk c in buffer c % nbuf, at xs + (c % nbuf) C::BUF
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int row0 = blockIdx.x * Q_ROWS;
  const int row = row0 + r;
  const int chunks = (d + QC - 1) / QC;
  auto stage = [&](int c, bool st) {
    if (c < chunks) {
      float* dst = xs + (c % nbuf) * C::BUF;
      const int c0 = c * QC;
      for (int i = threadIdx.x; i < Q_ROWS * QC / 4; i += Q_THREADS) {
        const int rr = i / (QC / 4), cc = i % (QC / 4) * 4;
        const float* src = x + static_cast<size_t>(min(row0 + rr, n - 1)) * d + c0 + cc;
        if (vec16) {
          tf32x3::cp_async16(dst + rr * C::RS + cc, c0 + cc < d ? src : x, c0 + cc < d);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tf32x3::cp_async4(dst + rr * C::RS + cc + j, c0 + cc + j < d ? src + j : x, c0 + cc + j < d);
        }
      }
      if (st) {  // the chunk's s and t, for the write
        for (int i = threadIdx.x; i < 2 * QC; i += Q_THREADS) {
          const int k = c0 + i % QC;
          const float* src = i < QC ? s : t;
          tf32x3::cp_async4(dst + Q_ROWS * C::RS + i, k < d ? src + k : src, k < d);
        }
      }
    }
    tf32x3::cp_async_commit();
  };
  double sum = 0.0, var = 0.0, mean = 0.0, inv = 0.0;
  for (int pass = 0; pass < 3; ++pass) {
    for (int c = 0; c < nbuf - 1; ++c) stage(c, pass == 2);
    for (int c = 0; c < chunks; ++c) {
      stage(c + nbuf - 1, pass == 2);
      cp_async_wait_pending(nbuf - 1);
      __syncthreads();  // chunk c has landed
      const float* buf = xs + (c % nbuf) * C::BUF;
      const float* xr = buf + r * C::RS + part;  // the lane's columns: xr[4i]
      const int c0 = c * QC, cols = min(QC, d - c0);
      const int steps = cols == QC ? STEPS : (cols - part + 3) / 4;
      if (pass == 0) {
        if (steps == STEPS) {
#pragma unroll
          for (int i = 0; i < STEPS; ++i) sum += xr[4 * i];
        } else {
          for (int i = 0; i < steps; ++i) sum += xr[4 * i];
        }
      } else if (pass == 1) {
        auto add = [&](int i) {
          const double cv = xr[4 * i] - mean;
          var += cv * cv;
        };
        if (steps == STEPS) {
#pragma unroll
          for (int i = 0; i < STEPS; ++i) add(i);
        } else {
          for (int i = 0; i < steps; ++i) add(i);
        }
      } else if (row < n) {
        const float* sc = buf + Q_ROWS * C::RS + part;
        float* qr = q + static_cast<size_t>(row) * d + c0 + part;
#pragma unroll 8
        for (int i = 0; i < steps; ++i)
          qr[4 * i] = static_cast<float>((xr[4 * i] - mean) * inv * sc[4 * i] + sc[QC + 4 * i]);
      }
      __syncthreads();  // every lane is done with chunk c's buffer
    }
    tf32x3::cp_async_wait_all();  // the empty groups past the last chunk
    if (pass == 0) mean = quad_sum(sum) / d;
    if (pass == 1) inv = 1.0 / sqrt(quad_sum(var) / d + static_cast<double>(LN_EPS));
  }
  if (row < n && il != nullptr && part == 0) il[row] = 1.f / l_in[row];
}

template <int QC>
cudaError_t launch_build_queries(const float* x, const float* s, const float* t, int n, int d, float* q,
                                 const float* l_in, float* il, cudaStream_t stream) {
  using C = QueryChunk<QC>;
  const int nbuf = std::min(C::RING, std::max(2, (d + QC - 1) / QC + 1));  // one more than the chunks of a row
  const int bytes = static_cast<int>(sizeof(float)) * nbuf * C::BUF;
  auto kernel = build_queries_kernel<QC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n + Q_ROWS - 1) / Q_ROWS, Q_THREADS, bytes, stream>>>(x, s, t, n, d, q, l_in, il, nbuf, vec16_ok(x, d));
  return cudaGetLastError();
}

inline cudaError_t build_queries(const float* x, const float* s, const float* t, int n, int d, float* q,
                                 const float* l_in, float* il, cudaStream_t stream) {
  if (d <= Q_DIRECT) {
    build_queries_direct_kernel<<<(n + Q_ROWS - 1) / Q_ROWS, Q_THREADS, 0, stream>>>(x, s, t, n, d, q, l_in, il);
    return cudaGetLastError();
  }
  return query_chunk(d) == 512 ? launch_build_queries<512>(x, s, t, n, d, q, l_in, il, stream)
                               : launch_build_queries<128>(x, s, t, n, d, q, l_in, il, stream);
}

// What the wide forward (the narrow-side kernel of hopfield_narrow.cuh,
// or the cluster's in hopfield_cluster.cuh) writes for out = softmax(beta
// q K^T) U / l: PLAIN (K1) out, and m and l; SHIFT (K4's e and r) out +
// b; QUANTIZE (K4's zq) rint(sigmoid(out + b) * levels), and zq / levels
// into zn.
enum Epilogue { PLAIN, SHIFT, QUANTIZE };

}  // namespace hopfield_wide
