// Pieces shared by the streaming Hopfield backward kernels, K2
// (hopfield_stream_bwd_dx.cu) and K3 (hopfield_stream_bwd_dku.cu), and by
// the fused bottleneck forward K4 (hopfield_bottleneck_fused.cu). They
// rebuild the attention tile from the row stats m and l that the forward
// K1 (hopfield_stream_fwd.cu) wrote, so they compute q and the scores with
// K1's arithmetic: the state LayerNorm in double, rounded once to f32, and
// the same FMA order in the score product. K1 keeps its own inline copy of
// that code: built from these functions it ran slower at 64 -> 64 on an
// H100, from code generation alone (PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace hopfield_stream {

constexpr int BLOCK_N = 64;   // token rows per tile
constexpr int BLOCK_M = 64;   // patterns per tile
constexpr int THREADS = 256;  // a 16x16 grid; 4 threads per token row for the LayerNorm
constexpr float LN_EPS = 1e-5f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == 4 * BLOCK_N, "the LayerNorm gives each row 4 threads");
static_assert(BLOCK_M == BLOCK_N, "stage_rows stages token and pattern tiles alike");

// shared-memory row stride: widths that are float4 multiples get +4
// floats, which offsets consecutive rows by 4 banks
template <int D>
__host__ __device__ constexpr int stride_of() { return (D % 4 == 0) ? D + 4 : D; }

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// every lane ends with the same value: each step adds the same two
// operands in every lane, and float addition commutes
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// sum over the 4 lanes of one row; the same in each of them
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// dst[r][k] = src[row0 + r][k] for r < rows, 0 beyond; dst has row stride S
template <int D, int S>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0,
                                           int rows) {
  for (int idx = threadIdx.x; idx < BLOCK_N * D; idx += THREADS) {
    const int r = idx / D;
    const int k = idx - r * D;
    dst[r * S + k] = r < rows ? src[static_cast<size_t>(row0) * D + idx] : 0.f;
  }
}

// LayerNorm of the BLOCK_N rows of q_s in place, q = (x - mean) * inv * s + t
// with inv = 1/sqrt(var + eps), over the real width D. All THREADS threads
// call it: lanes 4r..4r+3 take row r, each its columns k = part (mod 4).
// It runs in double and rounds once: with D = 3, a row whose values nearly
// agree loses most digits of x - mean in f32. K1 sums a row in one thread,
// here four lanes share it (K3 redoes this for every token tile); the two
// double sums can differ in their last bits, and the rounded f32 q then
// differs from K1's only where a double lands that close to an f32
// rounding boundary. The row's mean and inv go to mean_out / inv_out when
// they are given.
template <int D, int S>
__device__ __forceinline__ void layer_norm_rows(float* q_s, const float* __restrict__ s,
                                                const float* __restrict__ t, double* mean_out,
                                                double* inv_out) {
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  float* row = q_s + r * S;
  double sum = 0.0;
  for (int k = part; k < D; k += 4) sum += row[k];
  const double mean = quad_sum(sum) / D;
  double var = 0.0;
  for (int k = part; k < D; k += 4) {
    const double c = row[k] - mean;
    var += c * c;
  }
  const double inv = 1.0 / sqrt(quad_sum(var) / D + static_cast<double>(LN_EPS));
  for (int k = part; k < D; k += 4) row[k] = static_cast<float>((row[k] - mean) * inv * s[k] + t[k]);
  if (part == 0 && mean_out != nullptr) {
    mean_out[r] = mean;
    inv_out[r] = inv;
  }
}

// acc[i][j] = sum_k a[ty*4+i][k] * b[tx+16j][k] over the width D, both
// tiles in shared memory with row stride S. Rows of a float4 width are
// read as float4.
template <int D, int S>
__device__ __forceinline__ void tile_products(const float* a_s, const float* b_s, int ty, int tx,
                                              float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if constexpr (D % 4 == 0) {
#pragma unroll 4
    for (int k = 0; k < D; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a_s + (ty * 4 + i) * S + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * S + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = acc[i][j];
          v = fmaf(av[i].x, bv[j].x, v);
          v = fmaf(av[i].y, bv[j].y, v);
          v = fmaf(av[i].z, bv[j].z, v);
          v = fmaf(av[i].w, bv[j].w, v);
          acc[i][j] = v;
        }
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * S + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * S + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// out[c] = sum over r < rows of part[r * cols + c], in the order of r and
// in double, rounded once: the fixed-order second pass that stands in for
// the TPU's sequential accumulation into one resident block
__global__ void sum_rows_kernel(const float* __restrict__ part, int rows, int cols,
                                float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  double acc = 0.0;
  for (int r = 0; r < rows; ++r) acc += part[static_cast<size_t>(r) * cols + c];
  out[c] = static_cast<float>(acc);
}

inline cudaError_t sum_rows(const float* part, int rows, int cols, float* out, cudaStream_t stream) {
  constexpr int T = 256;
  sum_rows_kernel<<<(cols + T - 1) / T, T, 0, stream>>>(part, rows, cols, out);
  return cudaGetLastError();
}

inline float beta_of(int d_in) { return static_cast<float>(1.0 / sqrt(static_cast<double>(d_in))); }

}  // namespace hopfield_stream
