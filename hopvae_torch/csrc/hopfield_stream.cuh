// Pieces shared by the streaming Hopfield kernels: the forward K1
// (hopfield_stream_fwd.cu), the backward K2 (hopfield_stream_bwd_dx.cu)
// and K3 (hopfield_stream_bwd_dku.cu), and the fused bottleneck forward K4
// (hopfield_bottleneck_fused.cu). K2 and K3 rebuild the attention from the
// row stats m and l that K1 wrote, so all four build q with the same code
// here: the state LayerNorm in double over the real width, rounded once to
// f32, four lanes a row. K1's and K4's pattern walk is in
// hopfield_stream_fwd.cuh; the variants past MAX_WIDTH in hopfield_wide.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_tf32.cuh"

namespace hopfield_stream {

constexpr float LN_EPS = 1e-5f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WIDTH = 256;  // the widest d_in or d_out of a built instance (past it: hopfield_wide.cuh)

// the tensor cores' width of a real width: the next of 8, 16, 32, 64, 128, 256
__host__ __device__ constexpr int padded_width(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// sum over the 4 lanes of one row; the same in each of them
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// The state LayerNorm's mean and inv = 1/sqrt(var + eps) of one row over
// its real width d, in double. Lanes 4r..4r+3 share the row, each its
// columns k = part (mod 4); every lane ends with the same two values.
// With d = 3, a row whose values nearly agree loses most digits of
// x - mean in f32, hence the double.
__device__ __forceinline__ void ln_stats(const float* row, int d, int part, double& mean, double& inv) {
  double sum = 0.0;
  for (int k = part; k < d; k += 4) sum += row[k];
  mean = quad_sum(sum) / d;
  double var = 0.0;
  for (int k = part; k < d; k += 4) {
    const double c = row[k] - mean;
    var += c * c;
  }
  inv = 1.0 / sqrt(quad_sum(var) / d + static_cast<double>(LN_EPS));
}

// LayerNorm of the ROWS rows of a tile in place, row stride S, over the
// real width d: q = (x - mean) * inv * s + t. All NT threads call it, 4
// lanes a row, NT / 4 rows at a time. Columns d and up are left as they
// are (the callers stage zeros there, so q reads 0 in them).
template <int ROWS, int S, int NT>
__device__ __forceinline__ void layer_norm_rows(float* q_s, int d, const float* __restrict__ s,
                                                const float* __restrict__ t) {
  static_assert(ROWS % (NT / 4) == 0, "every lane takes part in each pass");
  const int part = threadIdx.x & 3;
#pragma unroll 1
  for (int r = threadIdx.x >> 2; r < ROWS; r += NT / 4) {
    float* row = q_s + r * S;
    double mean, inv;
    ln_stats(row, d, part, mean, inv);
    for (int k = part; k < d; k += 4) row[k] = static_cast<float>((row[k] - mean) * inv * s[k] + t[k]);
  }
}

// Rows [row0, row0 + ROWS) of a row-major (rows, d) f32 array into a
// ROWS x (PD + 4) tile of shared memory by cp.async (the caller commits
// and waits); columns d..PD - 1 and rows past `rows` are zero-filled.
// ld: the source's row stride, if not d (a window of d columns of wider
// rows). vec16: 16-byte copies, for a base on 16 bytes and d and the
// stride multiples of 4.
template <int PD, int ROWS, int NT>
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src, int d, int row0, int rows,
                                            bool vec16, int ld = 0) {
  constexpr int RS = PD + 4;
  const size_t stride = ld ? ld : d;
  if (vec16) {
    constexpr int CH = PD / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH;
      const int c = (i - r * CH) * 4;
      const bool in = row0 + r < rows && c < d;
      tf32x3::cp_async16(dst + r * RS + c, in ? src + (row0 + r) * stride + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * PD; i += NT) {
      const int r = i / PD;
      const int c = i - r * PD;
      const bool in = row0 + r < rows && c < d;
      tf32x3::cp_async4(dst + r * RS + c, in ? src + (row0 + r) * stride + c : src, in);
    }
  }
}

inline bool vec16_ok(const float* p, int d) { return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 4 == 0; }

// Blocks of `kernel` the card runs at once (blocks an SM times SMs), with
// `bytes` of dynamic shared memory, whose limit it sets; 0 on an error.
template <typename Kernel>
int concurrent_blocks(Kernel kernel, int threads, size_t bytes) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// The calls K1, K2 and K3 take on their built instances: a token and a
// pattern at least, and widths from 1 to MAX_WIDTH.
inline bool takes(int n, int m_patterns, int d_in, int d_out) {
  return n > 0 && m_patterns > 0 && d_in >= 1 && d_in <= MAX_WIDTH && d_out >= 1 && d_out <= MAX_WIDTH;
}

// f(pi, po) with the padded widths of d_in and d_out as
// std::integral_constant<int, ...> arguments: the dispatch of the 28
// instances of a K1, K2 or K3 kernel. While both widths are at most 128,
// each pads to the next of 8, 16, 32, 64, 128 (25 instances); past 128 a
// side pads to 256 and the other to 8 or 256 (3 more, not the 11 of every
// pair: each instance lengthens the build). The caller checks takes().
template <int PI, typename F>
auto with_out_width(int d_out, F&& f) {
  switch (padded_width(d_out)) {
    case 8: return f(std::integral_constant<int, PI>{}, std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, PI>{}, std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, PI>{}, std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, PI>{}, std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, PI>{}, std::integral_constant<int, 128>{});
  }
}

template <typename F>
auto with_widths(int d_in, int d_out, F&& f) {
  if (d_in > 128 || d_out > 128) {
    if (d_in <= 8) return f(std::integral_constant<int, 8>{}, std::integral_constant<int, 256>{});
    if (d_out <= 8) return f(std::integral_constant<int, 256>{}, std::integral_constant<int, 8>{});
    return f(std::integral_constant<int, 256>{}, std::integral_constant<int, 256>{});
  }
  switch (padded_width(d_in)) {
    case 8: return with_out_width<8>(d_out, f);
    case 16: return with_out_width<16>(d_out, f);
    case 32: return with_out_width<32>(d_out, f);
    case 64: return with_out_width<64>(d_out, f);
    default: return with_out_width<128>(d_out, f);
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
