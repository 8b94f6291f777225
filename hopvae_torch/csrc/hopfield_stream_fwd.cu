// Streaming modern-Hopfield lookup, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stream_fwd_kernel` of
// hopvae_tpu/ops/hopfield_pallas.py (launched by `_attn_call_fwd`). For
// a token matrix x (N, d_in) and the folded pattern tables K (M, d_in),
// U (M, d_out) it computes, per token row,
//
//     q   = LN(x) * s + t                 LayerNorm over the real d_in
//     sc  = beta * q K^T,  beta = 1/sqrt(d_in)
//     m   = max_j sc_j,   l = sum_j exp(sc_j - m)
//     out = sum_j exp(sc_j - m) U_j / l
//
// and writes out, m and l (the row stats are what the backward kernels
// and a pattern-sharded log-sum-exp merge reuse). The caller adds the
// output shift b.
//
// What bounds it on an H100: arithmetic. Per lookup it does
// 2*N*M*(d_in+d_out) FLOPs and N*M exps, while it must move only
// x, out, m, l and the two tables (at most ~1 MB each); at N = 73,984,
// M = 4096 that is 77.6 GFLOP for d_in = d_out = 64 against ~40 MB.
//
// Design:
// - One block of 256 threads takes BLOCK_N = 64 token rows. It runs the
//   LayerNorm once and keeps q in shared memory for the whole pattern loop.
// - The block walks the pattern axis in tiles of BLOCK_M = 64 (the loop
//   that stands in for the TPU grid's sequential j axis), staging each K
//   and U tile in shared memory. Rows >= M are masked to -1e30 here; the
//   caller pads nothing.
// - Thread (ty, tx) of the 16x16 grid owns rows ty*4+i and the tile's
//   patterns tx+16*j (i, j < 4). The 16 threads that share a row are one
//   half-warp, so the row max and row sum are xor-shuffles over 16 lanes.
//   Each row keeps a running max, a denominator and an f32 accumulator.
// - d_out = 64: the probabilities go through shared memory (transposed)
//   and each thread accumulates a 4x4 block of out. d_out = 3: each
//   thread keeps a 4x3 partial over its own patterns (all of a row's
//   partials share the same running max, so they rescale alike) and the
//   partials are summed over the half-warp once, at the end.
// - Plain f32 FMA on the CUDA cores; widths of 3 need no padding. Rows
//   of width 64 are read as float4 from shared memory with a row stride
//   of 68 floats, which keeps those reads free of bank conflicts.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int BLOCK_N = 64;
constexpr int BLOCK_M = 64;
constexpr int THREADS = 256;
constexpr float LN_EPS = 1e-5f;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory row stride: widths that are float4 multiples get +4
// floats, which offsets consecutive rows by 4 banks
template <int D>
constexpr int stride_of() { return (D % 4 == 0) ? D + 4 : D; }

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

template <int D_IN, int D_OUT>
struct Layout {
  static constexpr int QS = stride_of<D_IN>();   // q rows and K rows
  static constexpr int PS = BLOCK_N + 4;          // transposed probabilities
  static constexpr bool WIDE_OUT = D_OUT % 4 == 0;
  static constexpr int FLOATS =
      BLOCK_N * QS + BLOCK_M * QS + BLOCK_M * D_OUT + (WIDE_OUT ? BLOCK_M * PS : 0);
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int D_IN, int D_OUT>
__global__ void __launch_bounds__(THREADS, 2)
stream_fwd_kernel(const float* __restrict__ x, const float* __restrict__ K,
                  const float* __restrict__ U, const float* __restrict__ s,
                  const float* __restrict__ t, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int n, int m_patterns, float beta) {
  using L = Layout<D_IN, D_OUT>;
  constexpr int QS = L::QS;
  constexpr bool WIDE_OUT = L::WIDE_OUT;
  static_assert(!WIDE_OUT || D_OUT == 4 * 16, "a wide output is 16 threads x 4 columns");
  constexpr int ACC_W = WIDE_OUT ? 4 : D_OUT;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BLOCK_N * QS;
  float* u_s = k_s + BLOCK_M * QS;
  float* p_s = u_s + BLOCK_M * D_OUT;  // WIDE_OUT only: p_s[pattern][row]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BLOCK_N;
  const int rows_here = min(BLOCK_N, n - row0);

  // ---- stage the x tile (one contiguous chunk) and LayerNorm it in place
  for (int idx = tid; idx < BLOCK_N * D_IN; idx += THREADS) {
    const int r = idx / D_IN;
    const int k = idx - r * D_IN;
    q_s[r * QS + k] = r < rows_here ? x[static_cast<size_t>(row0) * D_IN + idx] : 0.f;
  }
  __syncthreads();
  if (tid < BLOCK_N) {
    // in double, then rounded once to f32: with d_in = 3, a row whose
    // values nearly agree loses most digits of x - mean in f32, and the
    // plain version (which does the same) would then disagree in them
    float* row = q_s + tid * QS;
    double mean = 0.0;
#pragma unroll 8
    for (int k = 0; k < D_IN; ++k) mean += row[k];
    mean /= D_IN;
    double var = 0.0;
#pragma unroll 8
    for (int k = 0; k < D_IN; ++k) {
      const double c = row[k] - mean;
      var += c * c;
    }
    var /= D_IN;
    const double inv = 1.0 / sqrt(var + static_cast<double>(LN_EPS));
#pragma unroll 8
    for (int k = 0; k < D_IN; ++k)
      row[k] = static_cast<float>((row[k] - mean) * inv * s[k] + t[k]);
  }
  // the first tile's barrier below orders these writes before any read

  float m_run[4], l_run[4], acc[4][ACC_W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = MASKED;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ACC_W; ++c) acc[i][c] = 0.f;
  }

  for (int p0 = 0; p0 < m_patterns; p0 += BLOCK_M) {
    const int pats = min(BLOCK_M, m_patterns - p0);
    for (int idx = tid; idx < BLOCK_M * D_IN; idx += THREADS) {
      const int c = idx / D_IN;
      const int k = idx - c * D_IN;
      k_s[c * QS + k] = c < pats ? K[static_cast<size_t>(p0) * D_IN + idx] : 0.f;
    }
    for (int idx = tid; idx < BLOCK_M * D_OUT; idx += THREADS)
      u_s[idx] = idx < pats * D_OUT ? U[static_cast<size_t>(p0) * D_OUT + idx] : 0.f;
    __syncthreads();

    // ---- scores: rows ty*4+i against patterns tx+16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;

    if constexpr (D_IN % 4 == 0) {
#pragma unroll 4
      for (int k = 0; k < D_IN; k += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * QS + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * QS + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = sc[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            sc[i][j] = a;
          }
      }
    } else {
#pragma unroll
      for (int k = 0; k < D_IN; ++k) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QS + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

    // ---- online softmax: scale, mask, running max and denominator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = (tx + 16 * j) < pats ? sc[i][j] * beta : MASKED;
        sc[i][j] = v;
        mt = fmaxf(mt, v);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mt));
      const float rescale = __expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(sc[i][j] - m_new);
        sc[i][j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * rescale + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < ACC_W; ++c) acc[i][c] *= rescale;
    }

    // ---- acc += p @ U
    if constexpr (WIDE_OUT) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * L::PS + ty * 4) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < BLOCK_M; ++jj) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + jj * L::PS + ty * 4);
        const float4 uv = *reinterpret_cast<const float4*>(u_s + jj * D_OUT + tx * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(pr[i], uv.x, acc[i][0]);
          acc[i][1] = fmaf(pr[i], uv.y, acc[i][1]);
          acc[i][2] = fmaf(pr[i], uv.z, acc[i][2]);
          acc[i][3] = fmaf(pr[i], uv.w, acc[i][3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* urow = u_s + (tx + 16 * j) * D_OUT;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < D_OUT; ++c) acc[i][c] = fmaf(sc[i][j], urow[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s, u_s and p_s
  }

  // ---- epilogue: out = acc / l, and the row stats
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if constexpr (!WIDE_OUT) {
#pragma unroll
      for (int c = 0; c < D_OUT; ++c) acc[i][c] = half_warp_sum(acc[i][c]);
    }
    if (r >= rows_here) continue;
    const size_t row = static_cast<size_t>(row0 + r);
    if constexpr (WIDE_OUT) {
      *reinterpret_cast<float4*>(out + row * D_OUT + tx * 4) =
          make_float4(acc[i][0] / l_run[i], acc[i][1] / l_run[i],
                      acc[i][2] / l_run[i], acc[i][3] / l_run[i]);
    } else if (tx == 0) {
#pragma unroll
      for (int c = 0; c < D_OUT; ++c) out[row * D_OUT + c] = acc[i][c] / l_run[i];
    }
    if (tx == 0) {
      m_out[row] = m_run[i];
      l_out[row] = l_run[i];
    }
  }
}

template <int D_IN, int D_OUT>
int launch(const float* x, const float* K, const float* U, const float* s, const float* t,
           float* out, float* m, float* l, int n, int m_patterns, cudaStream_t stream) {
  using L = Layout<D_IN, D_OUT>;
  auto kernel = stream_fwd_kernel<D_IN, D_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const float beta = static_cast<float>(1.0 / sqrt(static_cast<double>(D_IN)));
  const dim3 grid((n + BLOCK_N - 1) / BLOCK_N);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(x, K, U, s, t, out, m, l, n, m_patterns, beta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), out (n, d_out), m and l (n).
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int hopfield_stream_fwd(const float* x, const float* K, const float* U,
                                   const float* s, const float* t, float* out, float* m,
                                   float* l, int n, int m_patterns, int d_in, int d_out,
                                   void* stream) {
  if (n <= 0 || m_patterns <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_in == 64 && d_out == 64) return launch<64, 64>(x, K, U, s, t, out, m, l, n, m_patterns, st);
  if (d_in == 64 && d_out == 3) return launch<64, 3>(x, K, U, s, t, out, m, l, n, m_patterns, st);
  if (d_in == 3 && d_out == 64) return launch<3, 64>(x, K, U, s, t, out, m, l, n, m_patterns, st);
  return cudaErrorInvalidValue;
}
