// Streaming modern-Hopfield lookup, backward for the token side, for
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
// What bounds it on an H100: arithmetic, 2*N*M*(2*d_in + d_out) FLOPs (the
// score product, g U^T, and dS K) and N*M exps, against reading x, g, the
// row stats and the tables once and writing dx.
//
// Design:
// - The token side is K1's: one block of 256 threads takes 64 token rows,
//   keeps q and g in shared memory and walks the pattern axis in tiles of
//   64 (the loop that stands in for the TPU grid's sequential j axis).
//   Thread (ty, tx) owns rows ty*4+i and patterns tx+16*j. q and the
//   scores come from hopfield_stream.cuh, with K1's arithmetic, so
//   exp(sc - m) / l rebuilds the forward's rows. Rows >= N and patterns >= M are masked
//   to A = 0 here; the caller pads nothing.
// - dq: for d_in = 64, dS goes through shared memory (transposed) and each
//   thread accumulates a 4x4 block of dq; for d_in = 3, each thread keeps
//   a 4x3 partial over its own patterns, summed over the half-warp once
//   at the end. g U^T for d_out = 3 is 3 FMAs deep; nothing is padded.
// - The LayerNorm backward runs at the row end, in double like the
//   forward's LayerNorm (inv reaches 1/sqrt(eps) on flat rows), 4 lanes a
//   row.
// - ds and dt: the TPU sums them into one resident block across the
//   sequential token grid. Here each block writes its own partial row
//   (summed over its rows in a fixed order), and a second pass sums the
//   partial rows in the order of the blocks. No float atomics: the result
//   has the same bits in every run.
// - Plain f32 FMA on the CUDA cores.

#include "hopfield_stream.cuh"

namespace {

using namespace hopfield_stream;

template <int D_IN, int D_OUT>
struct Layout {
  static constexpr int QS = stride_of<D_IN>();   // q rows, K rows, dq rows
  static constexpr int GS = stride_of<D_OUT>();  // g rows, U rows
  static constexpr int PS = BLOCK_N + 4;          // transposed dS
  static constexpr bool WIDE_IN = D_IN % 4 == 0;
  static constexpr int FLOATS = BLOCK_N * QS + BLOCK_N * GS + BLOCK_M * QS + BLOCK_M * GS +
                                (WIDE_IN ? BLOCK_M * PS : 0);
  static constexpr size_t STAT_BYTES = 2 * BLOCK_N * sizeof(double);  // row mean and inv
  static constexpr size_t BYTES = STAT_BYTES + sizeof(float) * FLOATS;
};

template <int D_IN, int D_OUT>
__global__ void __launch_bounds__(THREADS, 2)
stream_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ K,
                     const float* __restrict__ U, const float* __restrict__ s,
                     const float* __restrict__ t, const float* __restrict__ g,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta, float* __restrict__ dx,
                     float* __restrict__ ds_part, float* __restrict__ dt_part, int n,
                     int m_patterns, float beta) {
  using L = Layout<D_IN, D_OUT>;
  constexpr int QS = L::QS;
  constexpr int GS = L::GS;
  constexpr bool WIDE_IN = L::WIDE_IN;
  static_assert(!WIDE_IN || D_IN == 4 * 16, "a wide dq is 16 threads x 4 columns");
  constexpr int ACC_W = WIDE_IN ? 4 : D_IN;

  extern __shared__ float4 smem4[];
  double* mean_s = reinterpret_cast<double*>(smem4);
  double* inv_s = mean_s + BLOCK_N;
  float* q_s = reinterpret_cast<float*>(inv_s + BLOCK_N);
  float* g_s = q_s + BLOCK_N * QS;
  float* k_s = g_s + BLOCK_N * GS;
  float* u_s = k_s + BLOCK_M * QS;
  float* p_s = u_s + BLOCK_M * GS;  // WIDE_IN only: p_s[pattern][row]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BLOCK_N;
  const int rows_here = min(BLOCK_N, n - row0);

  stage_rows<D_IN, QS>(q_s, x, row0, rows_here);
  stage_rows<D_OUT, GS>(g_s, g, row0, rows_here);
  __syncthreads();
  layer_norm_rows<D_IN, QS>(q_s, s, t, mean_s, inv_s);

  // row stats; rows past N get A = 0, so their dS and dq are 0
  float m_r[4], il_r[4], dl_r[4], acc[4][ACC_W];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const bool live = r < rows_here;
    m_r[i] = live ? m_in[row0 + r] : 0.f;
    il_r[i] = live ? 1.f / l_in[row0 + r] : 0.f;
    dl_r[i] = live ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < ACC_W; ++c) acc[i][c] = 0.f;
  }

  for (int p0 = 0; p0 < m_patterns; p0 += BLOCK_M) {
    const int pats = min(BLOCK_M, m_patterns - p0);
    stage_rows<D_IN, QS>(k_s, K, p0, pats);
    stage_rows<D_OUT, GS>(u_s, U, p0, pats);
    __syncthreads();

    float sc[4][4], da[4][4];
    tile_products<D_IN, QS>(q_s, k_s, ty, tx, sc);
    tile_products<D_OUT, GS>(g_s, u_s, ty, tx, da);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = (tx + 16 * j) < pats && ty * 4 + i < rows_here;
        const float a = live ? __expf(sc[i][j] * beta - m_r[i]) * il_r[i] : 0.f;
        sc[i][j] = a * (da[i][j] - dl_r[i]) * beta;  // dS
      }

    // ---- dq += dS @ K
    if constexpr (WIDE_IN) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * L::PS + ty * 4) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < BLOCK_M; ++jj) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + jj * L::PS + ty * 4);
        const float4 kv = *reinterpret_cast<const float4*>(k_s + jj * QS + tx * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(pr[i], kv.x, acc[i][0]);
          acc[i][1] = fmaf(pr[i], kv.y, acc[i][1]);
          acc[i][2] = fmaf(pr[i], kv.z, acc[i][2]);
          acc[i][3] = fmaf(pr[i], kv.w, acc[i][3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* krow = k_s + (tx + 16 * j) * QS;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < D_IN; ++c) acc[i][c] = fmaf(sc[i][j], krow[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s, u_s and p_s
  }

  // ---- dq into q_s (q is no longer read)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if constexpr (WIDE_IN) {
      *reinterpret_cast<float4*>(q_s + r * QS + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < D_IN; ++c) acc[i][c] = half_warp_sum(acc[i][c]);
      if (tx == 0) {
#pragma unroll
        for (int c = 0; c < D_IN; ++c) q_s[r * QS + c] = acc[i][c];
      }
    }
  }
  __syncthreads();

  // ---- LayerNorm backward in double, 4 lanes a row; dq * xhat into k_s
  {
    const int r = tid >> 2;
    const int part = tid & 3;
    const bool live = r < rows_here;
    const double mean = mean_s[r];
    const double inv = inv_s[r];
    const float* xrow = x + static_cast<size_t>(row0 + r) * D_IN;
    double m1 = 0.0, m2 = 0.0;
    for (int k = part; k < D_IN; k += 4) {
      const double xhat = ((live ? xrow[k] : 0.f) - mean) * inv;
      const double dxh = static_cast<double>(q_s[r * QS + k]) * s[k];
      m1 += dxh;
      m2 += dxh * xhat;
    }
    m1 = quad_sum(m1) / D_IN;
    m2 = quad_sum(m2) / D_IN;
    for (int k = part; k < D_IN; k += 4) {
      const double xhat = ((live ? xrow[k] : 0.f) - mean) * inv;
      const double dq = q_s[r * QS + k];
      if (live) dx[static_cast<size_t>(row0 + r) * D_IN + k] =
          static_cast<float>(inv * (dq * s[k] - m1 - xhat * m2));
      k_s[r * QS + k] = live ? static_cast<float>(dq * xhat) : 0.f;
    }
  }
  __syncthreads();

  // ---- this block's partial rows of ds and dt, summed over its rows in order
  if (tid < D_IN) {
    double ds_acc = 0.0, dt_acc = 0.0;
    for (int r = 0; r < BLOCK_N; ++r) {
      ds_acc += k_s[r * QS + tid];
      dt_acc += q_s[r * QS + tid];  // rows past N hold dq = 0
    }
    ds_part[static_cast<size_t>(blockIdx.x) * D_IN + tid] = static_cast<float>(ds_acc);
    dt_part[static_cast<size_t>(blockIdx.x) * D_IN + tid] = static_cast<float>(dt_acc);
  }
}

template <int D_IN, int D_OUT>
int launch(const float* x, const float* K, const float* U, const float* s, const float* t,
           const float* g, const float* m, const float* l, const float* delta, float* dx,
           float* ds, float* dt, float* workspace, int n, int m_patterns, cudaStream_t stream) {
  using L = Layout<D_IN, D_OUT>;
  auto kernel = stream_bwd_dx_kernel<D_IN, D_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK_N - 1) / BLOCK_N;
  float* ds_part = workspace;
  float* dt_part = workspace + static_cast<size_t>(blocks) * D_IN;
  kernel<<<blocks, THREADS, L::BYTES, stream>>>(x, K, U, s, t, g, m, l, delta, dx, ds_part,
                                                 dt_part, n, m_patterns, beta_of(D_IN));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_rows(ds_part, blocks, D_IN, ds, stream);
  if (err != cudaSuccess) return err;
  return sum_rows(dt_part, blocks, D_IN, dt, stream);
}

}  // namespace

// Floats of device scratch that hopfield_stream_bwd_dx needs for n tokens
// of width d_in: one partial row of ds and one of dt for each 64 tokens.
extern "C" long long hopfield_stream_bwd_dx_workspace(int n, int d_in) {
  return 2LL * ((n + hopfield_stream::BLOCK_N - 1) / hopfield_stream::BLOCK_N) * d_in;
}

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), g (n, d_out), m, l and delta (n),
// dx (n, d_in), ds and dt (d_in), and workspace (see above). Launches the
// kernel and the fixed-order sum of the partial rows on `stream`.
// Returns a cudaError_t; 0 means both launches were accepted.
extern "C" int hopfield_stream_bwd_dx(const float* x, const float* K, const float* U,
                                      const float* s, const float* t, const float* g,
                                      const float* m, const float* l, const float* delta,
                                      float* dx, float* ds, float* dt, float* workspace, int n,
                                      int m_patterns, int d_in, int d_out, void* stream) {
  if (n <= 0 || m_patterns <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_in == 64 && d_out == 64)
    return launch<64, 64>(x, K, U, s, t, g, m, l, delta, dx, ds, dt, workspace, n, m_patterns, st);
  if (d_in == 64 && d_out == 3)
    return launch<64, 3>(x, K, U, s, t, g, m, l, delta, dx, ds, dt, workspace, n, m_patterns, st);
  if (d_in == 3 && d_out == 64)
    return launch<3, 64>(x, K, U, s, t, g, m, l, delta, dx, ds, dt, workspace, n, m_patterns, st);
  return cudaErrorInvalidValue;
}
