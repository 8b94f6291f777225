// Single-shot fused Hopfield bottleneck, forward (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of hopvae_tpu/ops/hopfield_pallas.py
// (launched by `_bottleneck_fwd_pallas`). For a token matrix x (N, 64)
// and the folded tables (K_i, U_i, b_i) and state LayerNorms (s_i, t_i)
// of the three lookups, it computes per token row
//
//     e  = softmax(beta   * LN_1(x)  K_1^T) U_1 + b_1            64 -> 64
//     zq = rint(sigmoid(softmax(beta * LN_2(e) K_2^T) U_2 + b_2) * (L - 1))
//                                                                64 -> 3
//     r  = softmax(beta_i * LN_3(zq / (L - 1)) K_3^T) U_3 + b_3  3 -> 64
//
// with beta = 1/sqrt(64), beta_i = 1/sqrt(3), and writes e, zq and r. The
// round is half to even (rintf), as jnp.round and torch.round are.
//
// What bounds it on an H100: arithmetic. It does 2*N*M*(128 + 67 + 67)
// FLOPs and 3*N*M exps, and must move only x, the outputs and the six
// tables: at N = 73,984 and M = 4096, 1.59e11 FLOPs, 2.37 ms at the f32
// peak of the CUDA cores, against about 58 MB of memory traffic.
//
// What it cannot copy from the TPU: the TPU kernel keeps all three
// tables resident in VMEM next to a block of 256 tokens. At M = 4096,
// K_1 and U_1 alone are 1 MiB each, against 227 KB of shared memory a
// block. So here a block owns a tile of 64 tokens and walks the pattern
// tiles of lookup 1 with an online softmax, as K1 does; it keeps e in
// shared memory, normalizes it and walks lookup 2's tiles, then rounds
// and walks lookup 3's. Neither e, the logits nor the scores go to device
// memory between the stages (e is written once, as an output).
//
// Design:
// - One block of 256 threads per 64 token rows; pattern tiles of 64,
//   staged in shared memory; rows >= M are masked to -1e30 and rows past
//   N are zero-filled and never written.
// - Each stage is K1's arithmetic (hopfield_stream_fwd.cu): the state
//   LayerNorm in double, rounded once to f32 (hopfield_stream.cuh, four
//   lanes a row), the score product in K1's FMA order, the running max
//   and denominator over a half-warp, and out = acc / l. So e, zq and r
//   agree with three K1 launches and the elementwise steps between them,
//   up to the rare last bit where the two double LayerNorm sums round to
//   different f32 values.
// - Plain f32 FMA on the CUDA cores, 68.6 KB of shared memory a block.

#include "hopfield_stream.cuh"

namespace {

using namespace hopfield_stream;

constexpr int BLOCK_N = 64;   // token rows per tile
constexpr int BLOCK_M = 64;   // patterns per tile
constexpr int THREADS = 256;  // a 16x16 grid; 4 threads per token row for the LayerNorm

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

// dst[r][k] = src[row0 + r][k] for r < rows, 0 beyond; dst has row stride S
template <int D, int S>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0, int rows) {
  for (int idx = threadIdx.x; idx < BLOCK_N * D; idx += THREADS) {
    const int r = idx / D;
    const int k = idx - r * D;
    dst[r * S + k] = r < rows ? src[static_cast<size_t>(row0) * D + idx] : 0.f;
  }
}

// acc[i][j] = sum_k a[ty*4+i][k] * b[tx+16j][k] over the width D, both
// tiles in shared memory with row stride S, in K1's FMA order. Rows of a
// float4 width are read as float4.
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

constexpr int WIDE = 64;  // the token and retrieval width
constexpr int NARROW = 3; // the index width
constexpr int QS = stride_of<WIDE>();
constexpr int PS = BLOCK_N + 4;  // transposed probabilities

struct Table {
  const float* K;  // (m, d_in)
  const float* U;  // (m, d_out)
  const float* b;  // (d_out)
  const float* s;  // (d_in), the state LayerNorm's scale
  const float* t;  // (d_in), and shift
  int m;
};

constexpr size_t SMEM_BYTES = sizeof(float) * (BLOCK_N * QS + BLOCK_M * QS + BLOCK_M * WIDE + BLOCK_M * PS);

// One lookup of the BLOCK_N queries in q_s (row stride stride_of<D_IN>()):
// K1's pattern walk. On return acc holds the unnormalized sums of rows
// ty*4+i (columns tx*4+c for D_OUT = 64; for D_OUT = 3 the half-warp's
// total, the same in each of its lanes) and l_run their denominators.
// Every thread calls it; it ends with a barrier.
template <int D_IN, int D_OUT>
__device__ __forceinline__ void lookup(const float* q_s, float* k_s, float* u_s, float* p_s, const Table& tab,
                                       float beta, float (&acc)[4][D_OUT == WIDE ? 4 : D_OUT],
                                       float (&l_run)[4]) {
  constexpr int KS = stride_of<D_IN>();
  constexpr bool WIDE_OUT = D_OUT == WIDE;
  constexpr int ACC_W = WIDE_OUT ? 4 : D_OUT;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float m_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = MASKED;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ACC_W; ++c) acc[i][c] = 0.f;
  }

  for (int p0 = 0; p0 < tab.m; p0 += BLOCK_M) {
    const int pats = min(BLOCK_M, tab.m - p0);
    stage_rows<D_IN, KS>(k_s, tab.K, p0, pats);
    stage_rows<D_OUT, D_OUT>(u_s, tab.U, p0, pats);
    __syncthreads();

    float sc[4][4];
    tile_products<D_IN, KS>(q_s, k_s, ty, tx, sc);

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
        *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * PS + ty * 4) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < BLOCK_M; ++jj) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + jj * PS + ty * 4);
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

  if constexpr (!WIDE_OUT) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D_OUT; ++c) acc[i][c] = half_warp_sum(acc[i][c]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bottleneck_fused_kernel(const float* __restrict__ x, Table t1, Table t2, Table t3, float* __restrict__ e_out,
                        float* __restrict__ zq_out, float* __restrict__ r_out, int n, float levels) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // the queries of each stage, then e, then zn
  float* k_s = q_s + BLOCK_N * QS;
  float* u_s = k_s + BLOCK_M * QS;
  float* p_s = u_s + BLOCK_M * WIDE;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BLOCK_N;
  const int rows_here = min(BLOCK_N, n - row0);
  const float beta = 0.125f;  // 1/sqrt(64)
  const float beta_i = static_cast<float>(1.0 / sqrt(3.0));

  // ---- lookup 1: e = softmax(beta LN_1(x) K_1^T) U_1 + b_1
  stage_rows<WIDE, QS>(q_s, x, row0, rows_here);
  __syncthreads();
  layer_norm_rows<BLOCK_N, QS, THREADS>(q_s, WIDE, t1.s, t1.t);
  // the first pattern tile's barrier orders these writes before any read
  float acc[4][4], l_run[4];
  lookup<WIDE, WIDE>(q_s, k_s, u_s, p_s, t1, beta, acc, l_run);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float ev[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ev[c] = acc[i][c] / l_run[i] + t1.b[tx * 4 + c];
    *reinterpret_cast<float4*>(q_s + r * QS + tx * 4) = make_float4(ev[0], ev[1], ev[2], ev[3]);
    if (r < rows_here)
      *reinterpret_cast<float4*>(e_out + static_cast<size_t>(row0 + r) * WIDE + tx * 4) =
          make_float4(ev[0], ev[1], ev[2], ev[3]);
  }
  __syncthreads();

  // ---- lookup 2 and the quantizer: zq = rint(sigmoid(logits) (L - 1))
  layer_norm_rows<BLOCK_N, QS, THREADS>(q_s, WIDE, t2.s, t2.t);
  float acc3[4][NARROW];
  lookup<WIDE, NARROW>(q_s, k_s, u_s, p_s, t2, beta, acc3, l_run);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int c = 0; c < NARROW; ++c) {
        const float logit = acc3[i][c] / l_run[i] + t2.b[c];
        const float zq = rintf(1.f / (1.f + expf(-logit)) * levels);
        q_s[r * NARROW + c] = zq / levels;  // zn, the third lookup's input
        if (r < rows_here) zq_out[static_cast<size_t>(row0 + r) * NARROW + c] = zq;
      }
    }
  }
  __syncthreads();

  // ---- lookup 3: r = softmax(beta_i LN_3(zn) K_3^T) U_3 + b_3
  layer_norm_rows<BLOCK_N, NARROW, THREADS>(q_s, NARROW, t3.s, t3.t);
  lookup<NARROW, WIDE>(q_s, k_s, u_s, p_s, t3, beta_i, acc, l_run);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows_here) continue;
    float rv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = acc[i][c] / l_run[i] + t3.b[tx * 4 + c];
    *reinterpret_cast<float4*>(r_out + static_cast<size_t>(row0 + r) * WIDE + tx * 4) =
        make_float4(rv[0], rv[1], rv[2], rv[3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, 64); for lookup i the folded
// K_i (m_i, d_in), U_i (m_i, d_out), the shift b_i (d_out) and the state
// LayerNorm's s_i, t_i (d_in), with (d_in, d_out) = (64, 64), (64, 3) and
// (3, 64); the outputs e (n, 64), zq (n, 3) and r (n, 64). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int hopfield_bottleneck_fused(const float* x, const float* k1, const float* u1, const float* b1,
                                         const float* s1, const float* t1, const float* k2, const float* u2,
                                         const float* b2, const float* s2, const float* t2, const float* k3,
                                         const float* u3, const float* b3, const float* s3, const float* t3,
                                         float* e, float* zq, float* r, int n, int m1, int m2, int m3,
                                         int num_levels, void* stream) {
  if (n <= 0 || m1 <= 0 || m2 <= 0 || m3 <= 0 || num_levels < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const Table l1{k1, u1, b1, s1, t1, m1}, l2{k2, u2, b2, s2, t2, m2}, l3{k3, u3, b3, s3, t3, m3};
  const dim3 grid((n + BLOCK_N - 1) / BLOCK_N);
  bottleneck_fused_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, l1, l2, l3, e, zq, r, n, static_cast<float>(num_levels - 1));
  return cudaGetLastError();
}
