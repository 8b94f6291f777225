// Causal flash attention, forward (K5-fwd), for Hopper (sm_90a).
//
// Replaces the Mosaic TPU kernel `_flash_attention_kernel`
// (jax/experimental/pallas/ops/tpu/flash_attention.py) that
// hopvae_tpu/ops/attention.py:flash_causal_attention calls for the
// Transformer prior. For one (batch, head) of q, k, v (S, D) it computes
//
//     out = softmax(scale * q k^T, causal) v      lse = log sum_j exp(...)
//
// row by row, with an online softmax, and writes out (B, S, heads, D) and
// the row log-sum-exp lse (B, heads, S) that the backward kernels rebuild
// the probabilities from.
//
// What bounds it on an H100: arithmetic. It does two products over the
// causal triangle, 2 * 2 * D * S(S+1)/2 FLOPs per head, and moves only q,
// k, v and out: at B = 256, S = 867, 4 heads of D = 32 that is 49 GFLOP
// against 0.46 GB, 0.74 ms at the f32 peak of the CUDA cores against
// 0.14 ms of memory traffic.
//
// Design:
// - One block of 256 threads takes 64 query rows of one head and walks
//   the key tiles of 64 up to its diagonal only, so the causal triangle is
//   skipped by the loop bound; inside the diagonal tile it masks key > row
//   itself, and rows past S are zero-filled and never written (S = 867 is
//   a multiple of no tile). Blocks with the most tiles are launched first.
// - The q tile stays in shared memory; each k and v tile is staged there
//   in turn. Thread (ty, tx) holds a 4 x 4 block of scores, and the 16
//   threads of a row (a half-warp) keep the row's running max and
//   denominator with xor-shuffles, as K1 does; the accumulator of the
//   row's D outputs is spread over them, D/16 columns each.
// - The probabilities go through shared memory to the p @ v product.
// - Plain f32 FMA on the CUDA cores. The inputs are strided views (the
//   prior's q, k and v are slices of one projection), read with their
//   own strides; nothing is copied or padded.

#include <cmath>

#include "causal_attention.cuh"

namespace {

using namespace causal_attention;

constexpr float MASKED = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * BLOCK * row_stride<D>() + BLOCK * PS);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
causal_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ out, float* __restrict__ lse, int s, int h, Strides qs, Strides ks,
                  Strides vs, float scale) {
  constexpr int RS = row_stride<D>();
  constexpr int COLS = cols<D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BLOCK * RS;
  float* v_s = k_s + BLOCK * RS;
  float* p_s = v_s + BLOCK * RS;  // p_s[key][row]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int q0 = qt * BLOCK;
  const bool owns_cols = tx * COLS < D;

  load_tile<D>(q_s, q, qs, b, hh, q0, s);

  float m_run[4], l_run[4], acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = MASKED;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BLOCK;
    load_tile<D>(k_s, k, ks, b, hh, k0, s);
    load_tile<D>(v_s, v, vs, b, hh, k0, s);
    __syncthreads();

    float sc[4][4];
    dot_tile<D>(sc, q_s, k_s, ty, tx);

    // ---- online softmax over the tile's keys, causal mask on the diagonal
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float val = k0 + tx + 16 * j <= row ? sc[i][j] * scale : MASKED;
        sc[i][j] = val;
        mt = fmaxf(mt, val);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mt));
      const float rescale = __expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j <= row ? __expf(sc[i][j] - m_new) : 0.f;
        sc[i][j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * rescale + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= rescale;
    }

    // ---- acc += p @ v
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * PS + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();
    if (owns_cols) {
#pragma unroll 8
      for (int jj = 0; jj < BLOCK; ++jj) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + jj * PS + ty * 4);
        float vv[COLS];
        load_vec<COLS>(vv, v_s + jj * RS + tx * COLS);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

  // ---- epilogue: out = acc / l and lse = m + log l, rows < S only
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    if (owns_cols) {
      float* o = out + out_offset<D>(b, row, hh, s, h) + tx * COLS;
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[c] = acc[i][c] / l_run[i];
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * s + row] = m_run[i] + logf(l_run[i]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int b, int s, int h,
           Strides qs, Strides ks, Strides vs, float scale, cudaStream_t stream) {
  auto kernel = causal_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + BLOCK - 1) / BLOCK);
  kernel<<<grid, THREADS, smem_bytes<D>(), stream>>>(q, k, v, out, lse, s, h, qs, ks, vs, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v are device pointers to
// strided (B, S, heads, D) f32 arrays whose D axis is contiguous, with
// their batch, sequence and head strides in elements; out is a contiguous
// (B, S, heads, D) and lse a contiguous (B, heads, S). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int causal_attention_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
                                    int b, int s, int h, int d, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float scale,
                                    void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      (s + BLOCK - 1) / BLOCK > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 16: return launch<16>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 32: return launch<32>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 64: return launch<64>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    case 128: return launch<128>(q, k, v, out, lse, b, s, h, qs, ks, vs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
