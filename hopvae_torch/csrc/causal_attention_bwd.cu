// Causal flash attention, backward (K5-dkv and K5-dq), for Hopper (sm_90a).
//
// Replace the Mosaic TPU kernels `_flash_attention_dkv_kernel` and
// `_flash_attention_dq_kernel` (jax/experimental/pallas/ops/tpu/
// flash_attention.py) behind hopvae_tpu/ops/attention.py:
// flash_causal_attention. For one (batch, head), with the cotangent g of
// out, the forward's row log-sum-exp lse and delta = rowsum(g * out),
// both rebuild the probabilities tile by tile,
//
//     P  = exp(scale * q k^T - lse)            (0 where key > row)
//     dS = P * (g v^T - delta)
//
// and K5-dkv computes dV = P^T g and dK = scale * dS^T q, K5-dq computes
// dQ = scale * dS k.
//
// What bounds them on an H100: arithmetic. K5-dkv does four products over
// the causal triangle (q k^T, g v^T, P^T g, dS^T q) and K5-dq three
// (q k^T, g v^T, dS k), 2 * D * S(S+1)/2 FLOPs each per head, against
// reading q, k, v, g and writing the gradients once: at B = 256, S = 867,
// 4 heads of D = 32, 1.47 and 1.10 ms at the f32 peak of the CUDA cores
// against about 0.2 ms of memory traffic each (2.94 and 2.21 ms at one
// head of D = 256). The split recomputes the scores and g v^T in both
// kernels; one fused kernel would need float atomics for dQ, and the
// backward must repeat bit for bit.
//
// Design:
// - Tiles of T = 64 rows or keys, 32 at D = 256 (causal_attention.cuh
//   says why).
// - K5-dkv: one block of 256 threads per T keys of one head. dK and dV
//   for its keys stay in registers while it walks the query tiles from
//   its diagonal to the end, so each block alone writes its outputs and
//   no float atomics are needed. The k and v tiles stay in shared memory;
//   each q and g tile, with its lse and delta, is staged there in turn.
// - K5-dq: one block per T query rows of one head, walking the key tiles
//   up to its diagonal, dQ in registers.
// - Thread (ty, tx) computes an R x R block (R = T/16) of scores and of
//   g v^T; P and dS go through shared memory into the products that
//   reduce over rows (dV, dK) or keys (dQ), where each thread owns R rows
//   and D/16 columns of the output.
// - Both mask key > row on the diagonal tile and rows past S themselves;
//   the inputs are strided views, read with their own strides.
// - Plain f32 FMA on the CUDA cores; the score product is the forward's
//   (same FMA order), so P is rebuilt from the very scores lse summarised.

#include "causal_attention.cuh"

namespace {

using namespace causal_attention;

// P and dS of one T x T tile for rows q0 + ty*R + i and keys
// k0 + tx + 16*j, from the q, k, v, g tiles and the rows' lse and delta.
template <int D>
__device__ __forceinline__ void probs_and_dscores(float (&p)[per_thread<D>()][per_thread<D>()],
                                                  float (&ds)[per_thread<D>()][per_thread<D>()],
                                                  const float* q_s, const float* k_s, const float* v_s,
                                                  const float* g_s, const float* lse_s, const float* dl_s,
                                                  int q0, int k0, int s, float scale, int ty, int tx) {
  constexpr int R = per_thread<D>();
  dot_tile<D>(p, q_s, k_s, ty, tx);
  dot_tile<D>(ds, g_s, v_s, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool live = row < s && k0 + tx + 16 * j <= row;
      const float pr = live ? __expf(p[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - dl_s[r]);
    }
  }
}

// lse and delta of rows [q0, q0 + T) of head bh, zeros past S
template <int D>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s, const float* __restrict__ lse,
                                               const float* __restrict__ delta, int bh, int q0, int s) {
  const int r = threadIdx.x;
  if (r < tile<D>()) {
    const bool in = q0 + r < s;
    const size_t at = static_cast<size_t>(bh) * s + q0 + r;
    lse_s[r] = in ? lse[at] : 0.f;
    dl_s[r] = in ? delta[at] : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * tile<D>() * row_stride<D>() + 2 * tile<D>() * p_stride<D>() + 2 * tile<D>());
}

template <int D>
__global__ void __launch_bounds__(THREADS)
causal_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int s,
                      int h, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int T = tile<D>();
  constexpr int R = per_thread<D>();
  constexpr int RS = row_stride<D>();
  constexpr int PS = p_stride<D>();
  constexpr int COLS = cols<D>();
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + T * RS;
  float* q_s = v_s + T * RS;
  float* g_s = q_s + T * RS;
  float* p_s = g_s + T * RS;  // p_s[row][key]
  float* d_s = p_s + T * PS;  // dS, d_s[row][key]
  float* lse_s = d_s + T * PS;
  float* dl_s = lse_s + T;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int kt = blockIdx.y;  // the longest columns (kt = 0) first
  const int k0 = kt * T;
  const int n_tiles = gridDim.y;
  const bool owns_cols = tx * COLS < D;

  load_tile<D>(k_s, k, ks, b, hh, k0, s);
  load_tile<D>(v_s, v, vs, b, hh, k0, s);

  float acc_k[R][COLS], acc_v[R][COLS];  // keys ty*R+i, columns tx*COLS+c
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * T;
    load_tile<D>(q_s, q, qs, b, hh, q0, s);
    load_tile<D>(g_s, g, gs, b, hh, q0, s);
    load_row_stats<D>(lse_s, dl_s, lse, delta, bh, q0, s);
    __syncthreads();

    float p[R][R], ds[R][R];
    probs_and_dscores<D>(p, ds, q_s, k_s, v_s, g_s, lse_s, dl_s, q0, k0, s, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        p_s[(ty * R + i) * PS + tx + 16 * j] = p[i][j];
        d_s[(ty * R + i) * PS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // ---- dV += P^T g, dK += dS^T q, summed over the tile's rows in order
    if (owns_cols) {
#pragma unroll 4
      for (int r = 0; r < T; ++r) {
        float pk[R], dk4[R], gr[COLS], qr[COLS];
        load_vec<R>(pk, p_s + r * PS + ty * R);
        load_vec<R>(dk4, d_s + r * PS + ty * R);
        load_vec<COLS>(gr, g_s + r * RS + tx * COLS);
        load_vec<COLS>(qr, q_s + r * RS + tx * COLS);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            acc_v[i][c] = fmaf(pk[i], gr[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dk4[i], qr[c], acc_k[i][c]);
          }
      }
    }
    __syncthreads();  // the next tile overwrites q_s, g_s, p_s, d_s and the stats
  }

  if (!owns_cols) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= s) continue;
    const size_t at = out_offset<D>(b, key, hh, s, h) + tx * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      dk[at + c] = acc_k[i][c] * scale;
      dv[at + c] = acc_v[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
causal_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int s, int h, Strides qs,
                     Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int T = tile<D>();
  constexpr int R = per_thread<D>();
  constexpr int RS = row_stride<D>();
  constexpr int PS = p_stride<D>();
  constexpr int COLS = cols<D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + T * RS;
  float* k_s = g_s + T * RS;
  float* v_s = k_s + T * RS;
  float* d_s = v_s + T * RS;  // dS transposed, d_s[key][row]
  float* lse_s = d_s + 2 * T * PS;
  float* dl_s = lse_s + T;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int q0 = qt * T;
  const bool owns_cols = tx * COLS < D;

  load_tile<D>(q_s, q, qs, b, hh, q0, s);
  load_tile<D>(g_s, g, gs, b, hh, q0, s);
  load_row_stats<D>(lse_s, dl_s, lse, delta, bh, q0, s);

  float acc[R][COLS];  // rows ty*R+i, columns tx*COLS+c
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T;
    load_tile<D>(k_s, k, ks, b, hh, k0, s);
    load_tile<D>(v_s, v, vs, b, hh, k0, s);
    __syncthreads();

    float p[R][R], ds[R][R];
    probs_and_dscores<D>(p, ds, q_s, k_s, v_s, g_s, lse_s, dl_s, q0, k0, s, scale, ty, tx);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) col[i] = ds[i][j];
      store_vec<R>(d_s + (tx + 16 * j) * PS + ty * R, col);
    }
    __syncthreads();

    // ---- dQ += dS k, summed over the tile's keys in order
    if (owns_cols) {
#pragma unroll 4
      for (int kk = 0; kk < T; ++kk) {
        float dr[R], kr[COLS];
        load_vec<R>(dr, d_s + kk * PS + ty * R);
        load_vec<COLS>(kr, k_s + kk * RS + tx * COLS);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(dr[i], kr[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and d_s
  }

  if (!owns_cols) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= s) continue;
    float* o = dq + out_offset<D>(b, row, hh, s, h) + tx * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) o[c] = acc[i][c] * scale;
  }
}

template <int D, bool DKV>
int launch(const float* q, const float* k, const float* v, const float* g, const float* lse,
           const float* delta, float* out_a, float* out_b, int b, int s, int h, Strides qs, Strides ks,
           Strides vs, Strides gs, float scale, cudaStream_t stream) {
  if (!grid_fits<D>(b, s, h)) return cudaErrorInvalidValue;
  const dim3 grid(b * h, (s + tile<D>() - 1) / tile<D>());
  if constexpr (DKV) {
    auto kernel = causal_bwd_dkv_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes<D>()));
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem_bytes<D>(), stream>>>(q, k, v, g, lse, delta, out_a, out_b, s, h, qs, ks,
                                                        vs, gs, scale);
  } else {
    auto kernel = causal_bwd_dq_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes<D>()));
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem_bytes<D>(), stream>>>(q, k, v, g, lse, delta, out_a, s, h, qs, ks, vs, gs,
                                                        scale);
  }
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const float* q, const float* k, const float* v, const float* g, const float* lse,
             const float* delta, float* out_a, float* out_b, int b, int s, int h, int d, Strides qs,
             Strides ks, Strides vs, Strides gs, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 16: return launch<16, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 32: return launch<32, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 64: return launch<64, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 128: return launch<128, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 256: return launch<256, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v and g (the cotangent
// of out) are device pointers to strided (B, S, heads, D) f32 arrays whose
// D axis is contiguous, with their batch, sequence and head strides in
// elements; lse and delta are contiguous (B, heads, S); dk, dv and dq are
// contiguous (B, S, heads, D). Each returns a cudaError_t; 0 means the
// launch was accepted.
extern "C" int causal_attention_bwd_dkv(const float* q, const float* k, const float* v, const float* g,
                                        const float* lse, const float* delta, float* dk, float* dv, int b,
                                        int s, int h, int d, long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                        long long v_ss, long long v_sh, long long g_sb, long long g_ss,
                                        long long g_sh, float scale, void* stream) {
  return dispatch<true>(q, k, v, g, lse, delta, dk, dv, b, s, h, d, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                        {v_sb, v_ss, v_sh}, {g_sb, g_ss, g_sh}, scale, stream);
}

extern "C" int causal_attention_bwd_dq(const float* q, const float* k, const float* v, const float* g,
                                       const float* lse, const float* delta, float* dq, int b, int s, int h,
                                       int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                       long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, long long g_sb, long long g_ss, long long g_sh,
                                       float scale, void* stream) {
  return dispatch<false>(q, k, v, g, lse, delta, dq, nullptr, b, s, h, d, {q_sb, q_ss, q_sh},
                         {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {g_sb, g_ss, g_sh}, scale, stream);
}
