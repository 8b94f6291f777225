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
// against about 0.2 ms of memory traffic each. The split recomputes the
// scores and g v^T in both kernels; one fused kernel would need float
// atomics for dQ, and the backward must repeat bit for bit.
//
// Design:
// - K5-dkv: one block of 256 threads per 64 keys of one head. dK and dV
//   for its keys stay in registers while it walks the query tiles from
//   its diagonal to the end, so each block alone writes its outputs and
//   no float atomics are needed. The k and v tiles stay in shared memory;
//   each q and g tile, with its lse and delta, is staged there in turn.
// - K5-dq: one block per 64 query rows of one head, walking the key tiles
//   up to its diagonal, dQ in registers.
// - Thread (ty, tx) computes a 4 x 4 block of scores and of g v^T; P and
//   dS go through shared memory into the products that reduce over rows
//   (dV, dK) or keys (dQ), where each thread owns 4 rows and D/16
//   columns of the output.
// - Both mask key > row on the diagonal tile and rows past S themselves;
//   the inputs are strided views, read with their own strides.
// - Plain f32 FMA on the CUDA cores; the score product is the forward's
//   (same FMA order), so P is rebuilt from the very scores lse summarised.

#include "causal_attention.cuh"

namespace {

using namespace causal_attention;

// P and dS of one 64 x 64 tile for rows q0 + ty*4 + i and keys
// k0 + tx + 16*j, from the q, k, v, g tiles and the rows' lse and delta.
template <int D>
__device__ __forceinline__ void probs_and_dscores(float (&p)[4][4], float (&ds)[4][4], const float* q_s,
                                                  const float* k_s, const float* v_s, const float* g_s,
                                                  const float* lse_s, const float* dl_s, int q0, int k0,
                                                  int s, float scale, int ty, int tx) {
  dot_tile<D>(p, q_s, k_s, ty, tx);
  dot_tile<D>(ds, g_s, v_s, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = row < s && k0 + tx + 16 * j <= row;
      const float pr = live ? __expf(p[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - dl_s[r]);
    }
  }
}

// lse and delta of rows [q0, q0 + 64) of head bh, zeros past S
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s, const float* __restrict__ lse,
                                               const float* __restrict__ delta, int bh, int q0, int s) {
  const int r = threadIdx.x;
  if (r < BLOCK) {
    const bool in = q0 + r < s;
    const size_t at = static_cast<size_t>(bh) * s + q0 + r;
    lse_s[r] = in ? lse[at] : 0.f;
    dl_s[r] = in ? delta[at] : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * BLOCK * row_stride<D>() + 2 * BLOCK * PS + 2 * BLOCK);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
causal_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int s,
                      int h, Strides qs, Strides ks, Strides vs, Strides gs, float scale) {
  constexpr int RS = row_stride<D>();
  constexpr int COLS = cols<D>();
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + BLOCK * RS;
  float* q_s = v_s + BLOCK * RS;
  float* g_s = q_s + BLOCK * RS;
  float* p_s = g_s + BLOCK * RS;  // p_s[row][key]
  float* d_s = p_s + BLOCK * PS;  // dS, d_s[row][key]
  float* lse_s = d_s + BLOCK * PS;
  float* dl_s = lse_s + BLOCK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int kt = blockIdx.y;  // the longest columns (kt = 0) first
  const int k0 = kt * BLOCK;
  const int n_tiles = gridDim.y;
  const bool owns_cols = tx * COLS < D;

  load_tile<D>(k_s, k, ks, b, hh, k0, s);
  load_tile<D>(v_s, v, vs, b, hh, k0, s);

  float acc_k[4][COLS], acc_v[4][COLS];  // keys ty*4+i, columns tx*COLS+c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * BLOCK;
    load_tile<D>(q_s, q, qs, b, hh, q0, s);
    load_tile<D>(g_s, g, gs, b, hh, q0, s);
    load_row_stats(lse_s, dl_s, lse, delta, bh, q0, s);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, q_s, k_s, v_s, g_s, lse_s, dl_s, q0, k0, s, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty * 4 + i) * PS + tx + 16 * j] = p[i][j];
        d_s[(ty * 4 + i) * PS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // ---- dV += P^T g, dK += dS^T q, summed over the tile's rows in order
    if (owns_cols) {
#pragma unroll 4
      for (int r = 0; r < BLOCK; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + r * PS + ty * 4);
        const float4 dv4 = *reinterpret_cast<const float4*>(d_s + r * PS + ty * 4);
        float gr[COLS], qr[COLS];
        load_vec<COLS>(gr, g_s + r * RS + tx * COLS);
        load_vec<COLS>(qr, q_s + r * RS + tx * COLS);
        const float pk[4] = {pv.x, pv.y, pv.z, pv.w};
        const float dk4[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
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
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
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
  constexpr int RS = row_stride<D>();
  constexpr int COLS = cols<D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + BLOCK * RS;
  float* k_s = g_s + BLOCK * RS;
  float* v_s = k_s + BLOCK * RS;
  float* d_s = v_s + BLOCK * RS;  // dS transposed, d_s[key][row]
  float* lse_s = d_s + 2 * BLOCK * PS;
  float* dl_s = lse_s + BLOCK;

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
  load_tile<D>(g_s, g, gs, b, hh, q0, s);
  load_row_stats(lse_s, dl_s, lse, delta, bh, q0, s);

  float acc[4][COLS];  // rows ty*4+i, columns tx*COLS+c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BLOCK;
    load_tile<D>(k_s, k, ks, b, hh, k0, s);
    load_tile<D>(v_s, v, vs, b, hh, k0, s);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, q_s, k_s, v_s, g_s, lse_s, dl_s, q0, k0, s, scale, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(d_s + (tx + 16 * j) * PS + ty * 4) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

    // ---- dQ += dS k, summed over the tile's keys in order
    if (owns_cols) {
#pragma unroll 4
      for (int kk = 0; kk < BLOCK; ++kk) {
        const float4 dv4 = *reinterpret_cast<const float4*>(d_s + kk * PS + ty * 4);
        float kr[COLS];
        load_vec<COLS>(kr, k_s + kk * RS + tx * COLS);
        const float dr[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(dr[i], kr[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and d_s
  }

  if (!owns_cols) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
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
  const dim3 grid(b * h, (s + BLOCK - 1) / BLOCK);
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
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      (s + BLOCK - 1) / BLOCK > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 16: return launch<16, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 32: return launch<32, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 64: return launch<64, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
    case 128: return launch<128, DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, qs, ks, vs, gs, scale, st);
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
