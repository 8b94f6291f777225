// Shared pieces of the causal flash-attention kernels (K5):
// causal_attention_fwd.cu and causal_attention_bwd.cu.
//
// Every kernel works on tiles of 64 query rows or 64 keys of one
// (batch, head) of a (B, S, heads, D) f32 tensor, with 256 threads as a
// 16 x 16 grid: thread (ty, tx) owns rows ty*4+i and keys (or columns)
// tx+16*j, i, j < 4, of a 64 x 64 score tile. The 16 threads that share a
// row are one half-warp.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace causal_attention {

constexpr int BLOCK = 64;         // query rows or keys of a tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int PS = BLOCK + 4;     // row stride of a 64 x 64 tile in shared memory
constexpr unsigned FULL = 0xffffffffu;

// Row stride of a (64, D) tile in shared memory: the 4 extra floats shift
// consecutive rows by 4 banks, so float4 reads across rows do not conflict.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

// Columns of a (64, D) output tile that each thread of a row owns. Below
// D = 16 the first D threads of a row own one column each and the rest idle.
template <int D>
__host__ __device__ constexpr int cols() { return D >= 16 ? D / 16 : 1; }

// Element strides of one strided (B, S, heads, D) input; D is contiguous.
struct Strides {
  long long b, s, h;
};

// Stage rows [row0, row0 + 64) of head (b, hh) of a strided input into
// shared memory (64 x row_stride<D>()), with zeros past the sequence end.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides st, int b,
                                          int hh, int row0, int s) {
  const float* base = src + b * st.b + hh * st.h;
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    dst[r * row_stride<D>() + c] = row < s ? base[row * st.s + c] : 0.f;
  }
}

// Load n consecutive floats of shared memory into registers, as float4,
// float2 or one float.
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// acc[i][j] = a_(ty*4+i) . b_(tx+16*j): a 64 x 64 tile of dot products of
// the rows of two (64, D) tiles in shared memory, in FMA order over D.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a_s, const float* b_s, int ty,
                                         int tx) {
  constexpr int RS = row_stride<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a_s + (ty * 4 + i) * RS + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * RS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

// Offset of row `row` of head hh, batch b, in a contiguous (B, S, heads, D)
// output.
template <int D>
__device__ __forceinline__ size_t out_offset(int b, int row, int hh, int s, int h) {
  return (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * D + static_cast<size_t>(hh) * D;
}

}  // namespace causal_attention
