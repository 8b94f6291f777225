// Shared pieces of the causal flash-attention kernels (K5):
// causal_attention_fwd.cu and causal_attention_bwd.cu.
//
// Both stage (rows, D) tiles of one (batch, head) of a strided (B, S,
// heads, D) f32 input into shared memory by cp.async, rows D + 4 floats
// apart, and read mma.sync m16n8k8 fragments from them (mma_tf32.cuh).
// D + 4 is 4 times an odd number (D a multiple of 8): the fragment loads
// by row g (ldmatrix: eight 16-byte rows in eight bank groups) and those
// by permuted row 2t (scalar, banks 8t + g or 8t + 4 + g) hit 32 banks, so
// no tile needs a swizzle.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_tf32.cuh"

namespace causal_attention {

using tf32x3::FragA;
using tf32x3::FragB;

// Element strides of one strided (B, S, heads, D) input; D is contiguous.
struct Strides {
  long long b, s, h;
};

// Offset of row `row` of head hh, batch b, in a contiguous (B, S, heads, D)
// output.
template <int D>
__device__ __forceinline__ size_t out_offset(int b, int row, int hh, int s, int h) {
  return (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * D + static_cast<size_t>(hh) * D;
}

// 16-byte copies need the base and every stride in multiples of 4 floats
inline bool vec16_ok(const float* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 && st.s % 4 == 0 && st.h % 4 == 0;
}

// Stage rows [row0, row0 + ROWS) of head (b, hh) of a strided input into
// shared memory (ROWS x (D + 4)) by cp.async, zeros past the sequence end.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, Strides st, int b, int hh,
                                      int row0, int s, bool vec16) {
  constexpr int RS = D + 4;
  const float* base = src + b * st.b + hh * st.h;
  if (vec16) {
    constexpr int CH = D / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH;
      const int c = (i - r * CH) * 4;
      const bool in = row0 + r < s;
      tf32x3::cp_async16(dst + r * RS + c, in ? base + (row0 + r) * st.s + c : base, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D;
      const int c = i - r * D;
      const bool in = row0 + r < s;
      tf32x3::cp_async4(dst + r * RS + c, in ? base + (row0 + r) * st.s + c : base, in);
    }
  }
}

// The A fragment of rows 0..15 and columns 0..7 of a tile in shared memory.
template <int RS>
__device__ __forceinline__ FragA load_a(const float* p, int gq, int tq) {
  const int lane = 4 * gq + tq;
  uint32_t r[4];
  tf32x3::ldmatrix_x4(r, p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 4 * (lane >> 4));
  return tf32x3::split_a(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                         __uint_as_float(r[3]));
}

// The B fragments B[k][n] = Y[n][k] of two n-tiles, rows n = 0..15,
// columns k = 0..7.
template <int RS>
__device__ __forceinline__ void load_b_rows2(FragB& f0, FragB& f1, const float* p, int gq, int tq) {
  const int lane = 4 * gq + tq;
  uint32_t r[4];
  tf32x3::ldmatrix_x4(r, p + ((lane & 7) + 8 * (lane >> 4)) * RS + 4 * ((lane >> 3) & 1));
  f0 = tf32x3::split_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
  f1 = tf32x3::split_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

// The B fragment B[k][n] = Y[k][n] over the permuted k: rows 2t and 2t + 1.
template <int RS>
__device__ __forceinline__ FragB load_b_cols(const float* p, int gq, int tq) {
  return tf32x3::split_b(p[2 * tq * RS + gq], p[(2 * tq + 1) * RS + gq]);
}

}  // namespace causal_attention
