// Shared pieces of the causal flash-attention kernels (K5):
// causal_attention_fwd.cu and causal_attention_bwd.cu.
//
// Both stage (rows, D) tiles of one (batch, head) of a strided (B, S,
// heads, D) f32 input into shared memory by cp.async, rows D + 4 floats
// apart, and read mma.sync m16n8k8 fragments from them with the loaders of
// mma_tf32.cuh. D + 4 is 4 times an odd number (D a multiple of 8), so no
// tile needs a swizzle.

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

// The fragment loaders (mma_tf32.cuh), under this namespace's names.
using tf32x3::load_a;
using tf32x3::load_b_cols;
using tf32x3::load_b_rows2;

}  // namespace causal_attention
