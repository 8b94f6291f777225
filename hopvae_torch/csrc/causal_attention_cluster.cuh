// The thread-block cluster of K5's wide kernels (head widths past 256 up to
// 8192): the forward's (causal_attention_fwd.cu) and the backward's
// (causal_attention_bwd.cu). Both split the head's depth across the R
// blocks of a cluster on the grid's z axis, on the plan and with the
// helpers of cluster.cuh (slices of 128, 256 or 512 columns, up to 16
// blocks); here the plan of a head width (a multiple of 128), the grid of
// a launch, and the staging of a slice of a strided (B, S, heads, D)
// input.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "causal_attention.cuh"
#include "cluster.cuh"

namespace causal_attention {

namespace wide = ::cluster;  // the plan's constants and Cfg<J>

using cluster::add4;
using cluster::cluster_arrive;
using cluster::cluster_attributes;
using cluster::cluster_config;
using cluster::cluster_rank;
using cluster::cluster_ranks;
using cluster::cluster_wait;
using cluster::ld_cluster;

// The wide width d: J (chunks of 128 a slice) and the blocks of a cluster;
// false if d is not a width the cluster kernels take.
inline bool wide_plan(int d, int& j, int& ranks) {
  if (d <= 256 || d % wide::STEP != 0) return false;
  const int n = d / wide::STEP;
  j = wide::chunks_per_rank(n);
  ranks = j ? (n + j - 1) / j : 0;
  return j != 0;
}

// The grid of a cluster kernel over (b * h, query or key tiles of tm rows
// of s, ranks); cudaErrorInvalidValue past 65535 tiles.
inline cudaError_t attention_grid(int b, int s, int h, int tm, int ranks, dim3& grid) {
  const int m_tiles = (s + tm - 1) / tm;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  grid = dim3(b * h, m_tiles, ranks);
  return cudaSuccess;
}

// Stage rows [row0, row0 + ROWS) of columns [0, cols) of a strided input
// (src: the slice's first column; cols a multiple of 128) into shared
// memory, rows RS floats apart, zeros past the sequence end; as
// causal_attention::stage, with the width at run time, a chunk of 128
// columns at a time (the index math in shifts).
template <int RS, int ROWS>
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ src, Strides st, int b, int hh,
                                            int row0, int s, bool vec16, int cols) {
  const float* base = src + b * st.b + hh * st.h;
  for (int c0 = 0; c0 < cols; c0 += wide::STEP) {
    if (vec16) {
      for (int i = threadIdx.x; i < ROWS * wide::STEP / 4; i += wide::THREADS) {
        const int r = i / (wide::STEP / 4);
        const int c = c0 + (i % (wide::STEP / 4)) * 4;
        const bool in = row0 + r < s;
        tf32x3::cp_async16(dst + r * RS + c, in ? base + (row0 + r) * st.s + c : base, in);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * wide::STEP; i += wide::THREADS) {
        const int r = i / wide::STEP;
        const int c = c0 + i % wide::STEP;
        const bool in = row0 + r < s;
        tf32x3::cp_async4(dst + r * RS + c, in ? base + (row0 + r) * st.s + c : base, in);
      }
    }
  }
}

}  // namespace causal_attention
