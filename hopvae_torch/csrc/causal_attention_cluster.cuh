// The thread-block cluster of K5's wide kernels (head widths past 256 up to
// 8192): the forward's (causal_attention_fwd.cu) and the backward's
// (causal_attention_bwd.cu). Both split the head's depth across the R
// blocks of a cluster on the grid's z axis; block rank r owns the depth
// slice [r SL, r SL + SL) (the last slice may be 128 narrower per missing
// chunk), keeps its resident slice in shared memory for the whole walk and
// streams that slice of each tile. A warp owns a 16-row slab and a part of
// PART = 64 columns of the slice; its partial scores meet the other parts'
// and ranks' over distributed shared memory (mapa, ld.shared::cluster),
// the parts of a rank added in order, the ranks in rank order.
//
//   n chunks of 128   J  SL   TM  TN  R
//   3..8              1  128  64  32  3..8
//   9..16             2  256  32  16  5..8
//   17..64            4  512  16  16  5..16
//
// 8 warps a block, one block an SM. Clusters past 8 blocks are
// non-portable, opted in at the launch; past 64 chunks (8192) a cluster
// would need more than 16 blocks, and the plan refuses the width.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "causal_attention.cuh"

namespace causal_attention {

namespace wide {
constexpr int STEP = 128;       // the wide widths: multiples of this past 256
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PORTABLE = 8;     // blocks of a portable cluster
constexpr int MAX_RANKS = 16;   // blocks of a non-portable cluster
template <int J>
struct Cfg {
  static constexpr int TM = J == 1 ? 64 : J == 2 ? 32 : 16;  // resident rows of a block
  static constexpr int TN = J == 1 ? 32 : 16;                // streamed rows of a tile
  static constexpr int NT = TN / 8;                          // n-tiles of a 16 x TN score slab
  static constexpr int SLABS = TM / 16;                      // 16-row slabs
  static constexpr int WS = WARPS / SLABS;                   // warps of a slab, one part of the slice each
  static constexpr int SL = STEP * J;                        // slice width at most
  static constexpr int PART = SL / WS;                       // a warp's columns of the slice
  static constexpr int RS = SL + 4;                          // row stride in shared memory
  static_assert(PART % 16 == 0 && NT % 2 == 0 && NT <= 2 * WS, "tiles");
};
// chunks of 128 in a block's slice for a head of n chunks; 0: refused
inline int chunks_per_rank(int n) {
  return n <= PORTABLE ? 1 : n <= 2 * PORTABLE ? 2 : n <= 4 * MAX_RANKS ? 4 : 0;
}
}  // namespace wide

// The wide width d: J (chunks of 128 a slice) and the blocks of a cluster;
// false if d is not a width the cluster kernels take.
inline bool wide_plan(int d, int& j, int& ranks) {
  if (d <= 256 || d % wide::STEP != 0) return false;
  const int n = d / wide::STEP;
  j = wide::chunks_per_rank(n);
  ranks = j ? (n + j - 1) / j : 0;
  return j != 0;
}

// The block's rank in its cluster and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_ranks() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// The cluster barrier, split: every thread of every block of the cluster
// arrives, and what each wrote to shared memory before its arrival is
// visible to all after their wait (release, acquire). Between the two a
// thread may work, but not arrive again.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }

// The float4 at p in the shared memory of block `rank` of the cluster (a
// generic load the compiler may schedule freely between the barriers).
__device__ __forceinline__ float4 ld_cluster(const float4* p, int rank) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return *reinterpret_cast<const float4*>(r);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) { a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w; }

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

// The launch configuration of a cluster kernel (`bytes` of dynamic shared
// memory, tm resident rows a block, `ranks` blocks a cluster, grid
// (b * h, m_tiles, ranks)), with the kernel's attributes set; `config` and
// `attr` are filled in.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t bytes, int tm, cudaLaunchConfig_t& config,
                           cudaLaunchAttribute& attr, int b, int s, int h, int ranks, cudaStream_t stream) {
  const int m_tiles = (s + tm - 1) / tm;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && ranks > wide::PORTABLE)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(b * h, m_tiles, ranks);
  config.blockDim = dim3(wide::THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = ranks;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaSuccess;
}

// A cluster kernel's build: blocks a cluster, slice width at most, and the
// clusters the card can hold at once (a cluster of these blocks launches
// only if it is at least 1), into out[0..2].
template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, size_t bytes, int tm, int slice, int ranks, int* out) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, bytes, tm, config, attr, 1, 1, 1, ranks, nullptr);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  out[0] = ranks;
  out[1] = slice;
  out[2] = clusters;
  return cudaSuccess;
}

}  // namespace causal_attention
