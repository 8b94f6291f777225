// The thread-block cluster shared by the kernels that split a product's
// depth across the blocks of a cluster on the grid's z axis: K5's wide
// forward and backward (causal_attention_cluster.cuh) and the wide
// Hopfield forward K1 (with K4's wide stages) and backward K2 and K3
// (hopfield_cluster.cuh). Block rank r owns
// the depth slice [r SL, r SL + SL), keeps its resident slice in shared
// memory for the whole walk and streams that slice of each tile. A warp
// owns a 16-row slab and a part of PART = 64 columns of the slice; its
// partial products meet the other parts' and ranks' over distributed
// shared memory (mapa, ld.shared::cluster), the parts of a rank added in
// order, the ranks in rank order.
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

namespace cluster {

constexpr int STEP = 128;       // a chunk of the depth
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
// The cluster forwards' shared memory (K5-fwd's, K1's): the resident q
// slice, NB streamed buffers of two slices (k and v; K and U), the warps'
// partial scores, two buffers of the slabs' rank sums.
template <int J>
struct Fwd {
  using C = Cfg<J>;
  static constexpr int XCH = C::SLABS * C::WS * C::NT * 32;  // float4s: [slab][part][n-tile][lane]
  static constexpr int SUMS = C::SLABS * C::NT * 32;         // float4s of one buffer of rank sums: [slab][n-tile][lane]
  static constexpr int BUF = 2 * C::TN * C::RS;              // floats of a streamed buffer: two slices
  static constexpr int RG = 16 / C::NT;                      // ranks whose sums are loaded at once
};
template <int J>
__host__ __device__ constexpr size_t fwd_bytes_with(int nb) {
  using C = Cfg<J>;
  using F = Fwd<J>;
  return sizeof(float) * (C::TM * C::RS + nb * F::BUF) + sizeof(float4) * (F::XCH + 2 * F::SUMS);
}
// streamed buffers: four where they fit (a tile's copies then start two
// tiles ahead, with no block barrier of their own), else two
template <int J>
__host__ __device__ constexpr int fwd_buffers() { return fwd_bytes_with<J>(4) <= 232448 ? 4 : 2; }
template <int J>
__host__ __device__ constexpr size_t fwd_bytes() { return fwd_bytes_with<J>(fwd_buffers<J>()); }

// chunks of 128 in a block's slice for a depth of n chunks; 0: refused
inline int chunks_per_rank(int n) {
  return n <= PORTABLE ? 1 : n <= 2 * PORTABLE ? 2 : n <= 4 * MAX_RANKS ? 4 : 0;
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

// Store v at p in the shared memory of block `rank` of the cluster (a
// generic store; the next cluster barrier makes it visible there).
__device__ __forceinline__ void st_cluster(float4* p, int rank, float4 v) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  *reinterpret_cast<float4*>(r) = v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) { a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w; }

// The launch configuration of a cluster kernel (`bytes` of dynamic shared
// memory, `grid` whose z axis holds the blocks of a cluster), with the
// kernel's attributes set; `config` and `attr` are filled in.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, size_t bytes, dim3 grid, cudaLaunchConfig_t& config,
                           cudaLaunchAttribute& attr, cudaStream_t stream) {
  const int ranks = static_cast<int>(grid.z);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && ranks > PORTABLE)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  config = cudaLaunchConfig_t{};
  config.gridDim = grid;
  config.blockDim = dim3(THREADS);
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

// The clusters of `ranks` blocks of `kernel` the card can hold at once
// (a cluster launches only if it is at least 1), into `clusters`.
template <typename Kernel>
cudaError_t active_clusters(Kernel kernel, size_t bytes, int ranks, int& clusters) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, bytes, dim3(1, 1, ranks), config, attr, nullptr);
  clusters = 0;
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
}

// A cluster kernel's build: blocks a cluster, slice width at most, and the
// clusters the card can hold at once, into out[0..2].
template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, size_t bytes, int slice, int ranks, int* out) {
  int clusters = 0;
  cudaError_t err = active_clusters(kernel, bytes, ranks, clusters);
  if (err != cudaSuccess) return err;
  out[0] = ranks;
  out[1] = slice;
  out[2] = clusters;
  return cudaSuccess;
}

}  // namespace cluster
