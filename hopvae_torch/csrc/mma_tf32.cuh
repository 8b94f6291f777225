// Tensor-core products in f32 grade, and asynchronous staging, for Hopper
// (sm_90a): the pieces of K5's kernels (causal_attention_fwd.cu and
// causal_attention_bwd.cu) and of the streaming Hopfield kernels K1 to K4
// (hopfield_stream_fwd.cu, hopfield_stream_bwd_dx.cu,
// hopfield_stream_bwd_dku.cu, hopfield_bottleneck_fused.cu).
//
// A product runs as mma.sync m16n8k8 on TF32 operands in three passes.
// Each f32 operand x splits into big = tf32(x) and small = tf32(x - big),
// both rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero, 10 mantissa bits), and
//
//     a b ~ small_a big_b + big_a small_b + big_a big_b
//
// accumulated in f32, the two cross terms first so that they are added
// before the large one. That keeps about 21 bits of each operand, close to
// f32, at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on an H100);
// one TF32 pass keeps 11 bits and moves the attention gradients by about
// 1e-3 normwise, 12 to 19 times the 5e-5 the port holds them to.
//
// Fragment layouts of m16n8k8 (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row-major):  (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
//   B (8 x 8, k by n):      (k = t, n = g), (k = t + 4, n = g)
//   C (16 x 8):             (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, 10 mantissa bits), bit for bit for every finite x, in two
// integer operations: the backward ran faster so on an H100 than with cvt
// itself, with the same outputs (PERF.md).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An A fragment split into its big and small TF32 parts.
struct FragA {
  uint32_t big[4], small[4];
};

// A B fragment split into its big and small TF32 parts.
struct FragB {
  uint32_t big[2], small[2];
};

// TRUNC: the small part is passed whole, and the tensor cores, which read
// the top 19 bits of a TF32 operand, truncate it instead of rounding it (an
// error of at most 2^-22 |x| either way), for two integer operations less
// a value. The wide backward (causal_attention_bwd.cu's cluster kernels)
// splits so; every other kernel rounds both parts.
template <bool TRUNC = false>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  const float rest = x - __uint_as_float(big);
  small = TRUNC ? __float_as_uint(rest) : round_tf32(rest);
}

template <bool TRUNC = false>
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split<TRUNC>(a0, f.big[0], f.small[0]);
  split<TRUNC>(a1, f.big[1], f.small[1]);
  split<TRUNC>(a2, f.big[2], f.small[2]);
  split<TRUNC>(a3, f.big[3], f.small[3]);
  return f;
}

template <bool TRUNC = false>
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split<TRUNC>(b0, f.big[0], f.small[0]);
  split<TRUNC>(b1, f.big[1], f.small[1]);
  return f;
}

// ldmatrix of four 8 x 4 f32 blocks: lane l receives word l & 3 of row
// l >> 2 of each block; lanes 8i .. 8i + 7 address the rows of block i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a b, one TF32 pass
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three passes: small_a big_b, big_a small_b, then big_a big_b
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// 16-byte copy from device to shared memory; zero-fills when !in (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(in ? 16 : 0));
}

// 4-byte copy, for inputs whose base or strides are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// Wait for all but the most recent group of copies.
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// Barrier `id` (1 to 15) over `threads` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Fragments read from f32 tiles in shared memory whose rows are RS floats
// apart. RS is 4 times an odd number (a multiple of 8, plus 4): the loads
// by row g (ldmatrix: eight 16-byte rows in eight bank groups) and those
// by permuted row 2t (scalar, banks 8t + g or 8t + 4 + g) hit 32 banks, so
// no tile needs a swizzle.

// The A fragment of rows 0..15 and columns 0..7 of a tile in shared memory.
template <int RS, bool TRUNC = false>
__device__ __forceinline__ FragA load_a(const float* p, int gq, int tq) {
  const int lane = 4 * gq + tq;
  uint32_t r[4];
  ldmatrix_x4(r, p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 4 * (lane >> 4));
  return split_a<TRUNC>(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                        __uint_as_float(r[3]));
}

// The B fragments B[k][n] = Y[n][k] of two n-tiles, rows n = 0..15,
// columns k = 0..7.
template <int RS, bool TRUNC = false>
__device__ __forceinline__ void load_b_rows2(FragB& f0, FragB& f1, const float* p, int gq, int tq) {
  const int lane = 4 * gq + tq;
  uint32_t r[4];
  ldmatrix_x4(r, p + ((lane & 7) + 8 * (lane >> 4)) * RS + 4 * ((lane >> 3) & 1));
  f0 = split_b<TRUNC>(__uint_as_float(r[0]), __uint_as_float(r[1]));
  f1 = split_b<TRUNC>(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

// The B fragment B[k][n] = Y[k][n] over the permuted k: rows 2t and 2t + 1.
// With it, a C fragment (c0, c1, c2, c3) read as the A fragment
// (c0, c2, c1, c3) multiplies without a transpose: its k = t is column 2t
// of C and k = t + 4 column 2t + 1.
template <int RS, bool TRUNC = false>
__device__ __forceinline__ FragB load_b_cols(const float* p, int gq, int tq) {
  return split_b<TRUNC>(p[2 * tq * RS + gq], p[(2 * tq + 1) * RS + gq]);
}

// A kernel as built, with `bytes` of dynamic shared memory (whose limit
// it sets): registers a thread, dynamic shared bytes, local (spill) bytes
// a thread, threads a block, blocks an SM, and the kernel's two tile
// sizes (resident and streamed rows), into out[0..6]. Returns a
// cudaError_t.
template <typename Kernel>
cudaError_t kernel_attributes(Kernel kernel, int threads, size_t bytes, int tile_a, int tile_b, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(bytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  out[4] = blocks;
  out[5] = tile_a;
  out[6] = tile_b;
  return cudaSuccess;
}

}  // namespace tf32x3
