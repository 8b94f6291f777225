// Shared pieces of the causal flash-attention kernels (K5):
// causal_attention_fwd.cu and causal_attention_bwd.cu.
//
// Every kernel works on tiles of T query rows or T keys of one (batch,
// head) of a (B, S, heads, D) f32 tensor, with 256 threads as a 16 x 16
// grid: thread (ty, tx) owns rows ty*R+i and keys (or columns) tx+16*j,
// i, j < R = T/16, of a T x T score tile. The 16 threads that share a row
// are one half-warp.
//
// T is 64 up to D = 128 and 32 at D = 256. A (64, 256) f32 tile takes
// 66.6 KB of shared memory, so the backward's four resident tiles (k, v,
// q and the cotangent g: 266 KB) would not fit the 227 KB a block may
// have, and its dK and dV accumulators would take 128 registers a
// thread. Halving the tile keeps every kernel's layout, loop order and
// FMA order as they are at the other widths: 32-row tiles need 142,592 B
// in the backward and 104,448 B in the forward (two blocks an SM), and
// each thread keeps as many accumulators as at D = 128. (The other way, two
// 128-wide halves of the head, would have to sum the score products over
// both halves before the exp, so each block would still read whole rows.)

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace causal_attention {

constexpr int THREADS = 256;      // 16 x 16
constexpr unsigned FULL = 0xffffffffu;

// Query rows or keys of a tile at head width D.
template <int D>
__host__ __device__ constexpr int tile() { return D > 128 ? 32 : 64; }

// Rows of a tile, and keys of a score tile, that each thread owns.
template <int D>
__host__ __device__ constexpr int per_thread() { return tile<D>() / 16; }

// Row stride of a (T, T) probability tile in shared memory.
template <int D>
__host__ __device__ constexpr int p_stride() { return tile<D>() + 4; }

// Row stride of a (T, D) tile in shared memory: the 4 extra floats shift
// consecutive rows by 4 banks, so float4 reads across rows do not conflict.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

// Columns of a (T, D) output tile that each thread of a row owns. Below
// D = 16 the first D threads of a row own one column each and the rest idle.
template <int D>
__host__ __device__ constexpr int cols() { return D >= 16 ? D / 16 : 1; }

// Element strides of one strided (B, S, heads, D) input; D is contiguous.
struct Strides {
  long long b, s, h;
};

// Stage rows [row0, row0 + T) of head (b, hh) of a strided input into
// shared memory (T x row_stride<D>()), with zeros past the sequence end.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides st, int b,
                                          int hh, int row0, int s) {
  const float* base = src + b * st.b + hh * st.h;
  for (int idx = threadIdx.x; idx < tile<D>() * D; idx += THREADS) {
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

// Store 4 or 2 consecutive floats to shared memory as one float4 or float2.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  static_assert(N == 4 || N == 2, "a thread owns 4 or 2 rows of a tile");
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// acc[i][j] = a_(ty*R+i) . b_(tx+16*j): a T x T tile of dot products of
// the rows of two (T, D) tiles in shared memory, in FMA order over D.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[per_thread<D>()][per_thread<D>()], const float* a_s,
                                         const float* b_s, int ty, int tx) {
  constexpr int RS = row_stride<D>();
  constexpr int R = per_thread<D>();
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = *reinterpret_cast<const float4*>(a_s + (ty * R + i) * RS + c);
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * RS + c);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
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

// Whether a launch's grid fits: B * heads blocks along x and at most
// 65535 tiles along y.
template <int D>
inline bool grid_fits(int b, int s, int h) {
  return b > 0 && s > 0 && h > 0 && static_cast<long long>(b) * h <= 0x7fffffffLL &&
         (s + tile<D>() - 1) / tile<D>() <= 65535;
}

}  // namespace causal_attention
