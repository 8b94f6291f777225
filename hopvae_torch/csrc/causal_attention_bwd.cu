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
// What bounds them on an H100: the tensor cores. K5-dkv does four products
// over the causal triangle (q k^T, g v^T, P^T g, dS^T q) and K5-dq three
// (q k^T, g v^T, dS k), 2 * D * S(S+1)/2 FLOPs each per head. Every one
// runs as mma.sync m16n8k8 on TF32 operands in three passes (mma_tf32.cuh),
// so the ceiling is 495 / 3 = 165 TFLOP/s f32-equivalent: at B = 256,
// S = 867, one head of D = 256, 1.20 and 0.90 ms, against about 0.2 ms of
// memory traffic each. One TF32 pass (11 bits of mantissa) would move dQ,
// dK and dV by about 1e-3 normwise, far past the 5e-5 the port holds them
// to; three passes keep about 21 bits, which with f32 sums lands where
// plain f32 does (tests/test_torch_attention_tf32.py emulates both). On
// the card the tensor cores' truncating sums add a little: 3e-6 normwise
// at S = 867 (see the design below). P is rebuilt from lse with scores from
// these products, not from the forward's FMA sums: the two differ by about
// 1e-7 relative, which moves P by about 1e-6.
// The split into two kernels recomputes the scores and g v^T in both; one
// fused kernel would need float atomics for dQ, and the backward must
// repeat bit for bit.
//
// Design (M: the block's resident rows, keys in K5-dkv and query rows in
// K5-dq; N: the rows it streams, query rows in K5-dkv and keys in K5-dq):
// - One block owns TM resident rows of one (batch, head) and walks the
//   streamed tiles of TN rows: K5-dkv from its diagonal to the end, K5-dq
//   up to its diagonal. Each output belongs to one block and is summed in
//   a fixed order: no float atomics. Blocks with the most tiles launch
//   first.
// - The resident tiles (k, v in K5-dkv; q, g in K5-dq) load once; each
//   streamed pair (q, g with lse and delta; k, v) arrives by cp.async into
//   one of two buffers while the other is multiplied. 16-byte copies where
//   an input's base and strides allow it, 4-byte ones where not; rows past
//   S are zero-filled and never written.
// - A warp owns a 16-row slab of the resident tile (the M of an m16
//   mma). With SPLIT warps a slab, each computes the slab's scores and
//   g v^T against the whole streamed tile over 1/SPLIT of the head width;
//   the partial sums meet in shared memory and are added in warp order,
//   each warp finishing 1/SPLIT of the score n-tiles (P, dS) and handing
//   them to the others. Each warp owns 1/SPLIT of the output columns, its
//   dK and dV (or dQ) in accumulator fragments.
// - The score fragments (C layout) become the A operand of the products
//   that sum over the streamed rows (dV, dK, dQ) without a transpose: the
//   k index of those products is permuted so that k = t is streamed row 2t
//   and k = t + 4 row 2t + 1, which makes C's (c0, c2, c1, c3) an A
//   fragment; the B operand is read from the same permuted rows. With
//   SPLIT = 1 they stay in registers; with SPLIT > 1 they go through
//   shared memory in fragment order (one float4 a lane), in f32.
// - dK, dV and dQ are summed over each streamed tile in fresh fragments
//   and added to the running sums after it: the tensor cores' sums
//   truncate, and chains of a few dozen mma keep that error near 3e-6
//   normwise at S = 867 (one chain over the whole walk gave 1.5e-5).
// - Shared memory holds f32 only, rows D + 4 floats apart: D + 4 is 4
//   times an odd number, so the fragment loads by row g (ldmatrix: eight
//   16-byte rows in eight bank groups) and those by permuted row 2t
//   (scalar, banks 8t + g or 8t + 4 + g) hit 32 banks; a tile read in
//   both roles (q and g in K5-dkv, k in K5-dq) needs no swizzle.
//
//   D       TM  TN  SPLIT  warps  shared bytes (dkv / dq)
//   8..64   64  32  1      4      1024 (D + 4) + 512 / 1024 (D + 4)
//   128     64  32  2      8      152,064 / 151,552
//   256     32  32  4      8      216,576 / 216,064
//   (At D = 256 a 16-row slab of dK and dV over the full width would take
//   128 accumulators a thread; four warps a slab keep 32 of each. 64-key
//   tiles with double-buffered q and g would not fit 227 KB.)
//
//   Registers and blocks an SM per width (no spills at any width) are in
//   PERF.md, from causal_attention_bwd_attributes on the card.
//
// Past 256 (any multiple of 128; the wide kernels below, one instance
// each for every such width) the resident tiles no longer fit beside the
// streamed ones, and a warp's dK and dV over the full width would take
// too many registers. A block owns 64 resident rows and one window of
// output columns (a grid axis: 64 columns in K5-dkv, 128 in K5-dq). Per
// streamed tile it streams the four inputs in depth chunks of 64, each
// chunk's products summed in fresh fragments and added to the score and
// g v^T fragments before the exp,
// then the tile's window of the streamed rows (q and g, or k) for its
// outputs. Every window block recomputes the scores over the full depth.
// Shared bytes: 104,448 (two buffers of a chunk of 64 + 64 resident and
// 32 + 32 streamed rows).

#include <cstdint>

#include "causal_attention.cuh"

namespace {

using causal_attention::load_a;
using causal_attention::load_b_cols;
using causal_attention::load_b_rows2;
using causal_attention::out_offset;
using causal_attention::stage;
using causal_attention::Strides;
using causal_attention::vec16_ok;
using namespace tf32x3;

template <int D>
struct Tiles {
  static constexpr int TM = D > 128 ? 32 : 64;  // resident rows of a block
  static constexpr int TN = 32;                 // streamed rows of a tile
  static constexpr int NT = TN / 8;             // n-tiles of a 16 x TN score slab
  static constexpr int SPLIT = D > 128 ? 4 : D > 64 ? 2 : 1;  // warps of a 16-row slab
  static constexpr int WARPS = TM / 16 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RS = D + 4;              // row stride in shared memory
  static constexpr int KD = D / SPLIT;          // depth of a warp's part of the scores
  static constexpr int NTO = NT / SPLIT;        // score n-tiles a warp finishes
  static constexpr int CT = D / SPLIT / 8;      // output n-tiles of a warp
  static constexpr int XCH = TM / 16 * SPLIT * NT * 128;  // floats of one exchange
  static_assert(TM % TN == 0 && NT % SPLIT == 0 && CT >= 1 && KD % 8 == 0, "tiles");
};

// floats of shared memory: two resident tiles, two buffers of two streamed
// tiles, K5-dkv's two buffers of the streamed rows' lse and delta, and,
// when SPLIT > 1, the exchange of partial scores, reused for the hand-over
// of P and dS (K5-dkv) or dS (K5-dq)
template <int D, bool DKV>
constexpr size_t smem_bytes() {
  using C = Tiles<D>;
  const size_t stats = DKV ? 4 * C::TN : 0;
  const size_t exchange = C::SPLIT > 1 ? C::XCH : 0;
  static_assert(C::SPLIT == 1 || (DKV ? 2 : 1) * C::TM * C::TN <= C::XCH, "the hand-over fits the exchange");
  return sizeof(float) * (2 * C::TM * C::RS + 4 * C::TN * C::RS + stats + exchange);
}

// Sum the SPLIT warps' partial fragments of a slab's score n-tiles: each
// warp writes its NT partials, then adds up, in warp order, those of the
// NTO n-tiles it finishes. x: the slab's exchange, [warp][n-tile][lane].
template <int NT, int NTO, int SPLIT>
__device__ __forceinline__ void reduce_parts(float (&part)[NT][4], float (&sum)[NTO][4], float4* x, int w, int lane,
                                             int bar) {
#pragma unroll
  for (int j = 0; j < NT; ++j) x[(w * NT + j) * 32 + lane] = make_float4(part[j][0], part[j][1], part[j][2], part[j][3]);
  named_barrier(bar, 32 * SPLIT);
#pragma unroll
  for (int jj = 0; jj < NTO; ++jj) {
    float4 a = x[(w * NTO + jj) * 32 + lane];
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) {
      const float4 b = x[(p * NT + w * NTO + jj) * 32 + lane];
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    sum[jj][0] = a.x, sum[jj][1] = a.y, sum[jj][2] = a.z, sum[jj][3] = a.w;
  }
  named_barrier(bar, 32 * SPLIT);  // the exchange is free again
}

template <int D, bool DKV>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
causal_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ out_a, float* __restrict__ out_b, int s, int h, Strides qs, Strides ks,
                  Strides vs, Strides gs, float scale, unsigned vec16) {
  using C = Tiles<D>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, RS = C::RS, SPLIT = C::SPLIT, THREADS = C::THREADS;
  constexpr int NTO = C::NTO, CT = C::CT;
  extern __shared__ float4 smem4[];
  float* res0 = reinterpret_cast<float*>(smem4);  // k (dkv) or q (dq)
  float* res1 = res0 + TM * RS;                    // v (dkv) or g (dq)
  float* str = res1 + TM * RS;                     // buffer u: streamed tiles at str + u * 2 * TN * RS
  float* stat = str + 4 * TN * RS;                 // dkv, buffer u: lse, delta at stat + u * 2 * TN
  float4* xch = reinterpret_cast<float4*>(stat + (DKV ? 4 * TN : 0));  // exchange and hand-over

  // inputs by role: resident 0 and 1, streamed 0 and 1; vec16 has bits q, k, v, g
  const float* r0p = DKV ? k : q;
  const float* r1p = DKV ? v : g;
  const float* s0p = DKV ? q : k;
  const float* s1p = DKV ? g : v;
  const Strides r0s = DKV ? ks : qs, r1s = DKV ? vs : gs, s0s = DKV ? qs : ks, s1s = DKV ? gs : vs;
  const bool r0v = vec16 >> (DKV ? 1 : 0) & 1u, r1v = vec16 >> (DKV ? 2 : 3) & 1u;
  const bool s0v = vec16 >> (DKV ? 0 : 1) & 1u, s1v = vec16 >> (DKV ? 3 : 2) & 1u;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / SPLIT, part = warp % SPLIT;
  const int m0 = 16 * slab;  // the warp's resident rows in the tile
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int mt = DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;  // the longest walks first
  const int row_m0 = mt * TM;
  const int first = DKV ? row_m0 / TN : 0;
  const int last = DKV ? (s - 1) / TN : (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;  // its first resident row (key or query row)
  float4* x = xch + slab * SPLIT * NT * 32;  // the slab's exchange
  const int bar = 1 + slab;                  // the slab's named barrier

  stage<D, TM, THREADS>(res0, r0p, r0s, b, hh, row_m0, s, r0v);
  stage<D, TM, THREADS>(res1, r1p, r1s, b, hh, row_m0, s, r1v);

  auto stage_stream = [&](int it, int u) {
    float* y = str + u * 2 * TN * RS;
    stage<D, TN, THREADS>(y, s0p, s0s, b, hh, it * TN, s, s0v);
    stage<D, TN, THREADS>(y + TN * RS, s1p, s1s, b, hh, it * TN, s, s1v);
    if constexpr (DKV) {
      float* st = stat + u * 2 * TN;
      for (int i = threadIdx.x; i < 2 * TN; i += THREADS) {
        const int r = it * TN + (i % TN);
        const bool in = r < s;
        const float* src = (i < TN ? lse : delta) + static_cast<size_t>(bh) * s;
        cp_async4(st + i, in ? src + r : src, in);
      }
    }
    cp_async_commit();
  };
  stage_stream(first, 0);

  // K5-dq: lse and delta of the warp's rows gq and gq + 8
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = slab_lo + gq + 8 * e;
      if (row < s) {
        lse_r[e] = lse[static_cast<size_t>(bh) * s + row];
        dl_r[e] = delta[static_cast<size_t>(bh) * s + row];
      }
    }
  }

  // accumulators: dK and dV (dkv) or dQ (dq, acc0 only), rows gq and gq + 8
  // of the slab, columns D / SPLIT * part + 8c + 2tq and + 1
  float acc0[CT][4], acc1[DKV ? CT : 1][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[c][e] = acc1[DKV ? c : 0][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_stream(it + 1, u ^ 1);
    const float* y0 = str + u * 2 * TN * RS;  // q (dkv) or k (dq)
    const float* y1 = y0 + TN * RS;           // g (dkv) or v (dq)
    const float* st = stat + u * 2 * TN;
    const int n_lo = it * TN;  // the tile's first streamed row

    // a slab whose keys all exceed its rows (or whose rows are all past S)
    // in this tile has P = dS = 0: its warps skip the tile together
    if (DKV ? (slab_lo > n_lo + TN - 1 || n_lo >= s) : (n_lo > slab_lo + 15 || slab_lo >= s)) continue;

    // ---- the warp's part (columns KD * part ..) of the slab's 16 x TN
    // scores and g v^T, C layout
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kk = C::KD * part; kk < C::KD * (part + 1); kk += 8) {
      const FragA xa = load_a<RS>(res0 + m0 * RS + kk, gq, tq);
      const FragA wa = load_a<RS>(res1 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB y0b, y1b, z0b, z1b;
        load_b_rows2<RS>(y0b, y1b, y0 + 8 * j * RS + kk, gq, tq);
        load_b_rows2<RS>(z0b, z1b, y1 + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], xa, y0b);
        mma3(dp[j], wa, z0b);
        mma3(sc[j + 1], xa, y1b);
        mma3(dp[j + 1], wa, z1b);
      }
    }

    // ---- the full sums of the n-tiles the warp finishes: j = NTO * part + jj
    float fs[NTO][4], fd[NTO][4];
    if constexpr (SPLIT > 1) {
      reduce_parts<NT, NTO, SPLIT>(sc, fs, x, part, lane, bar);
      reduce_parts<NT, NTO, SPLIT>(dp, fd, x, part, lane, bar);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fs[j][e] = sc[j][e], fd[j][e] = dp[j][e];
    }

    // ---- P and dS, in place
#pragma unroll
    for (int jj = 0; jj < NTO; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = slab_lo + gq + 8 * (e >> 1);                       // resident row
        const int n = n_lo + 8 * (NTO * part + jj) + 2 * tq + (e & 1);  // streamed row
        const int key = DKV ? m : n, row = DKV ? n : m;
        const float l = DKV ? st[n - n_lo] : lse_r[e >> 1];
        const float dl = DKV ? st[TN + n - n_lo] : dl_r[e >> 1];
        const float p = key <= row && row < s ? __expf(fs[jj][e] * scale - l) : 0.f;
        fs[jj][e] = p;
        fd[jj][e] = p * (fd[jj][e] - dl);
      }

    // ---- hand them to the slab's other warps (SPLIT > 1), in A-fragment
    // order: x[n-tile][lane] holds dS, and in K5-dkv x[NT + n-tile][lane] P
    if constexpr (SPLIT > 1) {
#pragma unroll
      for (int jj = 0; jj < NTO; ++jj) {
        const int j = NTO * part + jj;
        x[j * 32 + lane] = make_float4(fd[jj][0], fd[jj][2], fd[jj][1], fd[jj][3]);
        if constexpr (DKV) x[(NT + j) * 32 + lane] = make_float4(fs[jj][0], fs[jj][2], fs[jj][1], fs[jj][3]);
      }
      named_barrier(bar, 32 * SPLIT);
    }

    // ---- dV += P^T g and dK += dS^T q (dkv), dQ += dS k (dq), over the
    // tile's streamed rows 8j .. 8j + 7 in order, into the tile's partial
    // sums o0, o1, added to acc0, acc1 after the tile (the tensor cores'
    // sums truncate, and short chains keep that error 4x smaller at S = 867)
    float o0[CT][4], o1[DKV ? CT : 1][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o0[c][e] = o1[DKV ? c : 0][e] = 0.f;
    const int dc0 = D / SPLIT * part;  // the warp's output columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      // rows j with no key <= row, or past S, hold zeros only
      if (DKV ? (n8 + 7 < slab_lo || n8 >= s) : (n8 > slab_lo + 15 || n8 >= s)) continue;
      float pa[4], da[4];
      if constexpr (SPLIT == 1) {
        pa[0] = fs[j][0], pa[1] = fs[j][2], pa[2] = fs[j][1], pa[3] = fs[j][3];
        da[0] = fd[j][0], da[1] = fd[j][2], da[2] = fd[j][1], da[3] = fd[j][3];
      } else {
        const float4 d4 = x[j * 32 + lane];
        da[0] = d4.x, da[1] = d4.y, da[2] = d4.z, da[3] = d4.w;
        if constexpr (DKV) {
          const float4 p4 = x[(NT + j) * 32 + lane];
          pa[0] = p4.x, pa[1] = p4.y, pa[2] = p4.z, pa[3] = p4.w;
        }
      }
      const FragA dsa = split_a(da[0], da[1], da[2], da[3]);
      if constexpr (DKV) {
        const FragA pfa = split_a(pa[0], pa[1], pa[2], pa[3]);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = dc0 + 8 * c;
          mma3(o1[c], pfa, load_b_cols<RS>(y1 + 8 * j * RS + col, gq, tq));  // dV, g
          mma3(o0[c], dsa, load_b_cols<RS>(y0 + 8 * j * RS + col, gq, tq));  // dK, q
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          mma3(o0[c], dsa, load_b_cols<RS>(y0 + 8 * j * RS + dc0 + 8 * c, gq, tq));  // dQ, k
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[c][e] += o0[c][e];
        if constexpr (DKV) acc1[c][e] += o1[c][e];
      }
  }

  // ---- write dK, dV (dkv) or dQ (dq): rows of the slab < S
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = out_offset<D>(b, row, hh, s, h) + D / SPLIT * part + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      *reinterpret_cast<float2*>(out_a + at + 8 * c) =
          make_float2(acc0[c][2 * e] * scale, acc0[c][2 * e + 1] * scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out_b + at + 8 * c) = make_float2(acc1[c][2 * e], acc1[c][2 * e + 1]);
    }
  }
}

template <int D, bool DKV>
int launch(const float* q, const float* k, const float* v, const float* g, const float* lse,
           const float* delta, float* out_a, float* out_b, int b, int s, int h, Strides qs, Strides ks,
           Strides vs, Strides gs, float scale, cudaStream_t stream) {
  using C = Tiles<D>;
  const int m_tiles = (s + C::TM - 1) / C::TM;
  if (b <= 0 || s <= 0 || h <= 0 || static_cast<long long>(b) * h > 0x7fffffffLL || m_tiles > 65535)
    return cudaErrorInvalidValue;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2 | vec16_ok(g, gs) << 3;
  auto kernel = causal_bwd_kernel<D, DKV>;
  constexpr size_t bytes = smem_bytes<D, DKV>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * h, m_tiles), C::THREADS, bytes, stream>>>(q, k, v, g, lse, delta, out_a, out_b, s, h, qs, ks,
                                                              vs, gs, scale, vec16);
  return cudaGetLastError();
}


// ---- head widths past 256: the wide kernels, one instance each for every
// multiple of 128 (the width d is a runtime argument)
namespace wide {
constexpr int TM = 64;        // resident rows of a block, a warp a 16-row slab
constexpr int TN = 32;        // streamed rows of a tile
constexpr int NT = TN / 8;    // n-tiles of a 16 x TN score slab
constexpr int DC = 64;        // depth of a streamed chunk
constexpr int THREADS = 32 * TM / 16;
constexpr int RC = DC + 4;    // row stride of a chunk
constexpr int STEP = 128;     // the wide widths: multiples of this past 256
template <bool DKV>
struct Window {
  static constexpr int CW = DKV ? 64 : 128;  // output columns of a block (dK and dV, or dQ)
  static constexpr int CT = CW / 8;          // a warp's output n-tiles
  static constexpr int RW = CW + 4;          // row stride of a window tile
};
// one buffer: a chunk item (two resident chunks of TM rows, two streamed
// ones of TN), or a window item (the streamed window tiles, K5-dkv's two
// with the tile's lse and delta)
template <bool DKV>
__host__ __device__ constexpr int slot() {
  constexpr int chunk = (2 * TM + 2 * TN) * RC;
  constexpr int window = (DKV ? 2 : 1) * TN * Window<DKV>::RW + (DKV ? 2 * TN : 0);
  return chunk > window ? chunk : window;
}
template <bool DKV>
__host__ __device__ constexpr size_t bytes() { return sizeof(float) * 2 * slot<DKV>(); }
}  // namespace wide

template <bool DKV>
__global__ void __launch_bounds__(wide::THREADS)
causal_bwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ out_a, float* __restrict__ out_b, int s, int h, int d, Strides qs,
                       Strides ks, Strides vs, Strides gs, float scale, unsigned vec16) {
  using namespace wide;
  using Wn = Window<DKV>;
  constexpr int CW = Wn::CW, CT = Wn::CT, RW = Wn::RW, SLOT = slot<DKV>();
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * SLOT

  // inputs by role, as in causal_bwd_kernel
  const float* r0p = DKV ? k : q;
  const float* r1p = DKV ? v : g;
  const float* s0p = DKV ? q : k;
  const float* s1p = DKV ? g : v;
  const Strides r0s = DKV ? ks : qs, r1s = DKV ? vs : gs, s0s = DKV ? qs : ks, s1s = DKV ? gs : vs;
  const bool r0v = vec16 >> (DKV ? 1 : 0) & 1u, r1v = vec16 >> (DKV ? 2 : 3) & 1u;
  const bool s0v = vec16 >> (DKV ? 0 : 1) & 1u, s1v = vec16 >> (DKV ? 3 : 2) & 1u;

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int mt = DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int row_m0 = mt * TM;
  const int col0 = blockIdx.z * CW;  // the block's window of output columns
  const int first = DKV ? row_m0 / TN : 0;
  const int last = DKV ? (s - 1) / TN : (min(row_m0 + TM, s) - 1) / TN;
  const int slab_lo = row_m0 + m0;
  const int chunks = d / DC;
  const int per_tile = chunks + 1;  // items of a streamed tile: the depth chunks, then the window
  const int items = (last - first + 1) * per_tile;

  auto stage_item = [&](int i, int u) {
    float* y = buf + u * SLOT;
    const int it = first + i / per_tile, sub = i % per_tile;
    if (sub < chunks) {
      const int c0 = sub * DC;
      stage<DC, TM, THREADS>(y, r0p + c0, r0s, b, hh, row_m0, s, r0v);
      stage<DC, TM, THREADS>(y + TM * RC, r1p + c0, r1s, b, hh, row_m0, s, r1v);
      stage<DC, TN, THREADS>(y + 2 * TM * RC, s0p + c0, s0s, b, hh, it * TN, s, s0v);
      stage<DC, TN, THREADS>(y + 2 * TM * RC + TN * RC, s1p + c0, s1s, b, hh, it * TN, s, s1v);
    } else {
      stage<CW, TN, THREADS>(y, s0p + col0, s0s, b, hh, it * TN, s, s0v);  // q (dkv) or k (dq)
      if constexpr (DKV) {
        stage<CW, TN, THREADS>(y + TN * RW, s1p + col0, s1s, b, hh, it * TN, s, s1v);  // g
        float* st = y + 2 * TN * RW;
        for (int j = threadIdx.x; j < 2 * TN; j += THREADS) {
          const int r = it * TN + (j % TN);
          const bool in = r < s;
          const float* src = (j < TN ? lse : delta) + static_cast<size_t>(bh) * s;
          cp_async4(st + j, in ? src + r : src, in);
        }
      }
    }
    cp_async_commit();
  };
  stage_item(0, 0);

  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = slab_lo + gq + 8 * e;
      if (row < s) {
        lse_r[e] = lse[static_cast<size_t>(bh) * s + row];
        dl_r[e] = delta[static_cast<size_t>(bh) * s + row];
      }
    }
  }

  float acc0[CT][4], acc1[DKV ? CT : 1][4], sc[NT][4], dp[NT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[c][e] = acc1[DKV ? c : 0][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    const int u = i & 1;
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    if (i + 1 < items) stage_item(i + 1, u ^ 1);
    const float* y = buf + u * SLOT;
    const int it = first + i / per_tile, sub = i % per_tile;
    const int n_lo = it * TN;
    if (DKV ? (slab_lo > n_lo + TN - 1 || n_lo >= s) : (n_lo > slab_lo + 15 || slab_lo >= s)) continue;

    if (sub < chunks) {
      // ---- this chunk's part of the slab's scores and g v^T, in fresh
      // fragments (short chains of the truncating sums), then added
      float ps[NT][4], pd[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[j][e] = pd[j][e] = 0.f;
      const float* y0 = y + 2 * TM * RC;  // streamed chunk 0
      const float* y1 = y0 + TN * RC;     // streamed chunk 1
#pragma unroll 2
      for (int kk = 0; kk < DC; kk += 8) {
        const FragA xa = load_a<RC>(y + m0 * RC + kk, gq, tq);
        const FragA wa = load_a<RC>(y + TM * RC + m0 * RC + kk, gq, tq);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB y0b, y1b, z0b, z1b;
          load_b_rows2<RC>(y0b, y1b, y0 + 8 * j * RC + kk, gq, tq);
          load_b_rows2<RC>(z0b, z1b, y1 + 8 * j * RC + kk, gq, tq);
          mma3(ps[j], xa, y0b);
          mma3(pd[j], wa, z0b);
          mma3(ps[j + 1], xa, y1b);
          mma3(pd[j + 1], wa, z1b);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = sub == 0 ? ps[j][e] : sc[j][e] + ps[j][e];
          dp[j][e] = sub == 0 ? pd[j][e] : dp[j][e] + pd[j][e];
        }
      continue;
    }

    // ---- the window: P and dS on the whole sums, then the outputs
    const float* w0 = y;         // q (dkv) or k (dq), the window's columns
    const float* w1 = y + TN * RW;  // g (dkv)
    const float* st = y + 2 * TN * RW;
    float fs[NT][4], fd[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = slab_lo + gq + 8 * (e >> 1);
        const int n = n_lo + 8 * j + 2 * tq + (e & 1);
        const int key = DKV ? m : n, row = DKV ? n : m;
        const float l = DKV ? st[n - n_lo] : lse_r[e >> 1];
        const float dl = DKV ? st[TN + n - n_lo] : dl_r[e >> 1];
        const float p = key <= row && row < s ? __expf(sc[j][e] * scale - l) : 0.f;
        fs[j][e] = p;
        fd[j][e] = p * (dp[j][e] - dl);
      }
    float o0[CT][4], o1[DKV ? CT : 1][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o0[c][e] = o1[DKV ? c : 0][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n8 = n_lo + 8 * j;
      if (DKV ? (n8 + 7 < slab_lo || n8 >= s) : (n8 > slab_lo + 15 || n8 >= s)) continue;
      const FragA dsa = split_a(fd[j][0], fd[j][2], fd[j][1], fd[j][3]);
      if constexpr (DKV) {
        const FragA pfa = split_a(fs[j][0], fs[j][2], fs[j][1], fs[j][3]);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          mma3(o1[c], pfa, load_b_cols<RW>(w1 + 8 * j * RW + 8 * c, gq, tq));  // dV, g
          mma3(o0[c], dsa, load_b_cols<RW>(w0 + 8 * j * RW + 8 * c, gq, tq));  // dK, q
        }
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c) mma3(o0[c], dsa, load_b_cols<RW>(w0 + 8 * j * RW + 8 * c, gq, tq));  // dQ, k
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc0[c][e] += o0[c][e];
        if constexpr (DKV) acc1[c][e] += o1[c][e];
      }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= s) continue;
    const size_t at = (static_cast<size_t>(b) * s + row) * static_cast<size_t>(h) * d + static_cast<size_t>(hh) * d +
                      col0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      *reinterpret_cast<float2*>(out_a + at + 8 * c) =
          make_float2(acc0[c][2 * e] * scale, acc0[c][2 * e + 1] * scale);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(out_b + at + 8 * c) = make_float2(acc1[c][2 * e], acc1[c][2 * e + 1]);
    }
  }
}

template <bool DKV>
int launch_wide(const float* q, const float* k, const float* v, const float* g, const float* lse,
                const float* delta, float* out_a, float* out_b, int b, int s, int h, int d, Strides qs, Strides ks,
                Strides vs, Strides gs, float scale, cudaStream_t stream) {
  using namespace wide;
  const int m_tiles = (s + TM - 1) / TM;
  if (b <= 0 || s <= 0 || h <= 0 || d <= 256 || d % STEP != 0 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      m_tiles > 65535)
    return cudaErrorInvalidValue;
  const unsigned vec16 = vec16_ok(q, qs) | vec16_ok(k, ks) << 1 | vec16_ok(v, vs) << 2 | vec16_ok(g, gs) << 3;
  auto kernel = causal_bwd_wide_kernel<DKV>;
  constexpr size_t bytes = wide::bytes<DKV>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * h, m_tiles, d / Window<DKV>::CW), THREADS, bytes, stream>>>(q, k, v, g, lse, delta, out_a, out_b,
                                                                               s, h, d, qs, ks, vs, gs, scale, vec16);
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
    default: return launch_wide<DKV>(q, k, v, g, lse, delta, out_a, out_b, b, s, h, d, qs, ks, vs, gs, scale, st);
  }
}

template <int D, bool DKV>
int attributes(int* out) {
  using C = Tiles<D>;
  return kernel_attributes(causal_bwd_kernel<D, DKV>, C::THREADS, smem_bytes<D, DKV>(), C::TM, C::TN, out);
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v and g (the cotangent
// of out) are device pointers to strided (B, S, heads, D) f32 arrays whose
// D axis is contiguous, with their batch, sequence and head strides in
// elements; lse and delta are contiguous (B, heads, S); dk, dv and dq are
// contiguous (B, S, heads, D); D is 8, 16, 32, 64, 128, 256 or a multiple
// of 128 past 256. Each returns a cudaError_t; 0 means the launch was
// accepted.
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

// The kernel of head width d (dkv != 0: K5-dkv, else K5-dq) as built: out
// receives registers a thread, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, blocks an SM, TM and TN. Returns a cudaError_t.
extern "C" int causal_attention_bwd_attributes(int d, int dkv, int* out) {
  switch (d) {
    case 8: return dkv ? attributes<8, true>(out) : attributes<8, false>(out);
    case 16: return dkv ? attributes<16, true>(out) : attributes<16, false>(out);
    case 32: return dkv ? attributes<32, true>(out) : attributes<32, false>(out);
    case 64: return dkv ? attributes<64, true>(out) : attributes<64, false>(out);
    case 128: return dkv ? attributes<128, true>(out) : attributes<128, false>(out);
    case 256: return dkv ? attributes<256, true>(out) : attributes<256, false>(out);
    default:
      if (d <= 256 || d % wide::STEP != 0) return cudaErrorInvalidValue;
      return dkv ? kernel_attributes(causal_bwd_wide_kernel<true>, wide::THREADS, wide::bytes<true>(), wide::TM,
                                     wide::TN, out)
                 : kernel_attributes(causal_bwd_wide_kernel<false>, wide::THREADS, wide::bytes<false>(), wide::TM,
                                     wide::TN, out);
  }
}
