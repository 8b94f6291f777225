// The wide streaming Hopfield lookups on a thread-block cluster, past a
// width of 256 on either side and up to 8192 on the wider one: the
// backward, K2's dq (hopfield_stream_bwd_dx.cu) and K3's dK and dU
// (hopfield_stream_bwd_dku.cu), and the forward, K1
// (hopfield_stream_fwd.cu) and K4's three stages
// (hopfield_bottleneck_fused.cu), with d_in and d_out past 128 (plan,
// below; the forward is described at stream_fwd_cluster_kernel).
//
// The backward is one kernel, stream_bwd_cluster_kernel<J, DKU>, with the roles
// of K5's cluster backward (causal_attention_bwd.cu: K2 is its dq, K3 its
// dkv): R blocks on the grid's z axis share TM resident rows (K2 tokens,
// K3 patterns) and split the depth on cluster.cuh's plan, from the wider
// of d_in and d_out (slices of 128 columns up to 1024, 256 up to 2048, 512
// up to 8192). Block rank r keeps columns [r SL, r SL + SL) of both
// resident arrays (K2 q and g, K3 K and U) in shared memory for the whole
// walk and streams the same columns of each tile of TN streamed rows (K2
// K and U, K3 q and g with the tokens' m, 1/l and delta) into one of NB
// buffers. A side with fewer columns than R slices leaves the higher
// ranks' slices empty on that side (at (3, 384) only rank 0 holds q); a
// slice is zero-padded in shared memory to the next multiple of 8, never
// in device memory, and beta and the LayerNorm use the real width.
//
// Per tile each warp (a 16-row slab, a part of PART = 64 columns of the
// slice) computes its partial scores and g U^T (K3: K q^T, U g^T) in fresh
// sums; the partials meet by reduce-scatter over DSMEM: n-tile j of a slab
// is finished by one warp of the cluster, which adds each rank's parts in
// part order and the ranks in rank order (an empty part adds nothing),
// computes A = exp(beta s - m) / l and dS = A (g U^T - delta) beta on it,
// and stores dS (K3: and A) in A-fragment order into the shared memory of
// every rank, where the warps with output columns read the slab's n-tiles
// (K5 loads them from their finishers instead: storing them ran 1% to 5%
// faster on an H100). So every rank holds the same dS bit for bit, and no
// block recomputes a score. Each warp then sums
// its PART output columns of the slice over the tile's streamed rows in
// fresh fragments: K2 dq += dS K from the K slice already staged, K3
// dK += dS^T q and dU += A^T g from the q and g slices. Two split cluster
// barriers a tile, the previous tile's outputs and the next tile's
// partials between them (K5's schedule); with three buffers a tile's
// copies start two tiles ahead.
//
// Every product is three-pass TF32 mma.sync with the small part truncated
// (split<true>, as K5's cluster kernels). The outputs are partial rows,
// one per split of K2's pattern axis or chunk of K3's token axis, summed
// in a fixed order by the callers: no float atomics.
//
//   J  SL   TM  TN  NB (K2 / K3 / K1)  shared bytes (K2 / K3 / K1)
//   1  128  64  32  3 / 3 / 4          209,920 / 219,264 / 201,728
//   2  256  32  16  3 / 3 / 4          184,832 / 187,456 / 178,688
//   4  512  16  16  2 / 2 / 2          215,552 / 216,960 / 175,360

#pragma once

#include "cluster.cuh"
#include "hopfield_stream.cuh"
#include "hopfield_wide.cuh"

namespace hopfield_cluster {

using namespace cluster;
using hopfield_stream::FULL;
using hopfield_stream::MASKED;
using hopfield_stream::MAX_WIDTH;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::cp_async_wait_prior;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::load_a;
using tf32x3::load_b_cols;
using tf32x3::load_b_rows2;
using tf32x3::mma3;
using tf32x3::named_barrier;
using tf32x3::split_a;
using hopfield_wide::Epilogue;
using hopfield_wide::PLAIN;
using hopfield_wide::QUANTIZE;
using hopfield_wide::SHIFT;

// The slices of a lookup of widths (d_in, d_out): J (chunks of 128 a
// slice) and the blocks of a cluster, from the wider side; false where
// both widths are at most MAX_WIDTH (the built instances), where d_in is
// at most WINDOW_IN, or where the wider is past 8192 (a cluster of more
// than 16 blocks). Where it holds, a product's parts of 64 are summed in
// the slices' order (groups of 2J parts, the small TF32 parts truncated),
// on the cluster (plan) and on the narrow-side kernels alike
// (hopfield_narrow::score_order), so that the scores K2 and K3 rebuild
// meet K1's m and l summed as K1 summed them, whichever route each runs.
constexpr int WINDOW_IN = 128;
inline bool slices(int d_in, int d_out, int& j, int& ranks) {
  const int d = d_in > d_out ? d_in : d_out;
  if (d <= MAX_WIDTH || d_in <= WINDOW_IN) return false;
  const int n = (d + STEP - 1) / STEP;
  j = chunks_per_rank(n);
  ranks = j ? (n + j - 1) / j : 0;
  return j != 0;
}

// The cluster of a lookup, forward (K1, K4's stages) and backward (K2,
// K3) alike: slices', with d_out past WINDOW_IN too. With one side at most
// 128 the narrow-side kernels (hopfield_narrow.cuh) run instead: dq, dK
// or the output then has one window, or the scores are computed once for
// all windows (K2's and K3's split products), and they ran faster on an
// H100 (N 4,096, M 512: K1 at (384, 3) 0.222 to 0.227 ms against the
// cluster's 0.251, at (3, 384) 0.119 against 0.216; K2 at (3, 384) 0.113
// against 0.268, K3 0.246 against 0.377; K4 at (64, 300) 0.372 to 0.381
// against 0.473 with its (300, 64) stage on the cluster; K2 and K3 at
// (384, 3): PERF.md).
inline bool plan(int d_in, int d_out, int& j, int& ranks) {
  return d_out > WINDOW_IN && slices(d_in, d_out, j, ranks);
}

// The chunks of `tiles` streamed tiles for `clusters` clusters of resident
// rows, `concurrent` of which the card holds at once: the fewest that give
// the least waves of clusters times a cluster's time, its tiles and FIXED
// tile-times of its own (staging the resident slices, filling and draining
// the pipeline, writing the partial rows). FIXED fits the H100's times of
// K3 at 512 -> 512 with 1 and with 8 waves (PERF.md).
constexpr int FIXED = 2;
inline int cluster_chunks(int tiles, int clusters, int concurrent) {
  const long long c = concurrent > 0 ? concurrent : 1;
  int best = 1;
  long long best_cost = -1;
  for (int chunks = 1; chunks <= tiles; ++chunks) {
    const int per = (tiles + chunks - 1) / chunks;
    if ((tiles + per - 1) / per != chunks) continue;  // the same split as fewer chunks
    const long long cost = (static_cast<long long>(clusters) * chunks + c - 1) / c * (per + FIXED);
    if (best_cost < 0 || cost < best_cost) best = chunks, best_cost = cost;
  }
  return best;
}

// float4s of the partials: [slab][part][scores, g U^T][n-tile][lane]
template <int J>
constexpr int XCH = Cfg<J>::SLABS * Cfg<J>::WS * 2 * Cfg<J>::NT * 32;
// floats of a streamed buffer: the two slices (K3: and m, 1/l, delta)
template <int J, bool DKU>
constexpr int BUF = 2 * Cfg<J>::TN * Cfg<J>::RS + (DKU ? 3 * Cfg<J>::TN : 0);
// shared bytes with NB buffers: the resident slices, the streamed ones,
// the partials, the hand-over of dS (and A)
template <int J, bool DKU>
__host__ __device__ constexpr size_t bytes_with(int nb) {
  using C = Cfg<J>;
  return sizeof(float) * (2 * C::TM * C::RS + nb * BUF<J, DKU>) +
         sizeof(float4) * (XCH<J> + C::SLABS * (DKU ? 2 : 1) * C::NT * 32);
}
// streamed buffers: three where they fit (a tile's copies then start two
// tiles ahead), else two
template <int J, bool DKU>
__host__ __device__ constexpr int buffers() { return bytes_with<J, DKU>(3) <= 232448 ? 3 : 2; }
template <int J, bool DKU>
__host__ __device__ constexpr size_t bytes() { return bytes_with<J, DKU>(buffers<J, DKU>()); }

// Rows [row0, row0 + ROWS) of columns [c0, c0 + kc) of a row-major (rows,
// d) array into a ROWS x RS tile by cp.async (the caller commits): zeros
// past d and past `rows`; kc, a multiple of 8 up to RS - 4, is the slice's
// columns rounded up to the k-steps. vec16: 16-byte copies (the base on 16
// bytes and d a multiple of 4; c0 is a multiple of 128).
template <int RS, int ROWS>
__device__ __forceinline__ void stage_slice(float* dst, const float* __restrict__ src, int d, int c0, int kc,
                                            int row0, int rows, bool vec16) {
  constexpr int SL = RS - 4;
  if (vec16) {
    for (int i = threadIdx.x; i < ROWS * SL / 4; i += cluster::THREADS) {
      const int r = i / (SL / 4);
      const int c = (i % (SL / 4)) * 4;
      if (c >= kc) continue;
      const bool in = row0 + r < rows && c0 + c < d;
      cp_async16(dst + r * RS + c, in ? src + static_cast<size_t>(row0 + r) * d + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * SL; i += cluster::THREADS) {
      const int r = i / SL;
      const int c = i % SL;
      if (c >= kc) continue;
      const bool in = row0 + r < rows && c0 + c < d;
      cp_async4(dst + r * RS + c, in ? src + static_cast<size_t>(row0 + r) * d + c0 + c : src, in);
    }
  }
}

// The columns of a side of width d in rank r's slice of sl.
__device__ __forceinline__ int slice_cols(int d, int r, int sl) { return max(0, min(sl, d - r * sl)); }

// K2 (DKU false): res0 = q (n, d_in) and res1 = g (n, d_out) resident,
// str0 = K (M, d_in) and str1 = U (M, d_out) streamed; stats m, l, delta
// of the resident tokens; out0 = dq_part (splits, n, d_in).
// K3 (DKU true): res0 = K, res1 = U resident, str0 = q and str1 = g
// streamed; stats m, 1/l, delta of the streamed tokens; out0 = dk_part
// (chunks, M, d_in), out1 = du_part (chunks, M, d_out).
// Grid: (resident tiles of TM, splits or chunks of `per` streamed tiles,
// ranks). vec16 bits: res0, res1, str0, str1.
template <int J, bool DKU>
__global__ void __launch_bounds__(cluster::THREADS, 1)
stream_bwd_cluster_kernel(const float* __restrict__ res0p, const float* __restrict__ res1p,
                          const float* __restrict__ str0p, const float* __restrict__ str1p,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta, float* __restrict__ out0, float* __restrict__ out1,
                          int n_res, int n_str, int d_in, int d_out, int per, float beta, unsigned vec16) {
  using C = Cfg<J>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, WS = C::WS, SL = C::SL, RS = C::RS, PART = C::PART;
  constexpr int NB = buffers<J, DKU>();
  constexpr int CT = PART / 8;     // a warp's output n-tiles
  constexpr int HO = DKU ? 2 : 1;  // hand-over arrays: dS (and A)
  constexpr int BF = BUF<J, DKU>;
  extern __shared__ float4 smem4[];
  float* res0 = reinterpret_cast<float*>(smem4);  // the resident slices: d_in's side
  float* res1 = res0 + TM * RS;                    // and d_out's
  float* str = res1 + TM * RS;                     // buffer u at str + u * BF: the streamed slices (and stats)
  float4* xch = reinterpret_cast<float4*>(str + NB * BF);  // [slab][part][sc, dp][n-tile][lane]
  float4* hand = xch + XCH<J>;                              // [slab][dS, A][n-tile][lane]

  const int rank = cluster_rank(), ranks = cluster_ranks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / WS, part = warp % WS;
  const int m0 = 16 * slab;
  const int slab_lo = blockIdx.x * TM + m0;
  const int first = blockIdx.y * per;
  const int last = min((n_str + TN - 1) / TN, first + per) - 1;
  const int c0 = rank * SL;  // the block's slice of each side: columns c0 .. c0 + cols
  const int cols0 = slice_cols(d_in, rank, SL), cols1 = slice_cols(d_out, rank, SL);
  const int kc0 = (cols0 + 7) & ~7, kc1 = (cols1 + 7) & ~7;  // rounded up to the k-steps
  const int pc = PART * part;                                 // the warp's part of each slice
  const bool mine0 = pc < cols0, mine1 = pc < cols1;
  const bool live = slab_lo < n_res;      // a slab past the resident rows skips every tile, in every rank alike
  const bool outs = DKU ? mine0 || mine1 : mine0;  // the warp has output columns
  const int fin = part * ranks + rank;    // the warp finishes n-tile `fin` of its slab if fin < NT

  auto stage_stream = [&](int it) {
    if (it <= last) {
      float* y = str + (it % NB) * BF;
      stage_slice<RS, TN>(y, str0p, d_in, c0, kc0, it * TN, n_str, vec16 >> 2 & 1u);
      stage_slice<RS, TN>(y + TN * RS, str1p, d_out, c0, kc1, it * TN, n_str, vec16 >> 3 & 1u);
      if constexpr (DKU) {
        float* st = y + 2 * TN * RS;  // m, 1/l, delta of the tile's tokens
        for (int i = threadIdx.x; i < 3 * TN; i += cluster::THREADS) {
          const int r = it * TN + i % TN;
          const bool in = r < n_str;
          const float* src = i < TN ? m_in : i < 2 * TN ? l_in : delta;
          cp_async4(st + i, in ? src + r : src, in);
        }
      }
    }
    cp_async_commit();
  };
  stage_slice<RS, TM>(res0, res0p, d_in, c0, kc0, blockIdx.x * TM, n_res, vec16 & 1u);
  stage_slice<RS, TM>(res1, res1p, d_out, c0, kc1, blockIdx.x * TM, n_res, vec16 >> 1 & 1u);
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_stream(first + i);  // the resident slices go with the first

  // K2: m, 1/l and delta of the slab's rows gq and gq + 8
  float m_r[2] = {0.f, 0.f}, il_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKU) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = slab_lo + gq + 8 * e;
      if (row < n_res) m_r[e] = m_in[row], il_r[e] = 1.f / l_in[row], dl_r[e] = delta[row];
    }
  }

  float acc0[CT][4], acc1[DKU ? CT : 1][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[c][e] = acc1[DKU ? c : 0][e] = 0.f;
  float4* xw = xch + (slab * WS + part) * 2 * NT * 32 + lane;  // the warp's partials
  const float4* xs = xch + slab * WS * 2 * NT * 32 + lane;     // the slab's, part 0

  // ---- the warp's partial scores and g U^T of tile it over its part of
  // each side's slice, in fresh fragments
  float sc[NT][4], dp[NT][4];
  auto partials = [&](int it) {
    const float* y0 = str + (it % NB) * BF;
    const float* y1 = y0 + TN * RS;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    if (!live) return;
    // both products in one walk over the columns where both sides have
    // them (eight chains of mma in flight), then the wider side's alone
    const int end0 = min(pc + PART, kc0), end1 = min(pc + PART, kc1);
    const int both = max(pc, min(end0, end1));
#pragma unroll 2
    for (int kk = pc; kk < both; kk += 8) {
      const FragA xa = load_a<RS, true>(res0 + m0 * RS + kk, gq, tq);
      const FragA wa = load_a<RS, true>(res1 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1, c0b, c1b;
        load_b_rows2<RS, true>(b0, b1, y0 + 8 * j * RS + kk, gq, tq);
        load_b_rows2<RS, true>(c0b, c1b, y1 + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], xa, b0);
        mma3(dp[j], wa, c0b);
        mma3(sc[j + 1], xa, b1);
        mma3(dp[j + 1], wa, c1b);
      }
    }
    for (int kk = both; kk < end0; kk += 8) {
      const FragA xa = load_a<RS, true>(res0 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<RS, true>(b0, b1, y0 + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], xa, b0);
        mma3(sc[j + 1], xa, b1);
      }
    }
    for (int kk = both; kk < end1; kk += 8) {
      const FragA wa = load_a<RS, true>(res1 + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<RS, true>(b0, b1, y1 + 8 * j * RS + kk, gq, tq);
        mma3(dp[j], wa, b0);
        mma3(dp[j + 1], wa, b1);
      }
    }
  };

  // ---- reduce-scatter of tile it: n-tile j = fin of the slab, each
  // rank's parts added in order, the ranks in rank order; then A and dS,
  // stored in A-fragment order into every rank's hand-over
  auto finish = [&](int it) {
    if (!(live && fin < NT)) return;
    const int j = fin;
    const int n_lo = it * TN;
    const float* st = str + (it % NB) * BF + 2 * TN * RS;
    constexpr int RG = DKU ? (J == 4 ? 1 : 2) : 8 / WS;  // ranks whose partials are loaded at once (K3: registers)
    float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), td = ts;
    for (int r0 = 0; r0 < ranks; r0 += RG) {
      float4 ps[RG][WS], pd[RG][WS];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int r = r0 + rr;
        if (r >= ranks) continue;
        const int n0 = slice_cols(d_in, r, SL), n1 = slice_cols(d_out, r, SL);
#pragma unroll
        for (int p = 0; p < WS; ++p) {
          if (PART * p < n0) ps[rr][p] = ld_cluster(xs + (2 * p * NT + j) * 32, r);
          if (PART * p < n1) pd[rr][p] = ld_cluster(xs + ((2 * p + 1) * NT + j) * 32, r);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int r = r0 + rr;
        if (r >= ranks) continue;
        const int n0 = slice_cols(d_in, r, SL), n1 = slice_cols(d_out, r, SL);
#pragma unroll
        for (int p = 1; p < WS; ++p) {
          if (PART * p < n0) add4(ps[rr][0], ps[rr][p]);
          if (PART * p < n1) add4(pd[rr][0], pd[rr][p]);
        }
        if (r == 0) {  // rank 0 holds columns of both sides
          ts = ps[rr][0], td = pd[rr][0];
        } else {
          if (n0 > 0) add4(ts, ps[rr][0]);
          if (n1 > 0) add4(td, pd[rr][0]);
        }
      }
    }
    float fs[4] = {ts.x, ts.y, ts.z, ts.w}, fd[4] = {td.x, td.y, td.z, td.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = slab_lo + gq + 8 * (e >> 1);
      const int col = 8 * j + 2 * tq + (e & 1);  // the streamed row in the tile
      float a;
      if constexpr (DKU) {
        a = row < n_res && n_lo + col < n_str ? __expf(fs[e] * beta - st[col]) * st[TN + col] : 0.f;
        fd[e] = a * (fd[e] - st[2 * TN + col]) * beta;
      } else {
        a = row < n_res && n_lo + col < n_str ? __expf(fs[e] * beta - m_r[e >> 1]) * il_r[e >> 1] : 0.f;
        fd[e] = a * (fd[e] - dl_r[e >> 1]) * beta;
      }
      fs[e] = a;
    }
    float4* hw = hand + slab * HO * NT * 32 + lane;
    const float4 vd = make_float4(fd[0], fd[2], fd[1], fd[3]), va = make_float4(fs[0], fs[2], fs[1], fs[3]);
    for (int r = 0; r < ranks; ++r) {
      st_cluster(hw + j * 32, r, vd);
      if constexpr (DKU) st_cluster(hw + (NT + j) * 32, r, va);
    }
  };

  // ---- the slab's dS (and A) of tile it, as the finishers stored them
  float4 dsj[NT], aj[DKU ? NT : 1];
  auto gather = [&](int it) {
    if (!(live && outs)) return;
    const float4* hr = hand + slab * HO * NT * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      dsj[j] = hr[j * 32];
      if constexpr (DKU) aj[j] = hr[(NT + j) * 32];
    }
  };

  // ---- the outputs of tile it over the warp's PART columns: dq += dS K
  // (K2), dK += dS^T q and dU += A^T g (K3), over the tile's streamed rows
  // 8j .. 8j + 7 in order, in fresh fragments added to the running sums
  // after the tile
  auto outputs = [&](int it) {
    if (!(live && outs)) return;
    const int n_lo = it * TN;
    const float* y0 = str + (it % NB) * BF;
    const float* y1 = y0 + TN * RS;
    // K3 in two groups of columns, each with its fresh fragments (the sums
    // per column are the same; fewer registers are live)
    constexpr int CH = DKU ? 2 : 1, CG = CT / CH;
#pragma unroll
    for (int hf = 0; hf < CH; ++hf) {
      float o0[CG][4], o1[DKU ? CG : 1][4];
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o0[c][e] = o1[DKU ? c : 0][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n_lo + 8 * j >= n_str) continue;  // dS = A = 0 past the streamed rows
        const FragA dsa = split_a<true>(dsj[j].x, dsj[j].y, dsj[j].z, dsj[j].w);
        if constexpr (DKU) {
          const FragA afa = split_a<true>(aj[j].x, aj[j].y, aj[j].z, aj[j].w);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const int col = pc + 8 * (hf * CG + c);
            if (col < kc1) mma3(o1[c], afa, load_b_cols<RS, true>(y1 + 8 * j * RS + col, gq, tq));  // dU, g
            if (col < kc0) mma3(o0[c], dsa, load_b_cols<RS, true>(y0 + 8 * j * RS + col, gq, tq));  // dK, q
          }
        } else {
#pragma unroll
          for (int c = 0; c < CG; ++c)
            if (pc + 8 * c < kc0) mma3(o0[c], dsa, load_b_cols<RS, true>(y0 + 8 * j * RS + pc + 8 * c, gq, tq));
        }
      }
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc0[hf * CG + c][e] += o0[c][e];
          if constexpr (DKU) acc1[hf * CG + c][e] += o1[c][e];
        }
    }
  };

  // ---- the walk, one tile behind in the outputs: while a cluster barrier
  // is pending, the warps run the previous tile's outputs (barrier 0) or the
  // next tile's partials (barrier 1). A warp reads tile it - 1's hand-over
  // before it arrives at tile it's barrier 0, after which it is rewritten.
  if constexpr (NB == 3) cp_async_wait_prior();
  else cp_async_wait_all();
  __syncthreads();  // the resident slices and tile `first` have landed
  partials(first);
  for (int it = first; it <= last; ++it) {
    if (live) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        xw[j * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
        xw[(NT + j) * 32] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
      }
    }
    if (it > first) gather(it - 1);
    cluster_arrive();  // barrier 0: tile it's partials are in place; tile it - 1's hand-over is read
    if (it > first) outputs(it - 1);
    if constexpr (NB == 3) cp_async_wait_all();  // tile it + 1, staged a tile ago
    __syncthreads();  // every warp is done with tile it - 1's buffer (NB 3: tile it + 1 has landed)
    stage_stream(it - 1 + NB);
    cluster_wait();
    finish(it);
    cluster_arrive();  // barrier 1: tile it's A and dS are in every rank; tile it's partials are read
    if (it < last) {
      if constexpr (NB == 2) {
        cp_async_wait_all();
        __syncthreads();  // tile it + 1 has landed
      }
      partials(it + 1);
    }
    cluster_wait();
  }
  gather(last);
  outputs(last);
  cluster_arrive();  // no block leaves while another may still read its shared memory
  cluster_wait();

  // ---- this split's (chunk's) partial rows, the warp's columns below each width
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= n_res) continue;
    const size_t at = static_cast<size_t>(blockIdx.y) * n_res + row;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = pc + 8 * c + 2 * tq + hh;
        if (col < cols0) out0[at * d_in + c0 + col] = acc0[c][2 * e + hh];
        if constexpr (DKU)
          if (col < cols1) out1[at * d_out + c0 + col] = acc1[c][2 * e + hh];
      }
  }
}

// The launch of the cluster kernel of `j` chunks a slice over `grid`
// (grid.z: the blocks of a cluster).
template <int J, bool DKU>
cudaError_t launch_cluster(dim3 grid, const float* res0, const float* res1, const float* str0, const float* str1,
                           const float* m, const float* l, const float* delta, float* out0, float* out1, int n_res,
                           int n_str, int d_in, int d_out, int per, float beta, unsigned vec16, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  auto kernel = stream_bwd_cluster_kernel<J, DKU>;
  cudaError_t err = cluster_config(kernel, bytes<J, DKU>(), grid, config, attr, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, res0, res1, str0, str1, m, l, delta, out0, out1, n_res, n_str, d_in,
                            d_out, per, beta, vec16);
}

// f(std::integral_constant<int, J>{}) for the plan's J (1, 2 or 4).
template <typename F>
auto with_chunks(int j, F&& f) {
  switch (j) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

// The resident rows tm and the streamed tile tn of the J instance.
inline void tile_rows(int j, int& tm, int& tn) {
  with_chunks(j, [&](auto jj) {
    tm = Cfg<decltype(jj)::value>::TM;
    tn = Cfg<decltype(jj)::value>::TN;
  });
}

// The clusters of the J instance the card holds at once (0 on an error).
template <bool DKU>
int concurrent_clusters(int j, int ranks) {
  return with_chunks(j, [&](auto jj) {
    constexpr int J = decltype(jj)::value;
    int clusters = 0;
    return active_clusters(stream_bwd_cluster_kernel<J, DKU>, bytes<J, DKU>(), ranks, clusters) == cudaSuccess
               ? clusters
               : 0;
  });
}

// The cluster kernel's build for (d_in, d_out): tf32x3::kernel_attributes
// into out[0..6] (attributes) or cluster_attributes into out[0..2].
template <bool DKU>
cudaError_t cluster_build(int d_in, int d_out, bool attributes, int* out) {
  int j, ranks;
  if (!plan(d_in, d_out, j, ranks)) return cudaErrorInvalidValue;
  return with_chunks(j, [&](auto jj) {
    constexpr int J = decltype(jj)::value;
    using C = Cfg<J>;
    auto kernel = stream_bwd_cluster_kernel<J, DKU>;
    return attributes ? tf32x3::kernel_attributes(kernel, cluster::THREADS, bytes<J, DKU>(), C::TM, C::TN, out)
                      : cluster_attributes(kernel, bytes<J, DKU>(), C::SL, ranks, out);
  });
}

// ---- the wide forward on the cluster: K1 (hopfield_stream_fwd.cu) and
// K4's three stages (hopfield_bottleneck_fused.cu)

// The wide forward: out = softmax(beta q K^T) U for TM token rows of the
// built q (n, d_in), with K5's cluster forward schedule
// (causal_attention_fwd.cu) and no mask but the patterns past M. The grid
// is (token tiles, 1, ranks); each cluster walks every pattern tile. Rank r keeps
// columns [r SL, r SL + SL) of q in shared memory for the whole walk and
// streams those columns of each tile's K and U; a narrower side leaves
// the higher ranks' slices empty, and a slice is zero-padded in shared
// memory to the next multiple of 8. Per tile each warp (a 16-row slab, a
// part of PART columns) sums its partial scores in a fresh sum, the
// slab's parts add in part order (the rank sum), and after one cluster
// barrier every warp with output columns reads the sums of every rank
// with columns of q over DSMEM and adds them in rank order: every rank
// and warp holds the same scores, m and l bit for bit (K2's and K3's
// clusters sum the scores in this order too). Then the online softmax,
// the denominator a compensated sum, and P U over the warp's PART columns
// of the U slice, one tile behind. Rows past n compute nothing and write
// nothing, but meet every barrier. Every product is three-pass TF32 with
// the small part truncated; no float atomics. The epilogue is MODE's
// (hopfield_wide.cuh; rank 0 writes m and l). vec16 bits: q, K, U.
//
// What bounds it on an H100: latency, as K5's forward. At 512 -> 512 a
// tile is 192 mma.sync a warp, under a microsecond at the TF32 rate, but
// takes about 6 us: the 8 warps of an SM wait in step on the cluster
// barrier, the DSMEM loads of the rank sums and the softmax's exps and
// shuffles (255 registers and no spill at J 1, one block an SM, 201,728
// shared bytes; PERF.md). At N 4,096 the 64 clusters of 4 blocks run in
// three waves of 30. The pattern axis is not split: a split merged by
// log-sum-exp ran 0.7% slower at 512 -> 512, N 4,096, and only fewer
// token tiles than a wave (N below about 1,900 at 512 -> 512), which no
// config gives, would leave SMs idle.
template <int J, int MODE>
__global__ void __launch_bounds__(cluster::THREADS, 1)
stream_fwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                          const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ m_out,
                          float* __restrict__ l_out, float* __restrict__ zn_out, int n, int m_patterns, int d_in,
                          int d_out, float beta, float levels, unsigned vec16) {
  using C = Cfg<J>;
  using F = Fwd<J>;
  constexpr int TM = C::TM, TN = C::TN, NT = C::NT, WS = C::WS, SL = C::SL, RS = C::RS, PART = C::PART;
  constexpr int NB = fwd_buffers<J>();  // streamed buffers
  constexpr int CT = PART / 8;          // a warp's output n-tiles
  constexpr int RG = F::RG;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);                // the resident q slice
  float* str = q_s + TM * RS;                                   // buffer u at str + u * BUF: K, then U
  float4* xch = reinterpret_cast<float4*>(str + NB * F::BUF);  // the warps' partial scores
  float4* sums = xch + F::XCH;                                  // [tile & 1][slab][n-tile][lane]

  const int rank = cluster_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int slab = warp / WS, part = warp % WS;
  const int m0 = 16 * slab;
  const int row0 = blockIdx.x * TM;
  const int slab_lo = row0 + m0;
  const int last = (m_patterns + TN - 1) / TN - 1;
  const int c0 = rank * SL;  // the block's slice of each side: columns c0 .. c0 + cols
  const int cols_in = slice_cols(d_in, rank, SL), cols_out = slice_cols(d_out, rank, SL);
  const int kc_in = (cols_in + 7) & ~7, kc_out = (cols_out + 7) & ~7;  // rounded up to the k-steps
  const int ranks_in = (d_in + SL - 1) / SL;                          // the ranks whose sums make the scores
  const int parts = (cols_in + PART - 1) / PART;                      // the slab's warps with columns of q
  const int pc = PART * part;                                         // the warp's part of each slice
  const bool mine_in = part < parts, mine_out = pc < cols_out;
  // a slab past the token rows skips every tile, in every rank alike; its
  // warps still meet every cluster barrier
  const bool live = slab_lo < n;
  const bool own = live && mine_out;  // the warp needs the whole scores
  float4* xs = xch + slab * WS * NT * 32 + lane;  // the slab's partials, [part][n-tile]

  // tile `it` into buffer it % NB (nothing past the last); one commit group either way
  auto stage_ku = [&](int it) {
    if (it <= last) {
      float* y = str + (it % NB) * F::BUF;
      stage_slice<RS, TN>(y, K, d_in, c0, kc_in, it * TN, m_patterns, vec16 >> 1 & 1u);
      stage_slice<RS, TN>(y + TN * RS, U, d_out, c0, kc_out, it * TN, m_patterns, vec16 >> 2 & 1u);
    }
    cp_async_commit();
  };
  stage_slice<RS, TM>(q_s, q, d_in, c0, kc_in, row0, n, vec16 & 1u);
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) stage_ku(i);  // the q slice goes with the first

  // rows gq and gq + 8 of the slab: the running max, the lane's part of
  // the denominator and its compensation, the last tile's rescale, the
  // output over the warp's columns c0 + pc + 8c + 2tq and + 1
  float m_r[2] = {MASKED, MASKED}, l_r[2] = {0.f, 0.f}, l_lo[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float sc[NT][4];  // the warp's partial scores of the next tile
  float pr[NT][4];  // the slab's whole scores of a tile, then its P

  // ---- the warp's partial scores of tile it over its part of the q
  // slice, in a fresh sum
  auto partials = [&](int it) {
    const float* y = str + (it % NB) * F::BUF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if (!(live && mine_in)) return;
    auto step = [&](int kk) {
      const FragA qa = load_a<RS, true>(q_s + m0 * RS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<RS, true>(b0, b1, y + 8 * j * RS + kk, gq, tq);
        mma3(sc[j], qa, b0);
        mma3(sc[j + 1], qa, b1);
      }
    };
    if (pc + PART <= kc_in) {  // a whole part: a loop of known length
#pragma unroll 2
      for (int kk = 0; kk < PART; kk += 8) step(pc + kk);
    } else {
      for (int kk = pc; kk < kc_in; kk += 8) step(kk);
    }
  };

  // ---- the slab's rank sum of tile it: the parts' partials added in part
  // order, n-tile j by the slab's warp j % WS, into sums buffer it & 1
  // (nothing where the slice holds no column of q)
  auto rank_sum = [&](int it) {
    if (!live || parts == 0) return;
    if (mine_in) {
#pragma unroll
      for (int j = 0; j < NT; ++j) xs[(part * NT + j) * 32] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    named_barrier(1 + slab, 32 * WS);
    float4* sw = sums + ((it & 1) * C::SLABS + slab) * NT * 32 + lane;
    for (int j = part; j < NT; j += WS) {
      float4 a = xs[j * 32];
      for (int p = 1; p < parts; ++p) add4(a, xs[(p * NT + j) * 32]);
      sw[j * 32] = a;
    }
  };

  // ---- the slab's whole scores of tile it: the sums of the ranks with
  // columns of q, read over DSMEM RG ranks at a time and added in rank
  // order; then the online softmax turns them into P. The first group is
  // loaded before the next tile's partials, which hide its latency.
  float4 ps[RG][NT];
  auto load_group = [&](int it, int r0) {
    const float4* sr = sums + ((it & 1) * C::SLABS + slab) * NT * 32 + lane;
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (r0 + rr < ranks_in) ps[rr][j] = ld_cluster(sr + j * 32, r0 + rr);
  };
  auto softmax = [&](int it) {
    float4 t[NT];
    for (int r0 = 0; r0 < ranks_in; r0 += RG) {
      if (r0 > 0) load_group(it, r0);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (r0 + rr == 0) {
            t[j] = ps[rr][j];
          } else if (r0 + rr < ranks_in) {
            add4(t[j], ps[rr][j]);
          }
        }
    }
    const int p_lo = it * TN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float v[4] = {t[j].x, t[j].y, t[j].z, t[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = p_lo + 8 * j + 2 * tq + (e & 1) < m_patterns ? v[e] * beta : MASKED;
        pr[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = __expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(pr[j][e] - mx[e >> 1]);
        pr[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the compensated sum of hopfield_wide.cuh
      const float a = __fmul_rn(l_r[r], alpha[r]);
      const float b = __fadd_rn(__fmul_rn(l_lo[r], alpha[r]), rsum[r]);
      const float sum = __fadd_rn(a, b);
      const float bb = __fsub_rn(sum, a);
      l_lo[r] = __fadd_rn(__fsub_rn(a, __fsub_rn(sum, bb)), __fsub_rn(b, bb));
      l_r[r] = sum;
    }
  };

  // ---- P U of tile it over the warp's PART columns of the U slice, the
  // tile's patterns 8j .. 8j + 7 in order, in fresh fragments; then
  // out = alpha out + P U
  auto pu = [&](int it) {
    if (!own) return;
    const int p_lo = it * TN;
    const float* y = str + (it % NB) * F::BUF + TN * RS;
    float o[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
    const int ct = min(CT, (kc_out - pc) / 8);  // the warp's n-tiles below d_out
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (p_lo + 8 * j >= m_patterns) continue;  // P = 0 past the patterns
      const FragA pa = split_a<true>(pr[j][0], pr[j][2], pr[j][1], pr[j][3]);
      if (ct == CT) {  // a whole part
#pragma unroll
        for (int c = 0; c < CT; ++c) mma3(o[c], pa, load_b_cols<RS, true>(y + 8 * j * RS + pc + 8 * c, gq, tq));
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          if (c < ct) mma3(o[c], pa, load_b_cols<RS, true>(y + 8 * j * RS + pc + 8 * c, gq, tq));
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * alpha[e >> 1] + o[c][e];
  };

  // ---- the walk, one tile behind in P U (K5's forward schedule): while
  // tile it's cluster barrier is pending, the warps run tile it - 1's P U;
  // after it, tile it + 1's partials run while tile it's rank sums are in
  // flight. With four buffers the cluster barrier also orders the copies.
  if constexpr (NB == 4) cp_async_wait_prior();
  else cp_async_wait_all();
  __syncthreads();  // the q slice and tile 0 have landed
  partials(0);
  for (int it = 0; it <= last; ++it) {
    rank_sum(it);
    if constexpr (NB == 4) cp_async_wait_all();  // this thread's copies of tile it + 1
    cluster_arrive();  // tile it's rank sums are in place; tile it - 1's are read
    if (it > 0) pu(it - 1);
    if constexpr (NB == 2) {
      __syncthreads();  // every warp is done with tile it - 1's buffer
      stage_ku(it + 1);
    }
    cluster_wait();
    if constexpr (NB == 4) stage_ku(it + 2);
    if (own) load_group(it, 0);
    if (it < last) {
      if constexpr (NB == 2) {
        cp_async_wait_all();
        __syncthreads();  // tile it + 1 has landed
      }
      partials(it + 1);
    }
    if (own) softmax(it);
  }
  pu(last);
  cluster_arrive();  // no block leaves while another may still read its shared memory
  cluster_wait();

  if (!own) return;
  // ---- the denominators over the quad; out = acc / l at the warp's
  // columns below d_out, through MODE's epilogue; m and l from rank 0's
  // first warp of the slab
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += l_lo[r];
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = slab_lo + gq + 8 * e;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = pc + 8 * c + 2 * tq + hh;
        if (col >= cols_out) continue;
        const size_t at = static_cast<size_t>(row) * d_out + c0 + col;
        const float v = acc[c][2 * e + hh] / l_r[e];
        if constexpr (MODE == PLAIN) {
          out[at] = v;
        } else if constexpr (MODE == SHIFT) {
          out[at] = v + bias[c0 + col];
        } else {
          const float zq = rintf(1.f / (1.f + expf(-(v + bias[c0 + col]))) * levels);
          out[at] = zq;
          zn_out[at] = zq / levels;
        }
      }
    if (MODE == PLAIN && rank == 0 && part == 0 && tq == 0) {
      m_out[row] = m_r[e];
      l_out[row] = l_r[e];
    }
  }
}

// The wide forward on its cluster over the built q (n, d_in), where
// plan takes the widths (hopfield_narrow.cuh's launch_fwd routes the
// others); a refused launch returns its error.
template <int MODE>
cudaError_t launch_fwd_cluster(const float* q, const float* K, const float* U, const float* bias, float* out,
                               float* m, float* l, float* zn, int n, int m_patterns, int d_in, int d_out, float beta,
                               float levels, cudaStream_t stream) {
  int j, ranks;
  if (!plan(d_in, d_out, j, ranks)) return cudaErrorInvalidValue;
  return with_chunks(j, [&](auto jj) {
    constexpr int J = decltype(jj)::value;
    using C = Cfg<J>;
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    auto kernel = stream_fwd_cluster_kernel<J, MODE>;
    cudaError_t err =
        cluster_config(kernel, fwd_bytes<J>(), dim3((n + C::TM - 1) / C::TM, 1, ranks), config, attr, stream);
    if (err != cudaSuccess) return err;
    const unsigned vec16 = hopfield_stream::vec16_ok(q, d_in) | hopfield_stream::vec16_ok(K, d_in) << 1 |
                           hopfield_stream::vec16_ok(U, d_out) << 2;
    err = cudaLaunchKernelEx(&config, kernel, q, K, U, bias, out, m, l, zn, n, m_patterns, d_in, d_out, beta,
                             levels, vec16);
    return err == cudaSuccess ? cudaGetLastError() : err;
  });
}

// The forward's cluster kernel (MODE's instance) for (d_in, d_out):
// tf32x3::kernel_attributes into out[0..6] (attributes) or
// cluster_attributes into out[0..2]; cudaErrorInvalidValue where plan
// refuses the widths.
template <int MODE>
cudaError_t fwd_cluster_build(int d_in, int d_out, bool attributes, int* out) {
  int j, ranks;
  if (!plan(d_in, d_out, j, ranks)) return cudaErrorInvalidValue;
  return with_chunks(j, [&](auto jj) {
    constexpr int J = decltype(jj)::value;
    using C = Cfg<J>;
    auto kernel = stream_fwd_cluster_kernel<J, MODE>;
    return attributes ? tf32x3::kernel_attributes(kernel, cluster::THREADS, fwd_bytes<J>(), C::TM, C::TN, out)
                      : cluster_attributes(kernel, fwd_bytes<J>(), C::SL, ranks, out);
  });
}

}  // namespace hopfield_cluster
