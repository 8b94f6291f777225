// Streaming modern-Hopfield lookup, backward for the pattern tables (K3),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stream_bwd_dku_kernel` of
// hopvae_tpu/ops/hopfield_pallas.py, launched in `_attn_ln_stream_bwd`.
// From the same inputs as the token-side kernel (x, the folded tables K
// and U, the LayerNorm's s and t, the cotangent g, the forward's row
// stats m and l, and delta = rowsum(g * out)) it rebuilds the attention
// tiles and sums, over all tokens,
//
//     dU = A^T g                                  (M, d_out)
//     dK = dS^T q,   dS = A * (g U^T - delta) * beta      (M, d_in)
//
// with A = exp(beta * q K^T - m) / l and q = LN(x) * s + t.
//
// What bounds it on an H100: the tensor cores. It does four products,
// 2*N*M*(2*d_in + 2*d_out) FLOPs (K q^T, U g^T, A^T g, dS^T q), each as
// mma.sync m16n8k8 on TF32 operands in three passes (mma_tf32.cuh): 0.94
// ms at N = 73,984, M = 4096, d_in = d_out = 64 at 495 / 3 TFLOP/s,
// against N*M exps and about 40 MB of memory traffic. Three passes for
// the reason K2 gives (hopfield_stream_bwd_dx.cu).
//
// Design (after K5-dkv, causal_attention_bwd.cu):
// - Widths: any d_in, d_out from 1 to 256, padded with zeros in shared
//   memory to the instance built for it (hopfield_stream.cuh, with_widths:
//   8 to 128 each side; 256 with 8 or 256); the LayerNorm and beta use the
//   real width.
// - A first pass builds q (the state LayerNorm in double over the real
//   width, rounded once: hopfield_stream.cuh, as K1 and K2 build it) and
//   1/l once for every token, into the scratch. Built inside the main
//   kernel, each token's LayerNorm ran once for every block of patterns
//   that reads it: 64 times at M = 4096.
// - One block of 4 warps owns 64 patterns (TM) of K and U, a warp a
//   16-pattern slab, and walks a chunk of the token axis in tiles of 32
//   (TN; 16 where d_in' + d_out' pass 256, for shared memory), whose q, g,
//   m, 1/l and delta arrive by double-buffered cp.async
//   (16-byte copies where the base and width allow). Rows past N and
//   patterns past M are masked to A = 0 here; the caller pads nothing.
// - K q^T and U g^T come out as C fragments whose rows are patterns: A^T
//   and dS^T are computed on them in registers and become, through the
//   permuted k, the A operands of dU += A^T g and dK += dS^T q, with the
//   g and q tiles as B operands.
// - dU and dK are summed over each token tile one n-tile at a time in a
//   fresh fragment, added to the running sums after the tile (the tensor
//   cores' sums truncate; see K2).
// - Past a width of 128 a warp's dK and dU would take up to 256
//   accumulators: two blocks share the patterns, each summing half of the
//   n-tiles of dK and half of those of dU and each computing the scores in
//   full.
// - The TPU runs one program per pattern block and sums over the token
//   blocks in its sequential grid. 64 pattern tiles (M = 4096) or 8
//   (M = 512) would leave most of the 132 SMs idle, so the token axis is
//   split into chunks, as many as fill about 8 waves of the blocks the
//   card runs at once for the instance (a last wave that is mostly empty
//   idles the card): each block writes its chunk's partial dK and dU,
//   shaped (chunks, M, d), and a last pass sums the chunks in order. No
//   float atomics: the result has the same bits in every run.
//
//   Shared bytes: 4 (64 + 2 TN) (d_in' + d_out' + 8) + 24 TN for padded
//   widths d_in', d_out' (K, U, two buffers of q, g and the row stats):
//   70,400 at 64 -> 64, 200,064 at 256 -> 256. Registers and blocks an SM per width are in PERF.md, from
//   hopfield_stream_bwd_dku_attributes on the card.
// - Past 256 on either side the first pass builds q and 1/l at any width
//   (hopfield_wide.cuh). Up to 8192 on the wider side, with d_in and d_out
//   past 128, dK and dU run on a thread-block cluster (hopfield_cluster.cuh): the
//   depth split across the blocks of a cluster, each tile's scores
//   computed once, every output column summed by the block whose slice
//   holds it (at 512 -> 512, N 4,096, M 512 on an H100: 0.51 ms against
//   the window kernel's 1.09; PERF.md); the chunks of the token axis plan
//   from the clusters the card holds at once and each cluster's fixed
//   cost (cluster_chunks). Where d_in passes 256 with d_out up to 8, or
//   64 at a d_in up to 320, the whole window (stream_bwd_dku_whole_kernel,
//   hopfield_narrow.cuh): one block's 64 patterns by all of d_in, each
//   score computed once in registers, dK's and dU's chunks of the token
//   axis the same (whole_chunks; at (384, 3) on an H100: N 4,096, 0.178
//   ms against the cluster's 0.347 and the split scores' 0.237; N 73,984,
//   16.2 against 36.1 and 345; PERF.md). Elsewhere (d_in up to 128, d_out
//   up to 128, or past 8192) the
//   narrow-side kernel, which replaces the window kernel there (its
//   pieces in hopfield_narrow.cuh): a block owns 64 patterns and one
//   window of dK or of dU (a grid axis), the window the wider side's
//   padded to 8 up to 128, each block's output only its live n-tiles (dK
//   at d_in 3 one); per token tile the parts of K and q (and, for dK,
//   those of U and g) stream through, their columns below the widths,
//   summed part after part in fresh fragments (K2's order: the window
//   kernels', or the cluster's groups where score_order says so), then
//   the window's columns of q or g with the tile's row stats. Each window
//   block recomputes the scores: at d_in up to 128 only a K q^T of that
//   depth, so the route stays by width (at (3, 384) the cluster took
//   0.377 ms against the window kernel's 0.246). What bounds it on an H100 is latency
//   (8 warps an SM, a barrier a part); dK's blocks, which alone carry U
//   g^T, get their own chunks of the token axis, planned apart from dU's
//   by a tile's work (dku_window_plan), so that they do not set the pace.
//   Where d_in passes 128, S^T = K q^T is split
//   over the card once for all windows instead of once a window, and so is
//   P^T = U g^T (dK's windows) where d_out has more than one part: in K3's
//   own orientation (the patterns' rows resident, as the walk has them)
//   and order, so dK and dU keep the walk's bits; slab after slab of
//   pattern tiles within SPLIT_BYTES, in rounds of parts where a slab's
//   parts pass it (hopfield_narrow::slab_plan), each slab's window kernel
//   after its split. At (8320, 3), N 4,096, M 64 the parts' sums take 137
//   MB, where every window recomputed the scores; one slab in 3 rounds of
//   44 parts took 0.80 ms against 12.84 to 13.01 on an H100 (PERF.md).
//   Only where one pattern tile's sums and one part pass the cap (N past
//   87,381 with both products, 131,072 with one) do the windows compute
//   the products themselves.

#include "hopfield_cluster.cuh"
#include "hopfield_narrow.cuh"
#include "hopfield_stream.cuh"
#include "hopfield_wide.cuh"

namespace {

using namespace hopfield_stream;
using namespace tf32x3;

constexpr int TM = 64;  // patterns of a block
constexpr int THREADS = 32 * TM / 16;
constexpr int Q_ROWS = 32;  // token rows of a block of the first pass
constexpr int Q_THREADS = 4 * Q_ROWS;
constexpr int WAVES = 8;    // waves of blocks the chunks of the token axis aim to fill

template <int PI, int PO>
struct Tiles {
  static constexpr int TN = PI + PO > 256 ? 16 : 32;  // tokens of a streamed tile
  static constexpr int NT = TN / 8;
  static constexpr int PARTS = PI > 128 || PO > 128 ? 2 : 1;  // blocks that share the patterns
  static constexpr int CI = PI / 8, CO = PO / 8;              // n-tiles of dK and dU
  static constexpr int CIP = (CI + PARTS - 1) / PARTS;        // a block's n-tiles of dK (the last may hold fewer)
  static constexpr int COP = (CO + PARTS - 1) / PARTS;        // and of dU
  static constexpr int QS = PI + 4;  // K rows and q rows in shared memory
  static constexpr int GS = PO + 4;  // U rows and g rows
  static constexpr int BUF = TN * (QS + GS) + 3 * TN;  // one buffer: q, g, m, 1/l, delta
  static constexpr size_t BYTES = sizeof(float) * (TM * (QS + GS) + 2 * BUF);
};

// q = LN(x) * s + t and il = 1/l of every token: the first pass.
__global__ void __launch_bounds__(Q_THREADS)
stream_bwd_query_kernel(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ t,
                        const float* __restrict__ l_in, int n, int d_in, float* __restrict__ q,
                        float* __restrict__ il) {
  constexpr int S = MAX_WIDTH + 1;
  __shared__ float x_s[Q_ROWS * S];
  const int row0 = blockIdx.x * Q_ROWS;
  const int rows_here = min(Q_ROWS, n - row0);
  for (int i = threadIdx.x; i < Q_ROWS * d_in; i += Q_THREADS) {
    const int r = i / d_in;
    x_s[r * S + i - r * d_in] = r < rows_here ? x[static_cast<size_t>(row0) * d_in + i] : 0.f;
  }
  __syncthreads();
  layer_norm_rows<Q_ROWS, S, Q_THREADS>(x_s, d_in, s, t);
  __syncthreads();
  for (int i = threadIdx.x; i < rows_here * d_in; i += Q_THREADS) {
    const int r = i / d_in;
    q[static_cast<size_t>(row0) * d_in + i] = x_s[r * S + i - r * d_in];
  }
  if (threadIdx.x < rows_here) il[row0 + threadIdx.x] = 1.f / l_in[row0 + threadIdx.x];
}

template <int PI, int PO>
__global__ void __launch_bounds__(THREADS, 2)
stream_bwd_dku_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                      const float* __restrict__ g, const float* __restrict__ m_in, const float* __restrict__ il_in,
                      const float* __restrict__ delta, float* __restrict__ dk_part, float* __restrict__ du_part,
                      int n, int m_patterns, int d_in, int d_out, int tiles_per_chunk, float beta, unsigned vec16) {
  using C = Tiles<PI, PO>;
  constexpr int QS = C::QS, GS = C::GS, TN = C::TN, NT = C::NT, CI = C::CI, CO = C::CO, CIP = C::CIP,
                COP = C::COP;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* u_s = k_s + TM * QS;
  float* str = u_s + TM * GS;  // buffer u at str + u * BUF: q tile, g tile, then m, 1/l, delta

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // the warp's slab of patterns
  const int p0 = blockIdx.x * TM;
  const int chunk = blockIdx.y;
  const int ci0 = blockIdx.z * CIP, co0 = blockIdx.z * COP;  // the block's first n-tiles of dK and dU
  const int first = chunk * tiles_per_chunk;
  const int last = min((n + TN - 1) / TN, first + tiles_per_chunk) - 1;

  stage_async<PI, TM, THREADS>(k_s, K, d_in, p0, m_patterns, vec16 >> 2 & 1u);
  stage_async<PO, TM, THREADS>(u_s, U, d_out, p0, m_patterns, vec16 >> 3 & 1u);
  auto stage_tile = [&](int it, int u) {
    float* y = str + u * C::BUF;
    stage_async<PI, TN, THREADS>(y, q, d_in, it * TN, n, vec16 & 1u);
    stage_async<PO, TN, THREADS>(y + TN * QS, g, d_out, it * TN, n, vec16 >> 1 & 1u);
    float* st = y + TN * (QS + GS);
    for (int i = threadIdx.x; i < 3 * TN; i += THREADS) {
      const int r = it * TN + i % TN;
      const bool in = r < n;
      const float* src = i < TN ? m_in : i < 2 * TN ? il_in : delta;
      cp_async4(st + i, in ? src + r : src, in);
    }
    cp_async_commit();
  };
  stage_tile(first, 0);  // one group with K and U

  bool live_p[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) live_p[e] = p0 + m0 + gq + 8 * e < m_patterns;

  float dk[CIP][4], du[COP][4];
#pragma unroll
  for (int c = 0; c < CIP; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = 0.f;
#pragma unroll
  for (int c = 0; c < COP; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) du[c][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it < last) stage_tile(it + 1, u ^ 1);
    const float* y = str + u * C::BUF;  // q
    const float* gt = y + TN * QS;
    const float* st = gt + TN * GS;  // m, 1/l, delta of the tile's tokens
    const int tok_lo = it * TN;

    // ---- the slab's K q^T and U g^T over the tile: rows patterns, columns tokens
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PI; kk += 8) {
      const FragA a = load_a<QS>(k_s + m0 * QS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<QS>(b0, b1, y + 8 * j * QS + kk, gq, tq);
        mma3(sc[j], a, b0);
        mma3(sc[j + 1], a, b1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PO; kk += 8) {
      const FragA a = load_a<GS>(u_s + m0 * GS + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        FragB b0, b1;
        load_b_rows2<GS>(b0, b1, gt + 8 * j * GS + kk, gq, tq);
        mma3(dp[j], a, b0);
        mma3(dp[j + 1], a, b1);
      }
    }

    // ---- A^T and dS^T in place (patterns gq, gq + 8; tokens 8j + 2tq, + 1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = 8 * j + 2 * tq + (e & 1);
        const float a = live_p[e >> 1] && tok_lo + tl < n ? __expf(sc[j][e] * beta - st[tl]) * st[TN + tl] : 0.f;
        sc[j][e] = a;
        dp[j][e] = a * (dp[j][e] - st[2 * TN + tl]) * beta;
      }

    // ---- dU += A^T g, then dK += dS^T q, over the tile's tokens, one
    // n-tile at a time in a fresh fragment
    FragA fa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) fa[j] = split_a(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
#pragma unroll
    for (int c = 0; c < COP; ++c) {
      if (C::PARTS > 1 && co0 + c >= CO) break;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, fa[j], load_b_cols<GS>(gt + 8 * j * GS + 8 * (co0 + c), gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) du[c][e] += o[e];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) fa[j] = split_a(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
#pragma unroll
    for (int c = 0; c < CIP; ++c) {
      if (C::PARTS > 1 && ci0 + c >= CI) break;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, fa[j], load_b_cols<QS>(y + 8 * j * QS + 8 * (ci0 + c), gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][e] += o[e];
    }
  }

  // ---- this chunk's partial rows of dK and dU, (chunks, M, d), the
  // block's columns below the real widths
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live_p[e]) continue;
    const size_t row = static_cast<size_t>(chunk) * m_patterns + p0 + m0 + gq + 8 * e;
#pragma unroll
    for (int c = 0; c < CIP; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * (ci0 + c) + 2 * tq + h;
        if (col < d_in) dk_part[row * d_in + col] = dk[c][2 * e + h];
      }
#pragma unroll
    for (int c = 0; c < COP; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * (co0 + c) + 2 * tq + h;
        if (col < d_out) du_part[row * d_out + col] = du[c][2 * e + h];
      }
  }
}

// Chunks of the token axis: about WAVES waves of the blocks the card runs
// at once (`concurrent`), at most one a token tile; `blocks` are the
// pattern tiles times the column parts.
int chunks_for(int token_tiles, int blocks, int concurrent) {
  int chunks = WAVES * (concurrent > 0 ? concurrent : 1) / blocks;
  chunks = chunks > 1 ? chunks : 1;
  return chunks < token_tiles ? chunks : token_tiles;
}

template <int PI, int PO>
int chunks_of(int n, int m_patterns) {
  using C = Tiles<PI, PO>;
  return chunks_for((n + C::TN - 1) / C::TN, (m_patterns + TM - 1) / TM * C::PARTS,
                    concurrent_blocks(stream_bwd_dku_kernel<PI, PO>, THREADS, C::BYTES));
}

struct Args {
  const float *x, *K, *U, *s, *t, *g, *m, *l, *delta;
  float *dK, *dU, *workspace;
  int n, m_patterns, d_in, d_out;
  cudaStream_t stream;
};

template <int PI, int PO>
int launch(const Args& a) {
  using C = Tiles<PI, PO>;
  auto kernel = stream_bwd_dku_kernel<PI, PO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const int chunks = chunks_of<PI, PO>(a.n, a.m_patterns);
  const int token_tiles = (a.n + C::TN - 1) / C::TN;
  const int tiles_per_chunk = (token_tiles + chunks - 1) / chunks;
  float* q = a.workspace;
  float* il = q + static_cast<size_t>(a.n) * a.d_in;
  float* dk_part = il + a.n;
  float* du_part = dk_part + static_cast<size_t>(chunks) * a.m_patterns * a.d_in;
  stream_bwd_query_kernel<<<(a.n + Q_ROWS - 1) / Q_ROWS, Q_THREADS, 0, a.stream>>>(a.x, a.s, a.t, a.l, a.n, a.d_in,
                                                                                 q, il);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(q, a.d_in) | vec16_ok(a.g, a.d_out) << 1 | vec16_ok(a.K, a.d_in) << 2 |
                         vec16_ok(a.U, a.d_out) << 3;
  const dim3 grid((a.m_patterns + TM - 1) / TM, (token_tiles + tiles_per_chunk - 1) / tiles_per_chunk, C::PARTS);
  kernel<<<grid, THREADS, C::BYTES, a.stream>>>(q, a.K, a.U, a.g, a.m, il, a.delta, dk_part, du_part, a.n,
                                                a.m_patterns, a.d_in, a.d_out, tiles_per_chunk, beta_of(a.d_in),
                                                vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_rows(dk_part, grid.y, a.m_patterns * a.d_in, a.dK, a.stream);
  if (err != cudaSuccess) return err;
  return sum_rows(du_part, grid.y, a.m_patterns * a.d_out, a.dU, a.stream);
}


// ---- past 256: the cluster (hopfield_cluster.cuh) or the narrow-side
// kernel (the pieces of hopfield_narrow.cuh)

// The narrow-side K3 for the block's TM patterns over its chunk of the
// token tiles of the built q: blockIdx.y < ck wk, dK's window w (of CW
// columns of d_in) and chunk c of ck (y = w ck + c); past them, dU's
// window and chunk of cu (d_out). Per token tile: the parts of K and q
// (their columns below d_in; in the order (group, trunc), score_order's:
// part after part, or the cluster's groups),
// or, where the scores were split, the tile of S^T; for dK then the parts
// of U and g, or the tile of P^T; then the window of q (dK) or g (dU), its
// live columns, with the tile's m, 1/l and delta. A^T (and dS^T for dK) on
// the fragments, then the window's live n-tiles over the tile's tokens in
// fresh fragments added to the running sums. S^T and P^T are the slab's
// (M by N, their rows from pattern p_base; the grid's x axis is the slab's
// pattern tiles). A buffer holds `slot` floats.
template <int CW>
__global__ void __launch_bounds__(hopfield_narrow::THREADS, 2)
stream_bwd_dku_narrow_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                             const float* __restrict__ g, const float* __restrict__ S, const float* __restrict__ P,
                             const float* __restrict__ m_in, const float* __restrict__ il_in,
                             const float* __restrict__ delta, float* __restrict__ dk_part, float* __restrict__ du_part,
                             int n, int m_patterns, int d_in, int d_out, int tk, int ck, int tu, int cu, int p_base,
                             int slot, float beta, int group, int trunc, unsigned vec16) {
  using namespace hopfield_narrow;
  constexpr int CO = CW / 8, RW = CW + 4;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // buffer u at buf + u * slot

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int p0 = p_base + blockIdx.x * hopfield_narrow::TM;
  int y = blockIdx.y;
  const bool for_dk = y < ck * windows_of(d_in, CW);
  if (!for_dk) y -= ck * windows_of(d_in, CW);
  const int chunks = for_dk ? ck : cu, per = for_dk ? tk : tu;
  const int win = y / chunks, chunk = y - win * chunks;
  const int col0 = win * CW;
  const int d_win = for_dk ? d_in : d_out;  // the width of the block's output
  const int w_cols = min(CW, d_win - col0);
  const int ww = staged(w_cols), co = (w_cols + 7) / 8;  // the window's staged columns and live n-tiles
  const int first = chunk * per;
  const int last = min((n + TN - 1) / TN, first + per) - 1;
  const bool with_p = for_dk && P;  // the block reads P^T
  const int nqi = S ? 0 : parts_of(d_in), ngo = for_dk && !P ? parts_of(d_out) : 0;
  const int per_tile = nqi + ngo + 1;
  const int items = (last - first + 1) * per_tile;
  const bool qv = vec16 & 1u, gv = vec16 >> 1 & 1u, kv = vec16 >> 2 & 1u, uv = vec16 >> 3 & 1u,
             sv = vec16 >> 4 & 1u, pv = vec16 >> 5 & 1u;

  auto stage_item = [&](int i) {
    if (i < items) {
      float* yb = buf + (i % NB) * slot;
      const int it = first + i / per_tile, sub = i % per_tile;
      if (sub < nqi) {
        const int c0 = sub * PART, w = staged(min(PART, d_in - c0));
        stage<hopfield_narrow::TM>(yb, RP, K, d_in, c0, w, p0, m_patterns, kv);
        stage<TN>(yb + hopfield_narrow::TM * RP, RP, q, d_in, c0, w, it * TN, n, qv);
      } else if (sub < nqi + ngo) {
        const int c0 = (sub - nqi) * PART, w = staged(min(PART, d_out - c0));
        stage<hopfield_narrow::TM>(yb, RP, U, d_out, c0, w, p0, m_patterns, uv);
        stage<TN>(yb + hopfield_narrow::TM * RP, RP, g, d_out, c0, w, it * TN, n, gv);
      } else {
        float* wt = yb;
        if (S) {
          stage<hopfield_narrow::TM>(wt, RSC, S, n, it * TN, TN, p0 - p_base, m_patterns - p_base, sv);
          wt += hopfield_narrow::TM * RSC;
        }
        if (with_p) {
          stage<hopfield_narrow::TM>(wt, RSC, P, n, it * TN, TN, p0 - p_base, m_patterns - p_base, pv);
          wt += hopfield_narrow::TM * RSC;
        }
        if (for_dk) stage<TN>(wt, RW, q, d_in, col0, ww, it * TN, n, qv);
        else stage<TN>(wt, RW, g, d_out, col0, ww, it * TN, n, gv);
        float* st = wt + TN * RW;  // m, 1/l, delta of the tile's tokens
        for (int j = threadIdx.x; j < 3 * TN; j += hopfield_narrow::THREADS) {
          const int r = it * TN + j % TN;
          const bool in = r < n;
          const float* src = j < TN ? m_in : j < 2 * TN ? il_in : delta;
          cp_async4(st + j, in ? src + r : src, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) stage_item(i);

  bool live_p[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) live_p[e] = p0 + m0 + gq + 8 * e < m_patterns;
  float acc[CO][4], sc[NT][4], dp[NT][4], gs[NT][4];
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  hopfield_narrow::zero(sc);
  hopfield_narrow::zero(dp);
  hopfield_narrow::zero(gs);

  // the slab's rows gq and gq + 8 of a TM x RSC tile of S^T or P^T into a C fragment
  auto load_tile = [&](float (&f)[NT][4], const float* t) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(t + (m0 + gq + 8 * r) * RSC + 8 * j + 2 * tq);
        f[j][2 * r] = v.x;
        f[j][2 * r + 1] = v.y;
      }
  };

  for (int i = 0; i < items; ++i) {
    cp_async_wait_all();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    stage_item(i + NB - 1);
    const float* yb = buf + (i % NB) * slot;
    const int it = first + i / per_tile, sub = i % per_tile;
    if (sub < nqi + ngo) {  // a part of K q^T (in the order's groups), or of U g^T, in a fresh sum
      const bool score = sub < nqi;
      float pp[NT][4];
      const float* b = yb + hopfield_narrow::TM * RP;
      if (score && trunc) part_product<true>(pp, yb + m0 * RP, b, part_steps(d_in, sub), gq, tq);
      else part_product<false>(pp, yb + m0 * RP, b, score ? part_steps(d_in, sub) : part_steps(d_out, sub - nqi), gq, tq);
      if (score) {
        add_part(sc, gs, pp, sub, group, nqi);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = sub == nqi ? pp[j][e] : dp[j][e] + pp[j][e];
      }
      continue;
    }
    const float* wt = yb;
    if (S) {  // the tile's scores, patterns gq and gq + 8 of the slab, tokens 8j + 2tq and + 1
      load_tile(sc, wt);
      wt += hopfield_narrow::TM * RSC;
    }
    if (with_p) {  // and its U g^T
      load_tile(dp, wt);
      wt += hopfield_narrow::TM * RSC;
    }
    // ---- A^T (and dS^T for dK) on the fragments, then the window's
    // outputs over the tile's tokens
    const int tok_lo = it * TN;
    const float* st = wt + TN * RW;
    FragA fa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = 8 * j + 2 * tq + (e & 1);
        const float a =
            live_p[e >> 1] && tok_lo + tl < n ? __expf(sc[j][e] * beta - st[tl]) * st[TN + tl] : 0.f;
        v[e] = for_dk ? a * (dp[j][e] - st[2 * TN + tl]) * beta : a;
      }
      fa[j] = split_a(v[0], v[2], v[1], v[3]);
    }
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      if (c >= co) continue;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, fa[j], load_b_cols<RW>(wt + 8 * j * RW + 8 * c, gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += o[e];
    }
  }

  // ---- this chunk's partial rows of dK or dU, (chunks, M, d), the
  // window's columns below the width
  float* part = for_dk ? dk_part : du_part;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live_p[e]) continue;
    const size_t row = static_cast<size_t>(chunk) * m_patterns + p0 + m0 + gq + 8 * e;
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = col0 + 8 * c + 2 * tq + hh;
        if (col < d_win) part[row * d_win + col] = acc[c][2 * e + hh];
      }
  }
}

// The whole window (hopfield_narrow.cuh) for the block's TM patterns of
// K and U over its chunk of the token tiles of the built q: dK over all
// of d_in (staged to DW) and dU (WO columns). Warp w holds the 16-pattern
// slab w & 3 and half w >> 2 of dK's n-tiles (CT each) and of dU's (CU
// each). K and U stay in shared memory for the walk; each token tile's q
// (every column), g and row stats arrive in one of two buffers. Per tile
// each warp computes two n-tiles of its slab's K q^T (tokens 16 h to
// 16 h + 15 of the tile) in the order (group, trunc) and of U g^T (one
// part, rounded), A^T and dS^T on them, and hands both to the slab's
// other warp through shared memory (a named barrier of the two); then
// dU += A^T g and dK += dS^T q over its half's live n-tiles, the tile in
// fresh fragments added to the running sums after the tile.
template <int DW, int WO>
__global__ void __launch_bounds__(hopfield_narrow::WHOLE_THREADS, 1)
stream_bwd_dku_whole_kernel(const float* __restrict__ q, const float* __restrict__ K, const float* __restrict__ U,
                            const float* __restrict__ g, const float* __restrict__ m_in,
                            const float* __restrict__ il_in, const float* __restrict__ delta,
                            float* __restrict__ dk_part, float* __restrict__ du_part, int n, int m_patterns, int d_in,
                            int d_out, int per, float beta, int group, int trunc, unsigned vec16) {
  using namespace hopfield_narrow;
  constexpr int QS = DW + 4, GS = WO + 4, CT = DW / 16, CU = (WO / 8 + 1) / 2, BUF = TN * (QS + GS) + 3 * TN;
  constexpr int TM = hopfield_narrow::TM;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* u_s = k_s + TM * QS;
  float* a_s = u_s + TM * GS;
  float* ds_s = a_s + TM * DS;
  float* str = ds_s + TM * DS;  // buffer u at str + u * BUF: q tile, g tile, then m, 1/l, delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), h = warp >> 2;
  const int p0 = blockIdx.x * TM;
  const int first = blockIdx.y * per;
  const int last = min((n + TN - 1) / TN, first + per) - 1;
  const int co = (d_in + 7) / 8, cou = (d_out + 7) / 8;  // dK's and dU's live n-tiles (dU's: g U^T's k-steps)
  const bool qv = vec16 & 1u, gv = vec16 >> 1 & 1u, kv = vec16 >> 2 & 1u, uv = vec16 >> 3 & 1u;

  stage_whole<TM>(k_s, QS, K, d_in, p0, m_patterns, kv);
  stage<TM, WHOLE_THREADS>(u_s, GS, U, d_out, 0, staged(d_out), p0, m_patterns, uv);
  auto stage_tile = [&](int it, int u) {
    float* y = str + u * BUF;
    stage_whole<TN>(y, QS, q, d_in, it * TN, n, qv);
    stage<TN, WHOLE_THREADS>(y + TN * QS, GS, g, d_out, 0, staged(d_out), it * TN, n, gv);
    float* st = y + TN * (QS + GS);
    for (int i = threadIdx.x; i < 3 * TN; i += WHOLE_THREADS) {
      const int r = it * TN + i % TN;
      const bool in = r < n;
      const float* src = i < TN ? m_in : i < 2 * TN ? il_in : delta;
      cp_async4(st + i, in ? src + r : src, in);
    }
    cp_async_commit();
  };
  stage_tile(first, 0);  // one group with K and U

  bool live_p[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) live_p[e] = p0 + m0 + gq + 8 * e < m_patterns;
  float dk[CT][4], du[CU][4];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = 0.f;
#pragma unroll
  for (int c = 0; c < CU; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) du[c][e] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int u = (it - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1 and its A^T, dS^T
    if (it < last) stage_tile(it + 1, u ^ 1);
    const float* y = str + u * BUF;  // q
    const float* gt = y + TN * QS;
    const float* st = gt + TN * GS;  // m, 1/l, delta of the tile's tokens
    const int tok_lo = it * TN;

    // ---- the warp's two n-tiles of K q^T and U g^T, A^T and dS^T on them
    float sc[2][4], dp[2][4];
    ordered_pair<QS>(sc, k_s + m0 * QS, y + 16 * h * QS, d_in, group, trunc, gq, tq);
    pair_part<GS, false>(dp, u_s + m0 * GS, gt + 16 * h * GS, cou, gq, tq);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = 16 * h + 8 * j + 2 * tq + (e & 1);
        a[e] = live_p[e >> 1] && tok_lo + tl < n ? __expf(sc[j][e] * beta - st[tl]) * st[TN + tl] : 0.f;
        d[e] = a[e] * (dp[j][e] - st[2 * TN + tl]) * beta;
      }
      put_pair(a_s + m0 * DS, 2 * h + j, a, gq, tq);
      put_pair(ds_s + m0 * DS, 2 * h + j, d, gq, tq);
    }
    named_barrier(1 + (warp & 3), 64);  // the slab's two warps have written its A^T and dS^T

    // ---- dU += A^T g, then dK += dS^T q, over the half's live n-tiles
    FragA fa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) fa[j] = get_pair(a_s + m0 * DS, j, gq, tq);
#pragma unroll
    for (int c = 0; c < CU; ++c) {
      const int cn = h * CU + c;
      if (cn >= cou) break;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, fa[j], load_b_cols<GS>(gt + 8 * j * GS + 8 * cn, gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) du[c][e] += o[e];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) fa[j] = get_pair(ds_s + m0 * DS, j, gq, tq);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int cn = h * CT + c;
      if (cn >= co) break;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(o, fa[j], load_b_cols<QS>(y + 8 * j * QS + 8 * cn, gq, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][e] += o[e];
    }
  }

  // ---- this chunk's partial rows of dK and dU, (chunks, M, d), the
  // half's columns below the widths
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live_p[e]) continue;
    const size_t row = static_cast<size_t>(blockIdx.y) * m_patterns + p0 + m0 + gq + 8 * e;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 8 * (h * CT + c) + 2 * tq + hh;
        if (col < d_in) dk_part[row * d_in + col] = dk[c][2 * e + hh];
      }
#pragma unroll
    for (int c = 0; c < CU; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 8 * (h * CU + c) + 2 * tq + hh;
        if (col < d_out) du_part[row * d_out + col] = du[c][2 * e + hh];
      }
  }
}

// Shared bytes of the whole window's instance: K and U, the A^T and dS^T
// tiles, two buffers of a q and a g tile with their row stats.
template <int DW, int WO>
constexpr size_t whole_bytes() {
  using namespace hopfield_narrow;
  return sizeof(float) *
         (hopfield_narrow::TM * (DW + 4 + WO + 4 + 2 * DS) + 2 * (TN * (DW + 4 + WO + 4) + 3 * TN));
}

// The whole window's chunks of the token tiles: about WHOLE_WAVES waves of
// one block an SM over the pattern tiles, at most one chunk a token tile;
// balanced.
constexpr int WHOLE_WAVES = 2;
inline void whole_chunks(int token_tiles, int pattern_tiles, int sms, int& per, int& chunks) {
  chunks = std::max(1, std::min(token_tiles, WHOLE_WAVES * std::max(sms, 1) / pattern_tiles));
  per = (token_tiles + chunks - 1) / chunks;
  chunks = (token_tiles + per - 1) / per;
}

// The narrow-side plan: the order of the score parts (score_order); the
// whole window where whole_fits takes the widths (whole_chunks; dK's and
// dU's chunks the same, nothing split); else the window (the wider
// side's, d padded to 8 up to 128, else 128), the chunks of the token
// tiles, dK's (tk tiles each, ck
// of them) apart from dU's (tu, cu): about NARROW_WAVES waves of the
// blocks the card holds, a block of either kind about the same work (a
// tile's k-steps of its products and its window's n-tiles, and FIXED for
// its staging and exps), so that dK's blocks, which alone carry U g^T, do
// not set the pace; a tile's work counted as the walk's (its products
// computed in the window) on every route, so the chunks, and with them
// dK's and dU's sums, are the walk's. Then which products are split over
// the card first: S^T where d_in has more than one part and more than one
// window (each window would recompute it), P^T likewise for dK's windows;
// and the split's slabs of pattern tiles and rounds of groups
// (hopfield_narrow::slab_plan, each slab at least as many tiles as keep
// the window kernel at two blocks an SM where the cap allows; where it
// does not, more chunks: at (1280, 3), N 73,984, M 4,096 a slab holds one
// pattern tile, and 11 blocks walked all 2,312 token tiles, 1,049 ms
// against the cluster's 242 on an H100). Where one pattern tile's sums
// and one group pass SPLIT_BYTES, nothing is split.
constexpr int NARROW_WAVES = 2;
constexpr int FIXED_STEPS = 2;
struct DkuPlan {
  int cw;  // the window: on the whole window its staged depth
  hopfield_narrow::Order order;
  bool whole, split_s, split_p;
  int tk, ck, tu, cu;
  hopfield_narrow::SlabPlan slabs;
};
inline int narrow_width(int d_in, int d_out) {
  const int d = d_in > d_out ? d_in : d_out;
  return d <= 128 ? padded_width(d) : 128;
}
inline DkuPlan dku_window_plan(int n, int m_patterns, int d_in, int d_out, int concurrent, int sms) {
  using namespace hopfield_narrow;
  DkuPlan p{};
  p.order = score_order(d_in, d_out);
  const int tt = (n + TN - 1) / TN, pt = (m_patterns + hopfield_narrow::TM - 1) / hopfield_narrow::TM;
  int wo;
  if (whole_fits(d_in, d_out, p.cw, wo)) {
    p.whole = true;
    whole_chunks(tt, pt, sms, p.tk, p.ck);
    p.tu = p.tk, p.cu = p.ck;
    return p;
  }
  p.cw = narrow_width(d_in, d_out);
  const long long wk = windows_of(d_in, p.cw), wu = windows_of(d_out, p.cw);
  const long long ks_in = (d_in + 7) / 8, ks_out = (d_out + 7) / 8;
  const long long cost_k = ks_in + ks_out + (std::min(p.cw, d_in) + 7) / 8 + FIXED_STEPS;
  const long long cost_u = ks_in + (std::min(p.cw, d_out) + 7) / 8 + FIXED_STEPS;
  const long long total = static_cast<long long>(pt) * tt * (wk * cost_k + wu * cost_u);
  const long long work = std::max(1ll, total / (NARROW_WAVES * static_cast<long long>(std::max(concurrent, 1))));
  auto split_tiles = [&](long long cost, int& per, int& chunks) {
    per = static_cast<int>(std::min<long long>(tt, std::max(1ll, work / cost)));
    chunks = (tt + per - 1) / per;
    per = (tt + chunks - 1) / chunks;
  };
  split_tiles(cost_k, p.tk, p.ck);
  split_tiles(cost_u, p.tu, p.cu);
  p.split_s = parts_of(d_in) >= 2 && wk > 1;
  p.split_p = parts_of(d_out) >= 2 && wk > 1;
  if (p.split_s || p.split_p) {
    const long long per_tile = p.ck * wk + p.cu * wu;  // window blocks a pattern tile
    const int parts = std::max(p.split_s ? groups_of(d_in, p.order) : 0, p.split_p ? parts_of(d_out) : 0);
    const long long fill = (2ll * std::max(sms, 1) + per_tile - 1) / per_tile;
    if (!slab_plan(m_patterns, n, p.split_s + p.split_p, parts, fill, p.slabs)) {
      p.split_s = p.split_p = false;
      return p;
    }
    // Where the cap leaves a slab too few pattern tiles to hold two window
    // blocks an SM (one tile's sums across N take most of it), dK's and
    // dU's token axes take that many times more chunks, up to a tile each.
    const long long blocks = static_cast<long long>(p.slabs.slab) * per_tile;
    if (blocks < 2ll * std::max(sms, 1)) {
      const long long more = (2ll * std::max(sms, 1) + blocks - 1) / blocks;
      auto widen = [&](int& per, int& chunks) {
        chunks = static_cast<int>(std::min<long long>(tt, chunks * more));
        per = (tt + chunks - 1) / chunks;
        chunks = (tt + per - 1) / per;
      };
      widen(p.tk, p.ck);
      widen(p.tu, p.cu);
    }
  }
  return p;
}

// Floats of a buffer of the narrow-side kernel on the plan: a part item,
// or the window item (the split products' tiles, a window of q or g, the
// row stats).
inline int dku_slot(const DkuPlan& p) {
  using namespace hopfield_narrow;
  return std::max(SLOT, (p.split_s + p.split_p) * hopfield_narrow::TM * RSC + TN * (p.cw + 4) + 3 * TN);
}

inline int concurrent_narrow(int cw) {
  return hopfield_narrow::with_window(cw, [&](auto c) {
    return concurrent_blocks(stream_bwd_dku_narrow_kernel<decltype(c)::value>, hopfield_narrow::THREADS,
                             hopfield_narrow::BYTES);
  });
}

inline DkuPlan dku_plan_of(int n, int m_patterns, int d_in, int d_out) {
  return dku_window_plan(n, m_patterns, d_in, d_out, concurrent_narrow(narrow_width(d_in, d_out)),
                         hopfield_narrow::sm_count());
}

// The chunks of the token axis past 256 on the cluster: its plan
// (hopfield_cluster::cluster_chunks, clusters of pattern tiles).
int chunks_cluster(int n, int m_patterns, int j, int ranks) {
  int tm, tn;
  hopfield_cluster::tile_rows(j, tm, tn);
  return hopfield_cluster::cluster_chunks((n + tn - 1) / tn, (m_patterns + tm - 1) / tm,
                                          hopfield_cluster::concurrent_clusters<true>(j, ranks));
}

// Floats of scratch past 256: q and 1/l, the partial rows of dK and dU,
// and on the narrow-side plan, from the next multiple of 4 floats, the
// split products' (a slab's S^T and P^T, then a round's parts: at most
// SPLIT_BYTES; none where nothing is split).
long long workspace_wide(int n, int m_patterns, int d_in, int d_out) {
  const long long qs = static_cast<long long>(n) * (d_in + 1);
  int j, ranks;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks))
    return qs + static_cast<long long>(chunks_cluster(n, m_patterns, j, ranks)) * m_patterns * (d_in + d_out);
  const DkuPlan p = dku_plan_of(n, m_patterns, d_in, d_out);
  const long long floats =
      qs + static_cast<long long>(m_patterns) * (static_cast<long long>(p.ck) * d_in + static_cast<long long>(p.cu) * d_out);
  return (floats + 3) / 4 * 4 + p.slabs.floats;
}

// Past 256: the cluster kernel (hopfield_cluster.cuh) where its plan takes
// the widths, else the narrow-side plan: the whole window where it fits,
// or the narrow-side kernel slab after slab.
int launch_wide(const Args& a) {
  using hopfield_narrow::windows_of;
  int j, ranks;
  const bool clustered = hopfield_cluster::plan(a.d_in, a.d_out, j, ranks);
  float* q = a.workspace;
  float* il = q + static_cast<size_t>(a.n) * a.d_in;
  float* dk_part = il + a.n;
  cudaError_t err = hopfield_wide::build_queries(a.x, a.s, a.t, a.n, a.d_in, q, a.l, il, a.stream);
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(q, a.d_in) | vec16_ok(a.g, a.d_out) << 1 | vec16_ok(a.K, a.d_in) << 2 |
                         vec16_ok(a.U, a.d_out) << 3;
  int dk_rows, du_rows;  // the chunks of the partial rows of dK and dU
  float* du_part;
  if (clustered) {
    const int chunks = chunks_cluster(a.n, a.m_patterns, j, ranks);
    du_part = dk_part + static_cast<size_t>(chunks) * a.m_patterns * a.d_in;
    err = hopfield_cluster::with_chunks(j, [&](auto jj) {
      constexpr int J = decltype(jj)::value;
      using C = cluster::Cfg<J>;
      const int token_tiles = (a.n + C::TN - 1) / C::TN;
      const int tiles_per_chunk = (token_tiles + chunks - 1) / chunks;
      dk_rows = du_rows = (token_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
      const unsigned cvec16 = (vec16 >> 2 & 3u) | (vec16 & 3u) << 2;  // K, U resident; q, g streamed
      return hopfield_cluster::launch_cluster<J, true>(
          dim3((a.m_patterns + C::TM - 1) / C::TM, dk_rows, ranks), a.K, a.U, q, a.g, a.m, il, a.delta, dk_part,
          du_part, a.m_patterns, a.n, a.d_in, a.d_out, tiles_per_chunk, beta_of(a.d_in), cvec16, a.stream);
    });
  } else if (const DkuPlan w = dku_plan_of(a.n, a.m_patterns, a.d_in, a.d_out); w.whole) {
    du_part = dk_part + static_cast<size_t>(w.ck) * a.m_patterns * a.d_in;
    dk_rows = du_rows = w.ck;
    err = hopfield_narrow::with_whole(w.cw, [&](auto dw, auto wo) {
      constexpr int DW = decltype(dw)::value, WO = decltype(wo)::value;
      auto kernel = stream_bwd_dku_whole_kernel<DW, WO>;
      constexpr size_t bytes = whole_bytes<DW, WO>();
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
      kernel<<<dim3((a.m_patterns + hopfield_narrow::TM - 1) / hopfield_narrow::TM, w.ck),
               hopfield_narrow::WHOLE_THREADS, bytes, a.stream>>>(q, a.K, a.U, a.g, a.m, il, a.delta, dk_part, du_part,
                                                                  a.n, a.m_patterns, a.d_in, a.d_out, w.tk,
                                                                  beta_of(a.d_in), w.order.group, w.order.trunc, vec16);
      return cudaGetLastError();
    });
  } else {  // slab after slab of pattern tiles: the slab's split products, then the kernel over its tiles
    using hopfield_narrow::TM;
    const DkuPlan& p = w;
    const long long blocks_y =
        static_cast<long long>(p.ck) * windows_of(a.d_in, p.cw) + static_cast<long long>(p.cu) * windows_of(a.d_out, p.cw);
    if (blocks_y > 65535) return cudaErrorInvalidValue;
    du_part = dk_part + static_cast<size_t>(p.ck) * a.m_patterns * a.d_in;
    // the split's scratch, from a 16-byte boundary (the workspace's base is one): [S^T | P^T | a round's parts]
    float* work = a.workspace +
                  (static_cast<size_t>(du_part - a.workspace) + static_cast<size_t>(p.cu) * a.m_patterns * a.d_out + 3) /
                      4 * 4;
    const bool split = p.split_s || p.split_p;
    const int slab_rows = split ? std::min(p.slabs.slab * TM, a.m_patterns) : a.m_patterns;
    const long long sums = static_cast<long long>(slab_rows) * a.n;  // floats of a product's sums
    float* S = p.split_s ? work : nullptr;
    float* P = p.split_p ? work + (p.split_s ? sums : 0) : nullptr;
    float* parts = work + (p.split_s + p.split_p) * sums;
    const int slot = dku_slot(p), sms = hopfield_narrow::sm_count();
    const size_t bytes = sizeof(float) * hopfield_narrow::NB * slot;
    dk_rows = p.ck;
    du_rows = p.cu;
    err = hopfield_narrow::with_window(p.cw, [&](auto c) {
      constexpr int CW = decltype(c)::value;
      auto kernel = stream_bwd_dku_narrow_kernel<CW>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      const unsigned svec16 = vec16 | (S ? vec16_ok(S, a.n) : 0u) << 4 | (P ? vec16_ok(P, a.n) : 0u) << 5;
      for (int r0 = 0; e == cudaSuccess && r0 < a.m_patterns; r0 += slab_rows) {
        const int rows = std::min(slab_rows, a.m_patterns - r0);
        if (S) e = hopfield_narrow::split_slab(a.K + static_cast<size_t>(r0) * a.d_in, q, S, parts, rows, a.n, a.d_in,
                                               p.order, p.slabs.round, sms, a.stream);
        if (P && e == cudaSuccess)
          e = hopfield_narrow::split_slab(a.U + static_cast<size_t>(r0) * a.d_out, a.g, P, parts, rows, a.n,
                                          a.d_out, {1, false}, p.slabs.round, sms, a.stream);
        if (e != cudaSuccess) break;
        kernel<<<dim3((rows + TM - 1) / TM, static_cast<unsigned>(blocks_y)), hopfield_narrow::THREADS, bytes,
                 a.stream>>>(q, a.K, a.U, a.g, S, P, a.m, il, a.delta, dk_part, du_part, a.n, a.m_patterns, a.d_in,
                             a.d_out, p.tk, p.ck, p.tu, p.cu, r0, slot, beta_of(a.d_in), p.order.group,
                             p.order.trunc, svec16);
        e = cudaGetLastError();
      }
      return e;
    });
  }
  if (err != cudaSuccess) return err;
  err = sum_rows(dk_part, dk_rows, a.m_patterns * a.d_in, a.dK, a.stream);
  if (err != cudaSuccess) return err;
  return sum_rows(du_part, du_rows, a.m_patterns * a.d_out, a.dU, a.stream);
}

}  // namespace

// Floats of device scratch that hopfield_stream_bwd_dku needs: q (n, d_in)
// and 1/l (n), then one partial dK (m_patterns, d_in) and one partial dU
// (m_patterns, d_out) for each chunk of the token axis.
extern "C" long long hopfield_stream_bwd_dku_workspace(int n, int m_patterns, int d_in, int d_out) {
  if (n > 0 && m_patterns > 0 && d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out))
    return workspace_wide(n, m_patterns, d_in, d_out);
  if (!takes(n, m_patterns, d_in, d_out)) return 0;
  const int chunks = with_widths(d_in, d_out, [&](auto pi, auto po) {
    return chunks_of<decltype(pi)::value, decltype(po)::value>(n, m_patterns);
  });
  return static_cast<long long>(n) * (d_in + 1) + static_cast<long long>(chunks) * m_patterns * (d_in + d_out);
}

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), g (n, d_out), m, l and delta (n),
// dK (m_patterns, d_in), dU (m_patterns, d_out), and workspace (see
// above); any d_in, d_out >= 1 (past 256 the wide variant). Launches the
// first pass, the kernel and the fixed-order sums of the chunks on
// `stream`. Returns a cudaError_t; 0 means every launch was accepted.
extern "C" int hopfield_stream_bwd_dku(const float* x, const float* K, const float* U, const float* s,
                                       const float* t, const float* g, const float* m, const float* l,
                                       const float* delta, float* dK, float* dU, float* workspace, int n,
                                       int m_patterns, int d_in, int d_out, void* stream) {
  const Args a{x, K, U, s, t, g, m, l, delta, dK, dU, workspace, n, m_patterns, d_in, d_out,
               static_cast<cudaStream_t>(stream)};
  if (n > 0 && m_patterns > 0 && d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out))
    return launch_wide(a);
  if (!takes(n, m_patterns, d_in, d_out)) return cudaErrorInvalidValue;
  return with_widths(d_in, d_out, [&](auto pi, auto po) { return launch<decltype(pi)::value, decltype(po)::value>(a); });
}

// The kernel built for (d_in, d_out) as the card reports it: out receives
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// threads a block, blocks an SM, TM and TN; past 256 the cluster kernel's
// where its plan takes the widths (hopfield_cluster::plan), the whole
// window's where it fits (hopfield_narrow::whole_fits), else the
// narrow-side kernel's. Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dku_attributes(int d_in, int d_out, int* out) {
  int j, ranks, dw, wo;
  if (d_in >= 1 && d_out >= 1 && hopfield_cluster::plan(d_in, d_out, j, ranks))
    return static_cast<int>(hopfield_cluster::cluster_build<true>(d_in, d_out, true, out));
  if (d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out) && hopfield_narrow::whole_fits(d_in, d_out, dw, wo))
    return hopfield_narrow::with_whole(dw, [&](auto w, auto o) {
      constexpr int DW = decltype(w)::value, WO = decltype(o)::value;
      return static_cast<int>(kernel_attributes(stream_bwd_dku_whole_kernel<DW, WO>, hopfield_narrow::WHOLE_THREADS,
                                                whole_bytes<DW, WO>(), hopfield_narrow::TM, hopfield_narrow::TN, out));
    });
  if (d_in >= 1 && d_out >= 1 && hopfield_wide::wide(d_in, d_out))
    return hopfield_narrow::with_window(narrow_width(d_in, d_out), [&](auto c) {
      return static_cast<int>(kernel_attributes(stream_bwd_dku_narrow_kernel<decltype(c)::value>,
                                                hopfield_narrow::THREADS, hopfield_narrow::BYTES,
                                                hopfield_narrow::TM, hopfield_narrow::TN, out));
    });
  if (!takes(1, 1, d_in, d_out)) return cudaErrorInvalidValue;
  return with_widths(d_in, d_out, [&](auto pi, auto po) {
    constexpr int PI = decltype(pi)::value, PO = decltype(po)::value;
    using C = Tiles<PI, PO>;
    return static_cast<int>(kernel_attributes(stream_bwd_dku_kernel<PI, PO>, THREADS, C::BYTES, TM, C::TN, out));
  });
}

// The cluster kernel of (d_in, d_out) where its plan takes the widths
// (hopfield_cluster::plan; else cudaErrorInvalidValue): out receives the
// blocks of a cluster, the slice width at most, and the clusters the card
// can hold at once (0: it cannot launch). Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dku_cluster(int d_in, int d_out, int* out) {
  if (d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  return static_cast<int>(hopfield_cluster::cluster_build<true>(d_in, d_out, false, out));
}

// The route of (n, m_patterns, d_in, d_out) past 256, into out[0..10]: 1
// the cluster; on the narrow-side kernel 2, plus 1 where S^T = K q^T is
// split over the card first and 2 where P^T = U g^T is; 7 the whole
// window (0 up to 256: a built instance); then the narrow-side plan's
// window (the whole window's staged depth), dK's tiles a chunk
// and chunks, dU's; where a product is split, its slabs, the pattern tiles
// of a slab, the rounds and the parts of a round, and the split's floats
// of scratch (0 where it does not run). Returns a cudaError_t.
extern "C" int hopfield_stream_bwd_dku_plan(int n, int m_patterns, int d_in, int d_out, int* out) {
  if (n <= 0 || m_patterns <= 0 || d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  for (int i = 0; i < 11; ++i) out[i] = 0;
  int j, ranks;
  if (!hopfield_wide::wide(d_in, d_out)) return cudaSuccess;
  out[0] = 1;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks)) return cudaSuccess;
  const DkuPlan p = dku_plan_of(n, m_patterns, d_in, d_out);
  out[0] = p.whole ? 7 : 2 + p.split_s + 2 * p.split_p;
  out[1] = p.cw;
  out[2] = p.tk;
  out[3] = p.ck;
  out[4] = p.tu;
  out[5] = p.cu;
  out[6] = p.slabs.slabs;
  out[7] = p.slabs.slab;
  out[8] = p.slabs.rounds;
  out[9] = p.slabs.round;
  out[10] = static_cast<int>(p.slabs.floats);
  return cudaSuccess;
}
