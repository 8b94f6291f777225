// Streaming modern-Hopfield lookup, backward for the pattern tables, for
// Hopper (sm_90a).
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
// What bounds it on an H100: arithmetic, 2*N*M*(2*d_in + 2*d_out) FLOPs
// (the score product, g U^T, A^T g and dS^T q) and N*M exps, against
// reading the inputs once and writing dK and dU.
//
// Design:
// - One block of 256 threads keeps one tile of 64 patterns of K and U in
//   shared memory and walks a chunk of the token axis in tiles of 64,
//   rebuilding q (LayerNorm in double, from hopfield_stream.cuh, as K1)
//   and the attention tile as K1 computed it. Rows >= N and patterns >= M
//   are masked to A = 0 here; the caller pads nothing.
// - The TPU runs one program per pattern block and sums over the token
//   blocks in its sequential grid. 64 pattern tiles (M = 4096) or 8
//   (M = 512) would leave most of the 132 SMs idle, so the token axis is
//   split into chunks: each block writes its chunk's partial dK and dU,
//   shaped (chunks, M, d), and a second pass sums the chunks in order. No
//   float atomics: the result has the same bits in every run.
// - Widths of 64: A and dS go through shared memory as [token][pattern],
//   and thread (ty, tx) accumulates patterns ty*4+i against columns
//   tx*4+c. Widths of 3: each thread keeps a 4x3 partial for its own
//   patterns tx+16*j over its own tokens, and the 16 row groups are summed
//   in order at the end of the chunk. Nothing is padded.
// - Plain f32 FMA on the CUDA cores.

#include "hopfield_stream.cuh"

namespace {

using namespace hopfield_stream;

// chunks of the token axis: enough blocks to fill the card several times
// over, or one chunk per token tile
constexpr int TARGET_BLOCKS = 8 * 132;

int chunks_for(int n, int m_patterns) {
  const int token_tiles = (n + BLOCK_N - 1) / BLOCK_N;
  const int pattern_tiles = (m_patterns + BLOCK_M - 1) / BLOCK_M;
  const int want = (TARGET_BLOCKS + pattern_tiles - 1) / pattern_tiles;
  return want < token_tiles ? want : token_tiles;
}

template <int D_IN, int D_OUT>
struct Layout {
  static constexpr int QS = stride_of<D_IN>();   // q rows, K rows
  static constexpr int GS = stride_of<D_OUT>();  // g rows, U rows
  static constexpr int PS = BLOCK_M + 4;          // A and dS as [token][pattern]
  static constexpr bool WIDE_IN = D_IN % 4 == 0;
  static constexpr bool WIDE_OUT = D_OUT % 4 == 0;
  static constexpr int NARROW = WIDE_IN ? D_OUT : D_IN;  // the width of 3, if any
  static constexpr int FLOATS = BLOCK_M * QS + BLOCK_M * GS           // K, U tiles
                                + BLOCK_N * QS + BLOCK_N * GS        // q, g tiles
                                + (WIDE_OUT ? BLOCK_N * PS : 0)      // A
                                + (WIDE_IN ? BLOCK_N * PS : 0)       // dS
                                + ((WIDE_IN && WIDE_OUT) ? 0 : 16 * BLOCK_M * NARROW);
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int D_IN, int D_OUT>
__global__ void __launch_bounds__(THREADS, 2)
stream_bwd_dku_kernel(const float* __restrict__ x, const float* __restrict__ K,
                      const float* __restrict__ U, const float* __restrict__ s,
                      const float* __restrict__ t, const float* __restrict__ g,
                      const float* __restrict__ m_in, const float* __restrict__ l_in,
                      const float* __restrict__ delta, float* __restrict__ dk_part,
                      float* __restrict__ du_part, int n, int m_patterns, int tiles_per_chunk,
                      float beta) {
  using L = Layout<D_IN, D_OUT>;
  constexpr int QS = L::QS;
  constexpr int GS = L::GS;
  constexpr int PS = L::PS;
  constexpr bool WIDE_IN = L::WIDE_IN;
  constexpr bool WIDE_OUT = L::WIDE_OUT;
  static_assert(!WIDE_IN || D_IN == 4 * 16, "a wide dK is 16 threads x 4 columns");
  static_assert(!WIDE_OUT || D_OUT == 4 * 16, "a wide dU is 16 threads x 4 columns");
  static_assert(WIDE_IN || WIDE_OUT, "one side is 64 wide");
  // accumulators: wide sides hold [pattern ty*4+i][column tx*4+c], narrow
  // sides [pattern tx+16*j][column c]
  constexpr int KW = WIDE_IN ? 4 : D_IN;
  constexpr int UW = WIDE_OUT ? 4 : D_OUT;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* u_s = k_s + BLOCK_M * QS;
  float* q_s = u_s + BLOCK_M * GS;
  float* g_s = q_s + BLOCK_N * QS;
  float* a_s = g_s + BLOCK_N * GS;                      // WIDE_OUT only
  float* d_s = a_s + (WIDE_OUT ? BLOCK_N * PS : 0);     // WIDE_IN only
  float* red_s = d_s + (WIDE_IN ? BLOCK_N * PS : 0);    // the narrow side's row groups

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int p0 = blockIdx.x * BLOCK_M;
  const int pats = min(BLOCK_M, m_patterns - p0);
  const int chunk = blockIdx.y;
  const int token_tiles = (n + BLOCK_N - 1) / BLOCK_N;
  const int tile_end = min(token_tiles, (chunk + 1) * tiles_per_chunk);

  stage_rows<D_IN, QS>(k_s, K, p0, pats);
  stage_rows<D_OUT, GS>(u_s, U, p0, pats);

  float ak[4][KW], au[4][UW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < KW; ++c) ak[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < UW; ++c) au[i][c] = 0.f;
  }

  for (int tile = chunk * tiles_per_chunk; tile < tile_end; ++tile) {
    const int row0 = tile * BLOCK_N;
    const int rows_here = min(BLOCK_N, n - row0);
    stage_rows<D_IN, QS>(q_s, x, row0, rows_here);
    stage_rows<D_OUT, GS>(g_s, g, row0, rows_here);
    __syncthreads();
    layer_norm_rows<D_IN, QS>(q_s, s, t, nullptr, nullptr);
    __syncthreads();

    float sc[4][4], da[4][4];
    tile_products<D_IN, QS>(q_s, k_s, ty, tx, sc);
    tile_products<D_OUT, GS>(g_s, u_s, ty, tx, da);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_live = r < rows_here;
      const float m_r = row_live ? m_in[row0 + r] : 0.f;
      const float il_r = row_live ? 1.f / l_in[row0 + r] : 0.f;
      const float dl_r = row_live ? delta[row0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        const float a = (row_live && p < pats) ? __expf(sc[i][j] * beta - m_r) * il_r : 0.f;
        const float dsv = a * (da[i][j] - dl_r) * beta;
        if constexpr (WIDE_OUT) {
          a_s[r * PS + p] = a;
        } else {
#pragma unroll
          for (int c = 0; c < D_OUT; ++c) au[j][c] = fmaf(a, g_s[r * GS + c], au[j][c]);
        }
        if constexpr (WIDE_IN) {
          d_s[r * PS + p] = dsv;
        } else {
#pragma unroll
          for (int c = 0; c < D_IN; ++c) ak[j][c] = fmaf(dsv, q_s[r * QS + c], ak[j][c]);
        }
      }
    }
    __syncthreads();

    // ---- the 64-wide sides: sum over this tile's tokens
#pragma unroll 4
    for (int r = 0; r < BLOCK_N; ++r) {
      if constexpr (WIDE_OUT) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + r * PS + ty * 4);
        const float4 gv = *reinterpret_cast<const float4*>(g_s + r * GS + tx * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          au[i][0] = fmaf(ar[i], gv.x, au[i][0]);
          au[i][1] = fmaf(ar[i], gv.y, au[i][1]);
          au[i][2] = fmaf(ar[i], gv.z, au[i][2]);
          au[i][3] = fmaf(ar[i], gv.w, au[i][3]);
        }
      }
      if constexpr (WIDE_IN) {
        const float4 dv = *reinterpret_cast<const float4*>(d_s + r * PS + ty * 4);
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * QS + tx * 4);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i][0] = fmaf(dr[i], qv.x, ak[i][0]);
          ak[i][1] = fmaf(dr[i], qv.y, ak[i][1]);
          ak[i][2] = fmaf(dr[i], qv.z, ak[i][2]);
          ak[i][3] = fmaf(dr[i], qv.w, ak[i][3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites q_s, g_s, a_s and d_s
  }

  // ---- this chunk's partial rows of dK and dU
  const size_t base = static_cast<size_t>(chunk) * m_patterns + p0;
  if constexpr (WIDE_IN) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ty * 4 + i < pats)
        *reinterpret_cast<float4*>(dk_part + (base + ty * 4 + i) * D_IN + tx * 4) =
            make_float4(ak[i][0], ak[i][1], ak[i][2], ak[i][3]);
  }
  if constexpr (WIDE_OUT) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ty * 4 + i < pats)
        *reinterpret_cast<float4*>(du_part + (base + ty * 4 + i) * D_OUT + tx * 4) =
            make_float4(au[i][0], au[i][1], au[i][2], au[i][3]);
  }
  if constexpr (!(WIDE_IN && WIDE_OUT)) {
    // the narrow side: each row group ty holds its tokens' share; sum the
    // 16 groups in order
    constexpr int NW = L::NARROW;
    float* part = WIDE_IN ? du_part : dk_part;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < NW; ++c)
        red_s[(ty * BLOCK_M + tx + 16 * j) * NW + c] = WIDE_IN ? au[j][c] : ak[j][c];
    __syncthreads();
    if (tid < BLOCK_M * NW) {
      const int p = tid / NW;
      float acc = 0.f;
      for (int grp = 0; grp < 16; ++grp) acc += red_s[(grp * BLOCK_M) * NW + tid];
      if (p < pats) part[base * NW + tid] = acc;
    }
  }
}

template <int D_IN, int D_OUT>
int launch(const float* x, const float* K, const float* U, const float* s, const float* t,
           const float* g, const float* m, const float* l, const float* delta, float* dK,
           float* dU, float* workspace, int n, int m_patterns, cudaStream_t stream) {
  using L = Layout<D_IN, D_OUT>;
  auto kernel = stream_bwd_dku_kernel<D_IN, D_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const int chunks = chunks_for(n, m_patterns);
  const int token_tiles = (n + BLOCK_N - 1) / BLOCK_N;
  const int tiles_per_chunk = (token_tiles + chunks - 1) / chunks;
  float* dk_part = workspace;
  float* du_part = workspace + static_cast<size_t>(chunks) * m_patterns * D_IN;
  const dim3 grid((m_patterns + BLOCK_M - 1) / BLOCK_M, chunks);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(x, K, U, s, t, g, m, l, delta, dk_part, du_part, n,
                                              m_patterns, tiles_per_chunk, beta_of(D_IN));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_rows(dk_part, chunks, m_patterns * D_IN, dK, stream);
  if (err != cudaSuccess) return err;
  return sum_rows(du_part, chunks, m_patterns * D_OUT, dU, stream);
}

}  // namespace

// Floats of device scratch that hopfield_stream_bwd_dku needs: one
// partial dK (m_patterns, d_in) and one partial dU (m_patterns, d_out) for
// each chunk of the token axis.
extern "C" long long hopfield_stream_bwd_dku_workspace(int n, int m_patterns, int d_in, int d_out) {
  if (n <= 0 || m_patterns <= 0) return 0;
  return static_cast<long long>(chunks_for(n, m_patterns)) * m_patterns * (d_in + d_out);
}

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), g (n, d_out), m, l and delta (n),
// dK (m_patterns, d_in), dU (m_patterns, d_out), and workspace (see
// above). Launches the kernel and the fixed-order sum of the chunks on
// `stream`. Returns a cudaError_t; 0 means every launch was accepted.
extern "C" int hopfield_stream_bwd_dku(const float* x, const float* K, const float* U,
                                       const float* s, const float* t, const float* g,
                                       const float* m, const float* l, const float* delta,
                                       float* dK, float* dU, float* workspace, int n,
                                       int m_patterns, int d_in, int d_out, void* stream) {
  if (n <= 0 || m_patterns <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_in == 64 && d_out == 64)
    return launch<64, 64>(x, K, U, s, t, g, m, l, delta, dK, dU, workspace, n, m_patterns, st);
  if (d_in == 64 && d_out == 3)
    return launch<64, 3>(x, K, U, s, t, g, m, l, delta, dK, dU, workspace, n, m_patterns, st);
  if (d_in == 3 && d_out == 64)
    return launch<3, 64>(x, K, U, s, t, g, m, l, delta, dK, dU, workspace, n, m_patterns, st);
  return cudaErrorInvalidValue;
}
