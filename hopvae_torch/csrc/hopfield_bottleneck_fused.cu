// Single-shot fused Hopfield bottleneck, forward (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of hopvae_tpu/ops/hopfield_pallas.py
// (launched by `_bottleneck_fwd_pallas`). For a token matrix x (N, d) and
// the folded tables (K_i, U_i, b_i) and state LayerNorms (s_i, t_i) of the
// three lookups, it computes per token row
//
//     e  = softmax(beta   * LN_1(x)  K_1^T) U_1 + b_1             d -> d
//     zq = rint(sigmoid(softmax(beta * LN_2(e) K_2^T) U_2 + b_2) * (L - 1))
//                                                                 d -> di
//     r  = softmax(beta_i * LN_3(zq / (L - 1)) K_3^T) U_3 + b_3   di -> d
//
// with beta = 1/sqrt(d), beta_i = 1/sqrt(di), and writes e, zq and r. The
// round is half to even (rintf), as jnp.round and torch.round are.
//
// What bounds it on an H100: the tensor cores. It does 2*N*M*(2d + 2(d +
// di)) FLOPs, every product as mma.sync m16n8k8 on TF32 operands in three
// passes (mma_tf32.cuh), and 3*N*M exps, and must move only x, the outputs
// and the six tables: at N = 73,984, M = 4096, d = 64, di = 3, 0.962 ms at
// 495 / 3 TFLOP/s (2.37 ms at the f32 peak of the CUDA cores), against
// about 58 MB of memory traffic.
//
// What it cannot copy from the TPU: the TPU kernel keeps all three
// tables resident in VMEM next to a block of 256 tokens. At M = 4096,
// K_1 and U_1 alone are 1 MiB each, against 227 KB of shared memory a
// block. So here a block owns a tile of 64 tokens and runs K1's pattern
// walk (hopfield_stream_fwd.cuh) three times: over lookup 1's tiles, then,
// with e kept in shared memory and normalized there, over lookup 2's, then
// after the sigmoid and the round over lookup 3's. Neither e, the logits
// nor the scores go to device memory between the stages (e is written
// once, as an output).
//
// Design:
// - Each stage is K1's walk over the block's tokens, with K1's arithmetic:
//   the state LayerNorm in double, rounded once (hopfield_stream.cuh), the
//   three-pass products, the online softmax on the fragments, out = acc /
//   l. So e, zq and r agree with three K1 launches that leave the pattern
//   axis whole, and with the elementwise steps between them.
// - Two query tiles of 64 rows: the first holds LN_1(x), then zq / (L - 1)
//   and LN_3 of it; the second e, then LN_2(e). Past 128 output columns a
//   stage runs two windows of 128 one after the other, each recomputing
//   the scores (hopfield_stream_fwd.cuh).
// - Widths: the lookups chain as (d, d), (d, di), (di, d), any d and di
//   from 1 to 256, padded with zeros in shared memory: d to the next of
//   32, 64, 128, 256 and di to 8 or 256 (8 instances: each holds three
//   walks, and more of them lengthened the build); the LayerNorms and the
//   betas use the real widths. Rows past N are zero-filled and never
//   written; patterns past each M are masked.
// - No float atomics: every output has the same bits in every run.
//
// Shared bytes: 512 (max(d', di') + 4) for the two query tiles and the
// widest stage's two buffers of a K tile and its U window: 104,448 at
// d = 64, di = 3.
//
// Past 256 (d or di; hopfield_bottleneck_fused_wide, the widths at run
// time) a block's e, or its query tiles, no longer fit beside the
// buffers, so each stage runs as K1's wide route, a launch of its own, e
// and zq / (L - 1) going through device memory (e and zq are outputs
// anyway): the query build, then the stage's kernel (the cluster of
// hopfield_cluster.cuh where the stage's d_in and d_out pass 128, else
// the narrow-side kernel of hopfield_narrow.cuh on its plan) with the
// shift for e,
// again with the sigmoid and the round for zq, again with the shift for
// r. Six launches of one call, the arithmetic of each step as above.

#include "hopfield_cluster.cuh"
#include "hopfield_narrow.cuh"
#include "hopfield_stream_fwd.cuh"
#include "hopfield_wide.cuh"

namespace {

using namespace hopfield_stream;
using namespace hopfield_fwd;
using namespace tf32x3;

struct Table {
  const float* K;  // (m, d_in)
  const float* U;  // (m, d_out)
  const float* b;  // (d_out)
  const float* s;  // (d_in), the state LayerNorm's scale
  const float* t;  // (d_in), and shift
  int m;
};

template <int a, int b>
__host__ __device__ constexpr int max_of() { return a > b ? a : b; }

template <int PD, int PDI>
struct Tiles {
  static constexpr int AS = max_of<PD, PDI>() + 4;  // row stride of the query tiles
  using W1 = Walk<PD, window<PD>()>;                 // e = lookup 1 (LN_1(x))
  using W2 = Walk<PD, window<PDI>()>;                // logits = lookup 2 (LN_2(e))
  using W3 = Walk<PDI, window<PD>()>;                // r = lookup 3 (LN_3(zn))
  static constexpr int BUF = 2 * max_of<max_of<W1::BUF, W2::BUF>(), W3::BUF>();
  static constexpr size_t BYTES = sizeof(float) * (2 * TM * AS + BUF);
};

// Each window of CW columns of one stage: the walk over the table, then
// epi(row, col, acc / l) for the warp's rows
// (block-local) and columns col0 + 8c + 2tq (+ 1) of the window.
template <int PI, int PO, typename Epilogue>
__device__ __forceinline__ void stage(const float* q_s, float* buf, const Table& tab, int d_in, int d_out,
                                      float beta, bool k16, bool u16, Epilogue&& epi) {
  constexpr int CW = window<PO>();
  using W = Walk<PI, CW>;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
#pragma unroll 1
  for (int col0 = 0; col0 < PO; col0 += CW) {
    float acc[W::CO][4], m_r[2], l_r[2];
    walk<PI, CW>(q_s, buf, tab.K, tab.U, tab.m, d_in, d_out, col0, beta, k16, u16, acc, m_r, l_r);
    quad_denominators(l_r);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < W::CO; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) epi(m0 + gq + 8 * e, col0 + 8 * c + 2 * tq + h, acc[c][2 * e + h] / l_r[e]);
  }
}

template <int PD, int PDI>
__global__ void __launch_bounds__(THREADS)
bottleneck_fused_kernel(const float* __restrict__ x, Table t1, Table t2, Table t3, float* __restrict__ e_out,
                        float* __restrict__ zq_out, float* __restrict__ r_out, int n, int d, int di, float beta,
                        float beta_i, float levels, unsigned vec16) {
  using C = Tiles<PD, PDI>;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // LN_1(x), then zn and LN_3(zn)
  float* b_s = a_s + TM * C::AS;                 // e, then LN_2(e)
  float* buf = b_s + TM * C::AS;
  const int row0 = blockIdx.x * TM;
  auto flag = [&](int i) { return static_cast<bool>(vec16 >> i & 1u); };

  // ---- lookup 1: e = softmax(beta LN_1(x) K_1^T) U_1 + b_1; zeros past d
  load_queries<PD>(a_s, x, t1.s, t1.t, d, row0, n, flag(0));
  stage<PD, PD>(a_s, buf, t1, d, d, beta, flag(1), flag(2), [&](int r, int col, float v) {
    const float ev = col < d ? v + t1.b[col] : 0.f;
    b_s[r * (PD + 4) + col] = ev;
    if (row0 + r < n && col < d) e_out[static_cast<size_t>(row0 + r) * d + col] = ev;
  });
  __syncthreads();
  layer_norm_rows<TM, PD + 4, THREADS>(b_s, d, t2.s, t2.t);
  __syncthreads();

  // ---- lookup 2 and the quantizer: zq = rint(sigmoid(logits) (L - 1)),
  // zn = zq / (L - 1) the third lookup's input; zeros past di
  stage<PD, PDI>(b_s, buf, t2, d, di, beta, flag(3), flag(4), [&](int r, int col, float v) {
    const float zq = rintf(1.f / (1.f + expf(-(v + (col < di ? t2.b[col] : 0.f)))) * levels);
    a_s[r * (PDI + 4) + col] = col < di ? zq / levels : 0.f;
    if (row0 + r < n && col < di) zq_out[static_cast<size_t>(row0 + r) * di + col] = zq;
  });
  __syncthreads();
  layer_norm_rows<TM, PDI + 4, THREADS>(a_s, di, t3.s, t3.t);
  __syncthreads();

  // ---- lookup 3: r = softmax(beta_i LN_3(zn) K_3^T) U_3 + b_3
  stage<PDI, PD>(a_s, buf, t3, di, d, beta_i, flag(5), flag(6), [&](int r, int col, float v) {
    if (row0 + r < n && col < d) r_out[static_cast<size_t>(row0 + r) * d + col] = v + t3.b[col];
  });
}

// the padded width of d: the next of 32, 64, 128, 256
inline int fused_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// f(pd, pdi) with the instance's padded widths as integral constants; di
// pads to 8 or 256
template <int PD, typename F>
int with_index_width(int di, F&& f) {
  if (di <= 8) return f(std::integral_constant<int, PD>{}, std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, PD>{}, std::integral_constant<int, 256>{});
}

template <typename F>
int with_fused_widths(int d, int di, F&& f) {
  switch (fused_width(d)) {
    case 32: return with_index_width<32>(di, f);
    case 64: return with_index_width<64>(di, f);
    case 128: return with_index_width<128>(di, f);
    default: return with_index_width<256>(di, f);
  }
}

bool fused_takes(int d, int di) { return d >= 1 && d <= MAX_WIDTH && di >= 1 && di <= MAX_WIDTH; }

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d); for lookup i the folded
// K_i (m_i, d_in), U_i (m_i, d_out), the shift b_i (d_out) and the state
// LayerNorm's s_i, t_i (d_in), with (d_in, d_out) = (d, d), (d, di) and
// (di, d); the outputs e (n, d), zq (n, di) and r (n, d); 1 <= d, di <=
// 256 (wider: hopfield_bottleneck_fused_wide). Returns a cudaError_t; 0
// means the launch was accepted.
extern "C" int hopfield_bottleneck_fused(const float* x, const float* k1, const float* u1, const float* b1,
                                         const float* s1, const float* t1, const float* k2, const float* u2,
                                         const float* b2, const float* s2, const float* t2, const float* k3,
                                         const float* u3, const float* b3, const float* s3, const float* t3,
                                         float* e, float* zq, float* r, int n, int m1, int m2, int m3, int d, int di,
                                         int num_levels, void* stream) {
  if (n <= 0 || m1 <= 0 || m2 <= 0 || m3 <= 0 || num_levels < 2 || !fused_takes(d, di))
    return cudaErrorInvalidValue;
  const Table l1{k1, u1, b1, s1, t1, m1}, l2{k2, u2, b2, s2, t2, m2}, l3{k3, u3, b3, s3, t3, m3};
  const unsigned vec16 = vec16_ok(x, d) | vec16_ok(k1, d) << 1 | vec16_ok(u1, d) << 2 | vec16_ok(k2, d) << 3 |
                         vec16_ok(u2, di) << 4 | vec16_ok(k3, di) << 5 | vec16_ok(u3, d) << 6;
  return with_fused_widths(d, di, [&](auto pd, auto pdi) {
    constexpr int PD = decltype(pd)::value, PDI = decltype(pdi)::value;
    using C = Tiles<PD, PDI>;
    auto kernel = bottleneck_fused_kernel<PD, PDI>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(C::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(n + TM - 1) / TM, THREADS, C::BYTES, static_cast<cudaStream_t>(stream)>>>(
        x, l1, l2, l3, e, zq, r, n, d, di, beta_of(d), beta_of(di), static_cast<float>(num_levels - 1), vec16);
    return static_cast<int>(cudaGetLastError());
  });
}

// The kernel built for (d, di) as the card reports it: out receives
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// threads a block, blocks an SM, TM and the first stage's TN; past 256
// the first stage's, (d, d): the cluster kernel where it runs
// (hopfield_cluster::plan), else the narrow-side kernel. Returns a
// cudaError_t.
extern "C" int hopfield_bottleneck_fused_attributes(int d, int di, int* out) {
  int j, ranks;
  if (d >= 1 && di >= 1 && hopfield_wide::wide(d, di)) {
    if (hopfield_cluster::plan(d, d, j, ranks))
      return static_cast<int>(hopfield_cluster::fwd_cluster_build<hopfield_wide::SHIFT>(d, d, true, out));
    return static_cast<int>(hopfield_narrow::fwd_window_attributes<hopfield_wide::SHIFT>(d, out));
  }
  if (!fused_takes(d, di)) return cudaErrorInvalidValue;
  return with_fused_widths(d, di, [&](auto pd, auto pdi) {
    constexpr int PD = decltype(pd)::value, PDI = decltype(pdi)::value;
    using C = Tiles<PD, PDI>;
    return static_cast<int>(
        kernel_attributes(bottleneck_fused_kernel<PD, PDI>, THREADS, C::BYTES, TM, C::W1::TN, out));
  });
}

// The cluster kernel of a wide stage of widths (d_in, d_out) where it runs
// (hopfield_cluster::plan; else cudaErrorInvalidValue): out receives
// the blocks of a cluster, the slice width at most, and the clusters the
// card can hold at once (0: it cannot launch). Returns a cudaError_t.
extern "C" int hopfield_bottleneck_fused_cluster(int d_in, int d_out, int* out) {
  if (d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  return static_cast<int>(hopfield_cluster::fwd_cluster_build<hopfield_wide::SHIFT>(d_in, d_out, false, out));
}

// Floats of device scratch that hopfield_bottleneck_fused_wide needs: one
// stage's queries (n, max(d, di)) and zq / (L - 1) (n, di), then the most
// that a stage's split scores or a slab of its score pass take
// (hopfield_narrow::fwd_split_floats; the stages run one after the other).
extern "C" long long hopfield_bottleneck_fused_wide_workspace(int n, int m1, int m2, int m3, int d, int di) {
  if (n <= 0 || m1 <= 0 || m2 <= 0 || m3 <= 0 || d < 1 || di < 1) return 0;
  using hopfield_narrow::fwd_split_floats;
  const long long split = std::max({fwd_split_floats(n, m1, d, d), fwd_split_floats(n, m2, d, di),
                                    fwd_split_floats(n, m3, di, d)});
  return static_cast<long long>(n) * ((d > di ? d : di) + di) + split;
}

// The same as hopfield_bottleneck_fused past 256, with workspace as
// above: each stage's query build, then the stage through
// hopfield_narrow::launch_fwd (the route of K1's wide forward: the cluster
// kernel where the stage's widths both pass 128, up to 8192, else the
// narrow-side kernel on its plan) with the shift for e, the sigmoid and
// the round for zq, the shift for r. Launches on `stream`.
extern "C" int hopfield_bottleneck_fused_wide(const float* x, const float* k1, const float* u1, const float* b1,
                                              const float* s1, const float* t1, const float* k2, const float* u2,
                                              const float* b2, const float* s2, const float* t2, const float* k3,
                                              const float* u3, const float* b3, const float* s3, const float* t3,
                                              float* e, float* zq, float* r, float* workspace, int n, int m1, int m2,
                                              int m3, int d, int di, int num_levels, void* stream) {
  using namespace hopfield_wide;
  using hopfield_narrow::launch_fwd;
  if (n <= 0 || m1 <= 0 || m2 <= 0 || m3 <= 0 || num_levels < 2 || d < 1 || di < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float levels = static_cast<float>(num_levels - 1);
  float* q = workspace;
  float* zn = workspace + static_cast<size_t>(n) * (d > di ? d : di);
  float* split = zn + static_cast<size_t>(n) * di;
  float* none = nullptr;  // the stages write no row stats
  cudaError_t err = build_queries(x, s1, t1, n, d, q, nullptr, nullptr, st);
  if (err == cudaSuccess)
    err = launch_fwd<SHIFT>(q, k1, u1, b1, e, none, none, none, split, n, m1, d, d, beta_of(d), levels, st);
  if (err == cudaSuccess) err = build_queries(e, s2, t2, n, d, q, nullptr, nullptr, st);
  if (err == cudaSuccess)
    err = launch_fwd<QUANTIZE>(q, k2, u2, b2, zq, none, none, zn, split, n, m2, d, di, beta_of(d), levels, st);
  if (err == cudaSuccess) err = build_queries(zn, s3, t3, n, di, q, nullptr, nullptr, st);
  if (err == cudaSuccess)
    err = launch_fwd<SHIFT>(q, k3, u3, b3, r, none, none, none, split, n, m3, di, d, beta_of(di), levels, st);
  return static_cast<int>(err);
}
