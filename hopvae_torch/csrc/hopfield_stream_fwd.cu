// Streaming modern-Hopfield lookup, forward (K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stream_fwd_kernel` of
// hopvae_tpu/ops/hopfield_pallas.py (launched by `_attn_call_fwd`). For
// a token matrix x (N, d_in) and the folded pattern tables K (M, d_in),
// U (M, d_out) it computes, per token row,
//
//     q   = LN(x) * s + t                 LayerNorm over the real d_in
//     sc  = beta * q K^T,  beta = 1/sqrt(d_in)
//     m   = max_j sc_j,   l = sum_j exp(sc_j - m)
//     out = sum_j exp(sc_j - m) U_j / l
//
// and writes out, m and l (the row stats are what the backward kernels
// and a pattern-sharded log-sum-exp merge reuse). The caller adds the
// output shift b.
//
// What bounds it on an H100: the tensor cores. It does two products,
// 2*N*M*(d_in + d_out) FLOPs, each as mma.sync m16n8k8 on TF32 operands
// in three passes (mma_tf32.cuh), so the ceiling is 495 / 3 = 165
// TFLOP/s: at N = 73,984 and M = 4096, 0.470 ms for 64 -> 64 and 0.246 ms
// each for 64 -> 3 and 3 -> 64 (their narrow side counted at its real
// width), 0.962 ms a step of the three; against N*M exps (0.07 ms a
// lookup on the SFUs) and about 40 MB of memory traffic. f32 grade is
// required: K2 and K3 rebuild the attention from this kernel's m and l,
// and one TF32 pass would move them by 25 to 170 times the 1e-5 the port
// holds them to (tests/test_torch_hopfield_tf32.py emulates both).
//
// Design (the walk is hopfield_stream_fwd.cuh, shared with K4):
// - Widths: any d_in, d_out from 1 to 256, padded with zeros in shared
//   memory (never in device memory) to a built instance (hopfield_stream.cuh,
//   with_widths: 8 to 128 each side; 256 with 8 or 256); the LayerNorm's
//   mean and variance, and beta, use the real width. d_in 3 is one 8-deep
//   k step; d_out 3 one 8-wide n tile.
// - One block of 4 warps owns 64 token rows and loads them once: x by
//   cp.async, then the state LayerNorm in double over the real width,
//   rounded once (hopfield_stream.cuh, as K2 and K3 build q). It walks
//   every pattern tile as the shared walk does; rows past N and patterns
//   past M are masked here, the caller pads nothing.
// - At d_out 256 two column windows of 128 are blocks of their own, each
//   recomputing the scores (m and l come from the first, the same bits in
//   both).
// - Grid: a block per 64 tokens and window, each walking every pattern
//   tile. Splitting the pattern axis over two blocks, its partial outputs
//   and row stats merged by a second kernel as K2 does, ran 3.5% slower at
//   64 -> 64 with N = 73,984 on an H100 (PERF.md): it doubles each
//   token's LayerNorm and the pipeline's fill. No float atomics: every
//   output has the same bits in every run.
//
// Shared bytes: 256 (d_in' + 4) for the queries and 2 TN (d_in' + c + 8) * 4
// for two buffers of a K tile and its U window of c = min(d_out', 128)
// columns (TN 64 up to widths of 64, else 32, or 16 past a sum of 256):
// 87,040 at 64 -> 64. Registers and blocks an SM per width are in PERF.md,
// from hopfield_stream_fwd_attributes on the card.
//
// Past 256 on either side (hopfield_stream_fwd_wide, the widths at run
// time): q is built first into the scratch, then, where d_in and d_out
// both pass 128, up to 8192 on the wider side, the cluster kernel of
// hopfield_cluster.cuh (stream_fwd_cluster_kernel): the depth split
// across the blocks of a thread-block cluster, each tile's scores
// computed once; elsewhere the narrow-side kernel of hopfield_narrow.cuh
// (the window sized to d_out, the depth in parts of 64 summed in K2's and
// K3's order, and, where few token tiles would leave the card idle, the
// scores split over the card first, or past the split's cap computed by a
// score pass slab after slab of token tiles within 64 MiB: a plan from N,
// M, the widths and the SMs). A refused launch returns its error. The
// cluster is bound by latency (about 6 us a tile of 32 patterns at 512 ->
// 512 on an H100; PERF.md).

#include "hopfield_cluster.cuh"
#include "hopfield_narrow.cuh"
#include "hopfield_stream_fwd.cuh"
#include "hopfield_wide.cuh"

namespace {

using namespace hopfield_stream;
using namespace hopfield_fwd;
using namespace tf32x3;

template <int PI, int PO>
struct Tiles {
  static constexpr int CW = window<PO>();
  static constexpr int WINDOWS = PO / CW;
  using W = Walk<PI, CW>;
  static constexpr size_t BYTES = sizeof(float) * (TM * W::QS + 2 * W::BUF);
};

template <int PI, int PO>
__global__ void __launch_bounds__(THREADS)
stream_fwd_kernel(const float* __restrict__ x, const float* __restrict__ K, const float* __restrict__ U,
                  const float* __restrict__ s, const float* __restrict__ t, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int n, int m_patterns, int d_in,
                  int d_out, float beta, unsigned vec16) {
  using C = Tiles<PI, PO>;
  using W = typename C::W;
  constexpr int CO = W::CO;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* buf = q_s + TM * W::QS;

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * C::CW;

  load_queries<PI>(q_s, x, s, t, d_in, row0, n, vec16 & 1u);
  float acc[CO][4], m_r[2], l_r[2];
  walk<PI, C::CW>(q_s, buf, K, U, m_patterns, d_in, d_out, col0, beta, vec16 >> 1 & 1u, vec16 >> 2 & 1u, acc,
                  m_r, l_r);
  quad_denominators(l_r);

  // ---- out = acc / l at the window's columns < d_out, and the row stats
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + m0 + gq + 8 * e;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c + 2 * tq + h;
        if (col < d_out) out[static_cast<size_t>(row) * d_out + col] = acc[c][2 * e + h] / l_r[e];
      }
    if (blockIdx.y == 0 && tq == 0) {
      m_out[row] = m_r[e];
      l_out[row] = l_r[e];
    }
  }
}

struct Args {
  const float *x, *K, *U, *s, *t;
  float *out, *m, *l;
  int n, m_patterns, d_in, d_out;
  cudaStream_t stream;
};

template <int PI, int PO>
int launch(const Args& a) {
  using C = Tiles<PI, PO>;
  auto kernel = stream_fwd_kernel<PI, PO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::BYTES));
  if (err != cudaSuccess) return err;
  const unsigned vec16 = vec16_ok(a.x, a.d_in) | vec16_ok(a.K, a.d_in) << 1 | vec16_ok(a.U, a.d_out) << 2;
  kernel<<<dim3((a.n + TM - 1) / TM, C::WINDOWS), THREADS, C::BYTES, a.stream>>>(
      a.x, a.K, a.U, a.s, a.t, a.out, a.m, a.l, a.n, a.m_patterns, a.d_in, a.d_out, beta_of(a.d_in), vec16);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous f32 arrays: x (n, d_in), K (m_patterns, d_in),
// U (m_patterns, d_out), s and t (d_in), out (n, d_out), m and l (n);
// 1 <= d_in, d_out <= 256 (wider: hopfield_stream_fwd_wide). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int hopfield_stream_fwd(const float* x, const float* K, const float* U, const float* s, const float* t,
                                   float* out, float* m, float* l, int n, int m_patterns, int d_in, int d_out,
                                   void* stream) {
  if (!takes(n, m_patterns, d_in, d_out)) return cudaErrorInvalidValue;
  const Args a{x, K, U, s, t, out, m, l, n, m_patterns, d_in, d_out, static_cast<cudaStream_t>(stream)};
  return with_widths(d_in, d_out, [&](auto pi, auto po) { return launch<decltype(pi)::value, decltype(po)::value>(a); });
}

// Floats of device scratch that hopfield_stream_fwd_wide needs: q (n,
// d_in), then the split scores' or a slab's S where the narrow-side plan
// takes either route.
extern "C" long long hopfield_stream_fwd_workspace(int n, int m_patterns, int d_in, int d_out) {
  if (n <= 0 || m_patterns <= 0 || d_in < 1 || d_out < 1) return 0;
  return static_cast<long long>(n) * d_in + hopfield_narrow::fwd_split_floats(n, m_patterns, d_in, d_out);
}

// The same past 256, with workspace as above: the query build, then the
// cluster kernel where both widths pass 128 up to 8192, else the
// narrow-side kernel on its plan (hopfield_narrow::launch_fwd). Launches
// on `stream`.
extern "C" int hopfield_stream_fwd_wide(const float* x, const float* K, const float* U, const float* s,
                                        const float* t, float* out, float* m, float* l, float* workspace, int n,
                                        int m_patterns, int d_in, int d_out, void* stream) {
  if (n <= 0 || m_patterns <= 0 || d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = hopfield_wide::build_queries(x, s, t, n, d_in, workspace, nullptr, nullptr, st);
  if (err != cudaSuccess) return err;
  return hopfield_narrow::launch_fwd<hopfield_wide::PLAIN>(workspace, K, U, nullptr, out, m, l, nullptr,
                                                           workspace + static_cast<size_t>(n) * d_in, n, m_patterns,
                                                           d_in, d_out, beta_of(d_in), 0.f, st);
}

// The kernel built for (d_in, d_out) as the card reports it: out receives
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// threads a block, blocks an SM, TM and TN; past 256 the cluster kernel's
// where it runs (hopfield_cluster::plan), else the narrow-side
// kernel's. Returns a cudaError_t.
extern "C" int hopfield_stream_fwd_attributes(int d_in, int d_out, int* out) {
  if (d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  int j, ranks;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks))
    return static_cast<int>(hopfield_cluster::fwd_cluster_build<hopfield_wide::PLAIN>(d_in, d_out, true, out));
  if (hopfield_wide::wide(d_in, d_out))
    return static_cast<int>(hopfield_narrow::fwd_window_attributes<hopfield_wide::PLAIN>(d_out, out));
  return with_widths(d_in, d_out, [&](auto pi, auto po) {
    constexpr int PI = decltype(pi)::value, PO = decltype(po)::value;
    using C = Tiles<PI, PO>;
    return static_cast<int>(kernel_attributes(stream_fwd_kernel<PI, PO>, THREADS, C::BYTES, TM, C::W::TN, out));
  });
}

// The cluster kernel of (d_in, d_out) where it runs
// (hopfield_cluster::plan; else cudaErrorInvalidValue): out receives
// the blocks of a cluster, the slice width at most, and the clusters the
// card can hold at once (0: it cannot launch). Returns a cudaError_t.
extern "C" int hopfield_stream_fwd_cluster(int d_in, int d_out, int* out) {
  if (d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  return static_cast<int>(hopfield_cluster::fwd_cluster_build<hopfield_wide::PLAIN>(d_in, d_out, false, out));
}

// The route of (n, m_patterns, d_in, d_out), into out[0..7]: 0 a built
// instance (both widths up to 256), 1 the cluster, 2 the narrow-side
// kernel, 3 the same on split scores, 6 the same on S from the score pass
// in slabs (hopfield_narrow::FwdRoute); then, from 2, its window, the
// parts of a group of its order and whether the small parts are
// truncated; for 6 the slabs, the token tiles of a slab and the pattern
// tiles a block of the score pass; for 3 and 6 the scratch in floats past
// q (the card's SMs from the current device). Returns a cudaError_t.
extern "C" int hopfield_stream_fwd_plan(int n, int m_patterns, int d_in, int d_out, int* out) {
  if (n <= 0 || m_patterns <= 0 || d_in < 1 || d_out < 1) return cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i) out[i] = 0;
  int j, ranks;
  if (!hopfield_wide::wide(d_in, d_out)) return cudaSuccess;
  out[0] = 1;
  if (hopfield_cluster::plan(d_in, d_out, j, ranks)) return cudaSuccess;
  const hopfield_narrow::FwdPlan p =
      hopfield_narrow::fwd_window_plan(n, m_patterns, d_in, d_out, hopfield_narrow::sm_count());
  out[0] = p.route;
  out[1] = p.cw;
  out[2] = p.order.group;
  out[3] = p.order.trunc;
  if (p.route == hopfield_narrow::SLABS) {
    out[4] = p.slabs.slabs;
    out[5] = p.slabs.slab;
    out[6] = p.per;
  }
  out[7] = static_cast<int>(hopfield_narrow::fwd_split_floats(n, m_patterns, d_in, d_out));
  return cudaSuccess;
}
