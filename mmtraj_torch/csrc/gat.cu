// The whole multi-head GAT layer as one Hopper kernel
// (mmtraj_torch/ops/fused_gat.py:fused_gat).
//
// Replaces mmtraj/ops/fused_gat.py:_fused_gat_fwd_impl (kernel _gat_kernel).
// Bound on the H100: operations.  Per graph it moves h, the attend tile and
// the output (about 50 KB at N = D = 64) but does about 1.8 MFLOP of f32 work:
// the value product (2 N D HD), the score products, the attend chain
// (2 N^2 HD) and the output product (2 N HD Dout).
// Design: one block per graph keeps every intermediate in shared memory.
// h is staged once, v = h wv and the head scores are computed from it, the
// attend chain (attend_row, shared with attend.cu and decoder.cu) writes the
// aggregate over h's buffer, and out = agg wo + bo goes straight to device
// memory.  Weights are read through the read-only cache; every graph reads
// the same few KB, so they stay in L2.  The products are per-thread f32 dot
// products, with consecutive threads on consecutive output columns.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gat_kernel(const float* __restrict__ h, const float* __restrict__ att,
           const float* __restrict__ wv, const float* __restrict__ a_src,
           const float* __restrict__ a_dst, const float* __restrict__ wo,
           const float* __restrict__ bo, float* __restrict__ out,
           int N, int D, int H, int HD, int Dout) {
  extern __shared__ float smem[];
  const int W = D > HD ? D : HD;
  float* sh = smem;          // (N, D) h, then (N, HD) the aggregate
  float* sv = sh + N * W;    // (N, HD)
  float* ss = sv + N * HD;   // (H, N)
  float* sd = ss + H * N;    // (H, N)
  float* scratch = sd + H * N;
  const size_t b = blockIdx.x;
  const int dh = HD / H;

  const float* hb = h + b * N * D;
  for (int k = threadIdx.x; k < N * D; k += kThreads) sh[k] = hb[k];
  __syncthreads();

  for (int k = threadIdx.x; k < N * HD; k += kThreads) {
    const int n = k / HD, c = k % HD;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(sh[n * D + d], __ldg(wv + d * HD + c), acc);
    sv[k] = acc;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < N * H; k += kThreads) {
    const int n = k / H, hh = k % H;
    float s1 = 0.f, s2 = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float x = sv[n * HD + hh * dh + d];
      s1 = fmaf(x, __ldg(a_src + hh * dh + d), s1);
      s2 = fmaf(x, __ldg(a_dst + hh * dh + d), s2);
    }
    ss[hh * N + n] = s1;
    sd[hh * N + n] = s2;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = scratch + warp * attend_scratch_floats(N, H);
  for (int i = warp; i < N; i += kWarps) {
    const float* arow = att + (b * N + i) * N;
    float a[kMaxJ];
#pragma unroll
    for (int t = 0; t < kMaxJ; ++t) {
      const int j = lane + 32 * t;
      a[t] = j < N ? arow[j] : 0.f;
    }
    attend_row(i, N, H, HD, a, ss, sd, sv, p, sh + i * HD);
  }
  __syncthreads();

  float* ob = out + b * N * Dout;
  for (int k = threadIdx.x; k < N * Dout; k += kThreads) {
    const int n = k / Dout, c = k % Dout;
    float acc = 0.f;
    for (int e = 0; e < HD; ++e) acc = fmaf(sh[n * HD + e], __ldg(wo + e * Dout + c), acc);
    ob[k] = acc + __ldg(bo + c);
  }
}

}  // namespace

// h (B, N, D), att (B, N, N) 0/1, wv (D, HD), a_src/a_dst (H, HD/H),
// wo (HD, Dout), bo (Dout) -> out (B, N, Dout); all float32, contiguous.
extern "C" int mmtraj_gat(const float* h, const float* att, const float* wv,
                          const float* a_src, const float* a_dst, const float* wo,
                          const float* bo, float* out, int B, int N, int D, int H, int HD,
                          int Dout, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || D <= 0 || H <= 0 || HD <= 0 || HD % H || Dout <= 0)
    return cudaErrorInvalidValue;
  const int W = D > HD ? D : HD;
  const size_t smem = sizeof(float) * (size_t(N) * W + size_t(N) * HD + 2 * H * N +
                                       kWarps * attend_scratch_floats(N, H));
  cudaError_t err = allow_shared_memory(gat_kernel, smem);
  if (err != cudaSuccess) return err;
  gat_kernel<<<B, kThreads, smem, stream>>>(h, att, wv, a_src, a_dst, wo, bo, out, N, D, H,
                                            HD, Dout);
  return cudaGetLastError();
}
