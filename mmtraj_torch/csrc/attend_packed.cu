// The GAT attend chain, two graphs a warp (mmtraj_torch/ops/fused_attend.py:
// attend(..., packed=True), wrapper attend_packed).
//
// Replaces mmtraj/ops/fused_attend.py:_attend_pallas_fwd with packed=True
// (kernel _attend_kernel_packed), which packs two graphs side by side into
// the TPU's 128 lanes and splits each row's max and sum with masked dual
// reductions.  It computes attend.cu's function, and is bound the same way
// on the H100: by bytes (each input read once, the output written once).
// The Hopper form of the packing: one block takes a pair of graphs (a, b),
// each warp takes row i of both, lanes 0-15 on graph a and lanes 16-31 on
// graph b.  Each half-warp holds its row of the attend tile in registers
// (N / 16 entries a lane, so N <= 256), reduces its own row max and sum with
// half-warp shuffles (the dual reductions), and writes its own row's HD
// columns.  The second graph's buffers in shared memory start 16 floats
// further on, so the two halves read distinct banks.  An odd B gives the
// last block one graph: its second half runs on zeros (attend tile 0, so
// every logit is masked and the weights are 0) and stores into a shared
// sink, never to device memory.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = 16;  // lanes a graph
constexpr int kPad = 16;   // floats between the two graphs' buffers

struct Layout {
  int v, s, p;  // stride between graph a's and graph b's buffers
  __host__ __device__ Layout(int N, int H, int HD)
      : v(N * HD + kPad), s(H * N + kPad), p(attend_scratch_floats(N, H) + kPad) {}
  // v x2, s_src x2, s_dst x2, scratch for each half of each warp, a sink row a warp.
  __host__ __device__ size_t floats(int HD) const {
    return 2 * size_t(v) + 4 * size_t(s) + 2 * kWarps * size_t(p) + kWarps * size_t(HD);
  }
};

__global__ void __launch_bounds__(kThreads)
attend_packed_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
                     const float* __restrict__ s_dst, const float* __restrict__ att,
                     float* __restrict__ out, int B, int N, int H, int HD) {
  extern __shared__ float smem[];
  const Layout L(N, H, HD);
  float* sv = smem;                   // 2 x (N, HD)
  float* ss = sv + 2 * L.v;           // 2 x (H, N)
  float* sd = ss + 2 * L.s;           // 2 x (H, N)
  float* scratch = sd + 2 * L.s;      // kWarps x 2 x attend_scratch_floats
  float* sink = scratch + 2 * kWarps * L.p;  // kWarps x HD
  const size_t g0 = 2 * size_t(blockIdx.x);
  const int ng = B - g0 < 2 ? 1 : 2;  // graphs in this block
  const int nv = N * HD, ns = N * H;
  for (int k = threadIdx.x; k < 2 * nv; k += kThreads) {
    const int gi = k / nv, r = k - gi * nv;
    sv[gi * L.v + r] = gi < ng ? v[(g0 + gi) * nv + r] : 0.f;
  }
  for (int k = threadIdx.x; k < 2 * ns; k += kThreads) {
    const int gi = k / ns, r = k - gi * ns;
    const int n = r / H, h = r % H;
    const size_t src = (g0 + gi) * ns + r;
    ss[gi * L.s + h * N + n] = gi < ng ? s_src[src] : 0.f;
    sd[gi * L.s + h * N + n] = gi < ng ? s_dst[src] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane / kHalf, hl = lane % kHalf;
  const bool real = gi < ng;
  const size_t g = g0 + gi;
  float* p = scratch + (2 * warp + gi) * L.p;
  for (int i = warp; i < N; i += kWarps) {
    float a[kMaxN / kHalf];
#pragma unroll
    for (int t = 0; t < kMaxN / kHalf; ++t) {
      const int j = hl + kHalf * t;
      a[t] = real && j < N ? att[(g * N + i) * N + j] : 0.f;
    }
    float* dst = real ? out + (g * N + i) * HD : sink + warp * HD;
    attend_row_lanes<kHalf>(i, N, H, HD, a, ss + gi * L.s, sd + gi * L.s, sv + gi * L.v, p,
                            dst);
  }
}

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD);
// all float32, contiguous, on the device of `stream`.
extern "C" int mmtraj_attend_packed(const float* v, const float* s_src, const float* s_dst,
                                    const float* att, float* out, int B, int N, int H, int HD,
                                    cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * Layout(N, H, HD).floats(HD);
  cudaError_t err = allow_shared_memory(attend_packed_kernel, smem);
  if (err != cudaSuccess) return err;
  attend_packed_kernel<<<(B + 1) / 2, kThreads, smem, stream>>>(v, s_src, s_dst, att, out, B,
                                                                N, H, HD);
  return cudaGetLastError();
}

// Occupancy of a launch at (N, H, HD): see kernel_occupancy.
extern "C" int mmtraj_attend_packed_occupancy(int N, int H, int HD, int* info) {
  return kernel_occupancy(attend_packed_kernel, kThreads,
                          sizeof(float) * Layout(N, H, HD).floats(HD), info);
}
