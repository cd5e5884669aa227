// The GAT attend chain as one Hopper kernel (mmtraj_torch/ops/fused_attend.py:attend).
//
// Replaces mmtraj/ops/fused_attend.py:_attend_pallas_fwd (kernel _attend_kernel).
// Bound on the H100: bytes.  Per graph it reads v (N, HD), the two score
// vectors (N, H) and the 0/1 attend tile (N, N) and writes (N, HD); the f32
// work is about 2 N^2 HD FLOP, under the card's ratio of operations to bytes.
// Design: one block per graph reads each input once.  v and the scores go to
// shared memory (scores head-major, so a warp reads them without bank
// conflicts); one warp per row loads that row of the attend tile into
// registers once and runs attend_row for all heads, writing the output row
// straight to device memory with consecutive lanes on consecutive columns.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
              const float* __restrict__ s_dst, const float* __restrict__ att,
              float* __restrict__ out, int N, int H, int HD) {
  extern __shared__ float smem[];
  float* sv = smem;           // (N, HD)
  float* ss = sv + N * HD;    // (H, N)
  float* sd = ss + H * N;     // (H, N)
  float* scratch = sd + H * N;
  const size_t b = blockIdx.x;
  const float* vb = v + b * N * HD;
  for (int k = threadIdx.x; k < N * HD; k += kThreads) sv[k] = vb[k];
  const float* sb = s_src + b * N * H;
  const float* db = s_dst + b * N * H;
  for (int k = threadIdx.x; k < N * H; k += kThreads) {
    const int n = k / H, h = k % H;
    ss[h * N + n] = sb[k];
    sd[h * N + n] = db[k];
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
    attend_row(i, N, H, HD, a, ss, sd, sv, p, out + (b * N + i) * HD);
  }
}

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD);
// all float32, contiguous, on the device of `stream`.
extern "C" int mmtraj_attend(const float* v, const float* s_src, const float* s_dst,
                             const float* att, float* out, int B, int N, int H, int HD,
                             cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t(N) * HD + 2 * H * N + kWarps * attend_scratch_floats(N, H));
  cudaError_t err = allow_shared_memory(attend_kernel, smem);
  if (err != cudaSuccess) return err;
  attend_kernel<<<B, kThreads, smem, stream>>>(v, s_src, s_dst, att, out, N, H, HD);
  return cudaGetLastError();
}
