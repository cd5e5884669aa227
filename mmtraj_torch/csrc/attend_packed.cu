// The GAT attend chain, two graphs a block (mmtraj_torch/ops/fused_attend.py:
// attend(..., packed=True), wrapper attend_packed).
//
// Replaces mmtraj/ops/fused_attend.py:_attend_pallas_fwd with packed=True
// (kernel _attend_kernel_packed), which packs two graphs side by side into
// the TPU's 128 lanes and splits each row's max and sum with masked dual
// reductions.  It computes attend.cu's function, and is bound the same way
// on the H100: by bytes (each input read once, the output written once).
// The Hopper form of the packing is a pair of graphs a block in attend.cu's
// slab design, from the same body (attend_block.cuh): the grid is
// ((B + 1) / 2, ceil(N / 16)), and of the 8 warps, 0-3 take the heads of
// graph 2 p's 16-row slab and 4-7 those of graph 2 p + 1's, each graph with
// its own scores and edge bit masks in shared memory and its own
// attend_slab chains on the tensor cores.  In the last block of an odd B
// the second graph loads and stores nothing.

#include "attend_block.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 2 * kSlabThreads;

__global__ void __launch_bounds__(kThreads, 4)
attend_packed_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
                     const float* __restrict__ s_dst, const float* __restrict__ att,
                     float* __restrict__ out, int B, int N, int H, int HD) {
  attend_block<2>(v, s_src, s_dst, att, out, B, N, H, HD);
}

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD);
// all float32, contiguous, on the device of `stream`.
extern "C" int mmtraj_attend_packed(const float* v, const float* s_src, const float* s_dst,
                                    const float* att, float* out, int B, int N, int H, int HD,
                                    cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const size_t smem = attend_block_shared_bytes<2>(N, H);
  cudaError_t err = allow_shared_memory(attend_packed_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 1) / 2, (N + kSlabRows - 1) / kSlabRows);
  attend_packed_kernel<<<grid, kThreads, smem, stream>>>(v, s_src, s_dst, att, out, B, N, H, HD);
  return cudaGetLastError();
}

// Occupancy of a launch at (N, H, HD): see kernel_occupancy.
extern "C" int mmtraj_attend_packed_occupancy(int N, int H, int HD, int* info) {
  return kernel_occupancy(attend_packed_kernel, kThreads, attend_block_shared_bytes<2>(N, H),
                          info);
}
