// The GAT attend chain as one Hopper kernel (mmtraj_torch/ops/fused_attend.py:attend).
//
// Replaces mmtraj/ops/fused_attend.py:_attend_pallas_fwd (kernel _attend_kernel).
// Bound on the H100: bytes.  Per graph it reads v (N, HD), the two score
// vectors (N, H) and the 0/1 attend tile (N, N) and writes (N, HD); the f32
// work is about 2 N^2 HD FLOP for the aggregate and 7 H N^2 for the chain.
// Design (attend_block.cuh, shared with attend_packed.cu): a block takes one
// graph's block of 16 rows, so a dozen graphs of 128 agents are 96 blocks,
// and warp q takes heads q, q + 4, ... over the whole row.  The attend rows
// are read once, as float4, into a bit mask in shared memory (8 bits a lane
// for every 16 columns), which every head reuses.  Each head's chain is attend_slab (attend_common.cuh): the softmax
// weights built straight into tensor-core A fragments and multiplied with v_h
// on mma.sync in 3xTF32, so each v value loaded feeds 16 rows, and the output
// divided by the row sum once, from the accumulators.  v comes straight from
// device memory through L1 (from L2 after the first row block of a graph);
// the scores are staged in shared memory by cp.async.  At 64 registers and a
// few KB of shared memory, eight blocks (32 warps) fit an SM.

#include "attend_block.cuh"

using namespace mmtraj;

namespace {

__global__ void __launch_bounds__(kSlabThreads, 8)
attend_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
              const float* __restrict__ s_dst, const float* __restrict__ att,
              float* __restrict__ out, int B, int N, int H, int HD) {
  attend_block<1>(v, s_src, s_dst, att, out, B, N, H, HD);
}

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD);
// all float32, contiguous, on the device of `stream`.
extern "C" int mmtraj_attend(const float* v, const float* s_src, const float* s_dst,
                             const float* att, float* out, int B, int N, int H, int HD,
                             cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const size_t smem = attend_block_shared_bytes<1>(N, H);
  cudaError_t err = allow_shared_memory(attend_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + kSlabRows - 1) / kSlabRows);
  attend_kernel<<<grid, kSlabThreads, smem, stream>>>(v, s_src, s_dst, att, out, B, N, H, HD);
  return cudaGetLastError();
}

// Occupancy of a launch at (N, H, HD): see kernel_occupancy.
extern "C" int mmtraj_attend_occupancy(int N, int H, int HD, int* info) {
  return kernel_occupancy(attend_kernel, kSlabThreads, attend_block_shared_bytes<1>(N, H), info);
}
