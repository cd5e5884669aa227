// The GAT attend chain as one Hopper kernel (mmtraj_torch/ops/fused_attend.py:attend).
//
// Replaces mmtraj/ops/fused_attend.py:_attend_pallas_fwd (kernel _attend_kernel).
// Bound on the H100: bytes.  Per graph it reads v (N, HD), the two score
// vectors (N, H) and the 0/1 attend tile (N, N) and writes (N, HD); the f32
// work is about 2 N^2 HD FLOP for the aggregate and 7 H N^2 for the chain.
// Design: a block takes one graph's block of 16 rows, so a dozen graphs of
// 128 agents are 96 blocks, and warp q takes heads q, q + 4, ... over the
// whole row.  The attend rows are read once, as float4, into a bit mask in
// shared memory (8 bits a lane for every 16 columns), which every head
// reuses.  Each head's chain is attend_slab (attend_common.cuh): the softmax
// weights built straight into tensor-core A fragments and multiplied with v_h
// on mma.sync in 3xTF32, so each v value loaded feeds 16 rows, and the output
// divided by the row sum once, from the accumulators.  v comes straight from
// device memory through L1 (from L2 after the first row block of a graph);
// the scores are staged in shared memory by cp.async.  At 64 registers and a
// few KB of shared memory, eight blocks (32 warps) fit an SM.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kRows = 16;  // rows a block: one m16 tile
constexpr int kWarps = 4;  // each on every kWarps-th head
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 2;  // 8-column tiles of a head in one pass over the row
constexpr int kWords = kMaxN / 64;  // edge-mask words a lane: 8 bits for each 16 columns
static_assert(kWords <= kWarps, "a warp reads one mask word of every lane");

struct Layout {
  int Np;             // N rounded up to 64 columns (one mask word)
  int sd, si, bits;   // offsets, in floats
  size_t floats;
  __host__ __device__ Layout(int N, int H) {
    Np = (N + 63) / 64 * 64;
    sd = 0;                  // (H, Np) destination scores, head-major
    si = sd + H * Np;        // (kRows, H) source scores of the block's rows
    bits = si + kRows * H;   // (32 lanes, kWords) edge masks
    floats = size_t(bits) + 32 * kWords;
  }
};

__global__ void __launch_bounds__(kThreads, 8)
attend_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
              const float* __restrict__ s_dst, const float* __restrict__ att,
              float* __restrict__ out, int N, int H, int HD) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, H);
  float* sd = smem + L.sd;
  float* si = smem + L.si;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem + L.bits);
  const size_t b = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - r0);
  const int tid = threadIdx.x;

  stage(si, s_src + (b * N + r0) * H, rows * H);
  for (int k = tid; k < N * H; k += kThreads)
    cp_async4(sd + (k % H) * L.Np + k / H, s_dst + b * N * H + k);
  cp_async_commit();
  for (int k = tid; k < (L.Np - N) * H; k += kThreads)
    sd[(k % H) * L.Np + N + k / H] = 0.f;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int words = L.Np / 64;

  // Edge masks: warp w reads word w of every lane.  Bit 8 (c % 4) + 4 r + q
  // of word c / 4 is a_ij of row g + 8 r of the block and column 16 c + 4 t + q.
  {
    const int w = warp;
    const bool wide = N % 4 == 0 && (reinterpret_cast<uintptr_t>(att) & 15) == 0;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (w >= words || g + 8 * r >= rows) continue;
      const float* arow = att + (b * N + r0 + g + 8 * r) * N;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = 64 * w + 16 * cc + 4 * t;
        if (j >= N) continue;
        float a[4];
        if (wide) {
          const float4 a4 = __ldg(reinterpret_cast<const float4*>(arow + j));
          a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = j + q < N ? __ldg(arow + j + q) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) word |= uint32_t(a[q] > 0.f) << (8 * cc + 4 * r + q);
      }
    }
    if (w < words) sbits[lane * kWords + w] = word;
  }
  cp_async_wait_all();
  __syncthreads();

  const uint32_t* lane_bits = sbits + lane * kWords;
  const int dh = HD / H;
  const float* vb = v + b * N * HD;
  for (int h = warp; h < H; h += kWarps) {
    const float* vh = vb + h * dh;
    const float s_i[2] = {g < rows ? si[g * H + h] : 0.f, g + 8 < rows ? si[(g + 8) * H + h] : 0.f};
    attend_slab<kTiles>(
        4 * words, dh, sd + h * L.Np, s_i,
        [&](int c) { return (lane_bits[c >> 2] >> (8 * (c & 3))) & 0xffu; },
        [&](int j, int col) { return j < N ? __ldg(vh + j * HD + col) : 0.f; },
        [&](int row, int col, float y) {
          if (row < rows) out[(b * N + r0 + row) * HD + h * dh + col] = y;
        });
  }
}

size_t shared_bytes(int N, int H) { return sizeof(float) * Layout(N, H).floats; }

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD);
// all float32, contiguous, on the device of `stream`.
extern "C" int mmtraj_attend(const float* v, const float* s_src, const float* s_dst,
                             const float* att, float* out, int B, int N, int H, int HD,
                             cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(N, H);
  cudaError_t err = allow_shared_memory(attend_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + kRows - 1) / kRows);
  attend_kernel<<<grid, kThreads, smem, stream>>>(v, s_src, s_dst, att, out, N, H, HD);
  return cudaGetLastError();
}

// Occupancy of a launch at (N, H, HD): see kernel_occupancy.
extern "C" int mmtraj_attend_occupancy(int N, int H, int HD, int* info) {
  return kernel_occupancy(attend_kernel, kThreads, shared_bytes(N, H), info);
}
