// The body of the attend kernels (attend.cu: one graph a block;
// attend_packed.cu: two graphs a block).
//
// A block takes one 16-row slab of each of its graphs, the rows blockIdx.y
// * 16 .. + 15, and four warps a graph: warps 4 q .. 4 q + 3 take graph
// blockIdx.x * kGraphs + q, each every fourth head.  Each graph's warps
// stage its scores (the destination scores head-major and zero-padded to a
// whole mask word) in shared memory by cp.async and read its attend rows
// once, as float4, into bit masks that every head reuses; each head's chain
// is attend_slab (attend_common.cuh), with v read straight from device
// memory through L1.  A graph past B (the last block of an odd B, two
// graphs a block) loads and stores nothing.
#pragma once

#include "attend_common.cuh"

namespace mmtraj {

constexpr int kSlabWarps = 4;  // warps on one graph's slab
constexpr int kSlabThreads = 32 * kSlabWarps;
constexpr int kSlabTiles = 2;  // 8-column tiles of a head in one pass over the row
static_assert(kMaskWords <= kSlabWarps, "a warp reads one mask word of every lane");

// One graph's part of the block's shared memory, in floats; every offset is
// a multiple of 4, so a second graph's part stays 16-byte aligned.
struct SlabLayout {
  int Np;             // N rounded up to 64 columns (one mask word)
  int sd, si, bits;   // offsets
  int floats;
  __host__ __device__ SlabLayout(int N, int H) {
    Np = (N + 63) / 64 * 64;
    sd = 0;                     // (H, Np) destination scores, head-major
    si = sd + H * Np;           // (kSlabRows, H) source scores of the slab's rows
    bits = si + kSlabRows * H;  // (32 lanes, kMaskWords) edge masks
    floats = bits + 32 * kMaskWords;
  }
};

template <int kGraphs>
inline size_t attend_block_shared_bytes(int N, int H) {
  return sizeof(float) * kGraphs * size_t(SlabLayout(N, H).floats);
}

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1 -> out (B, N, HD),
// launched on a grid ((B + kGraphs - 1) / kGraphs, ceil(N / 16)) of
// kGraphs * kSlabThreads threads with attend_block_shared_bytes.
template <int kGraphs>
__device__ __forceinline__ void attend_block(const float* __restrict__ v,
                                             const float* __restrict__ s_src,
                                             const float* __restrict__ s_dst,
                                             const float* __restrict__ att,
                                             float* __restrict__ out, int B, int N, int H,
                                             int HD) {
  extern __shared__ __align__(16) float smem[];
  const SlabLayout L(N, H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  // The warp's graph in the block, its warp and thread in that graph's group;
  // with one graph a block, the block's own.
  const int q = kGraphs == 1 ? 0 : warp / kSlabWarps;
  const int w = kGraphs == 1 ? warp : warp % kSlabWarps;
  const int tid = kGraphs == 1 ? threadIdx.x : threadIdx.x % kSlabThreads;
  const size_t b = size_t(blockIdx.x) * kGraphs + q;
  const bool real = kGraphs == 1 || b < size_t(B);
  float* base = smem + q * L.floats;
  float* sd = base + L.sd;
  float* si = base + L.si;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(base + L.bits);
  const int r0 = blockIdx.y * kSlabRows;
  const int rows = min(kSlabRows, N - r0);
  const int words = L.Np / 64;

  if (real) {
    stage(si, s_src + (b * N + r0) * H, rows * H, tid, kSlabThreads);
    for (int k = tid; k < N * H; k += kSlabThreads)
      cp_async4(sd + (k % H) * L.Np + k / H, s_dst + b * N * H + k);
    cp_async_commit();
    for (int k = tid; k < (L.Np - N) * H; k += kSlabThreads)
      sd[(k % H) * L.Np + N + k / H] = 0.f;
    // Warp w reads word w of every lane.
    if (w < words) sbits[lane * kMaskWords + w] = edge_word(att + (b * N + r0) * N, N, rows, w);
  }
  cp_async_wait_all();
  __syncthreads();
  if (!real) return;

  const uint32_t* lane_bits = sbits + lane * kMaskWords;
  const int dh = HD / H;
  const float* vb = v + b * N * HD;
  for (int h = w; h < H; h += kSlabWarps) {
    const float* vh = vb + h * dh;
    const float s_i[2] = {g < rows ? si[g * H + h] : 0.f, g + 8 < rows ? si[(g + 8) * H + h] : 0.f};
    attend_slab<kSlabTiles>(
        4 * words, dh, sd + h * L.Np, s_i,
        [&](int c) { return (lane_bits[c >> 2] >> (8 * (c & 3))) & 0xffu; },
        [&](int j, int col) { return j < N ? __ldg(vh + j * HD + col) : 0.f; },
        [&](int row, int col, float y) {
          if (row < rows) out[(b * N + r0 + row) * HD + h * dh + col] = y;
        });
  }
}

}  // namespace mmtraj
