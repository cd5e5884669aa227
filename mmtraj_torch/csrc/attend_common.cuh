// The masked multi-head attend chain of every kernel of mmtraj_torch
// (attend.cu, attend_packed.cu, gat.cu and decoder.cu): attend_slab, on the
// tensor cores for one 16-row slab and one head, its edge masks
// (edge_word), and what every kernel uses around its launch.
//
// For one output row i and each head h:
//   logits_j = LeakyReLU_0.2(s_src[h, i] + s_dst[h, j]), set to -1e9 where a_ij = 0
//   e_j      = exp(logits_j - max_j logits_j) * a_ij
//   out[h*dh + d] = sum_j e_j v[j, h*dh + d] / max(sum_j e_j, 1e-20)
// which is mmtraj/ops/fused_attend.py:attend_math.  A padded row has no
// edge, so all its weights are 0 and its output is 0 / 1e-20 = 0, where the
// reference's -1e9 mask gives exp(0) * 0 = 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tile_mma.cuh"

namespace mmtraj {

constexpr int kMaxN = 256;             // the widest graph
constexpr int kSlabRows = 16;          // rows of a slab: one m16 tile
constexpr int kMaskWords = kMaxN / 64; // edge-mask words a lane: 8 bits for each 16 columns

// Max and sum over each group of kWidth consecutive lanes (4: the lanes of
// one row of an mma fragment).  All 32 lanes call them together.
template <int kWidth>
__device__ __forceinline__ float lanes_max(float x) {
  for (int o = kWidth / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int kWidth>
__device__ __forceinline__ float lanes_sum(float x) {
  for (int o = kWidth / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// LeakyReLU with slope 0.2, as max(x, 0.2 x).
__device__ __forceinline__ float leaky_relu(float x) { return fmaxf(x, 0.2f * x); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x for x <= 0 on the special function unit (relative error about 2^-22; a
// result below 2^-126, far under any softmax weight that counts, becomes 0).
// attend_slab takes the softmax in base 2: e = 2^(l log2(e) - max).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Word w of this lane's edge mask of a 16-row slab, from the slab's attend
// rows (arow0: its first row, `rows` of them, N columns, 0/1): bit
// 8 cc + 4 r + q is a_ij of row g + 8 r of the slab and column
// 64 w + 16 cc + 4 t + q, which is bit 4 r + q of chunk 4 w + cc in
// attend_slab's order.  Rows at or past `rows` and columns at or past N
// give 0.  Each row is read as float4 where N % 4 == 0 and arow0 is
// 16-byte aligned.
__device__ __forceinline__ uint32_t edge_word(const float* __restrict__ arow0, int N, int rows,
                                              int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool wide = N % 4 == 0 && (reinterpret_cast<uintptr_t>(arow0) & 15) == 0;
  uint32_t word = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= rows) continue;
    const float* arow = arow0 + size_t(g + 8 * r) * N;
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
        for (int k = 0; k < 4; ++k) a[k] = j + k < N ? __ldg(arow + j + k) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= uint32_t(a[k] > 0.f) << (8 * cc + 4 * r + k);
    }
  }
  return word;
}

// The attend chain of one 16-row slab and one head on the tensor cores, by
// one warp.  Lane 4 g + t holds rows g and g + 8 of the slab; the columns j
// come in chunks of 16, of which lane t takes 16 c + 4 t .. 16 c + 4 t + 3.
//   chunks         16-column chunks to cover (columns without edges add 0)
//   dh             the head's width
//   sdh            the head's destination scores in shared memory, 16-byte
//                  aligned and finite over all 16 chunks columns
//   si             the source scores of rows g and g + 8
//   bits(c)        this lane's 8 edge bits of chunk c: bit 4 r + q is a_ij of
//                  row g + 8 r and column 16 c + 4 t + q
//   vload(j, col)  v[j, h dh + col] for col < dh (0 where j has no row)
//   store(row, col, y)  output column col < dh of row `row` of the slab
// The row max of the masked LeakyReLU logits needs no pass over the logits:
// LeakyReLU and rounding are monotone, so it is LeakyReLU(s_src_i + the
// largest s_dst_j over the row's edges); -inf for a row without edges, whose
// weights are all 0 (its output is then 0 / 1e-20 = 0).  The weights are
// taken in base 2 on the special function unit straight into A fragments: a
// float4 of s_dst covers the chunk's two 8-column k-steps s, with k-slot t
// <-> column 16 c + 4 t + 2 s and slot t + 4 <-> 16 c + 4 t + 2 s + 1, and v's
// rows are read in the same order.  The two k-steps are summed on the tensor
// cores in 3xTF32 and added to the row's sum in float32 (tile_mma.cuh); kTiles
// 8-column tiles of the head are built from one pass over the weights.
template <int kTiles, typename Bits, typename VLoad, typename Store>
__device__ __forceinline__ void attend_slab(int chunks, int dh, const float* sdh,
                                            const float (&si)[2], Bits bits, VLoad vload,
                                            Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < chunks; ++c) {
    const uint32_t w = bits(c);
    const float4 d4 = *reinterpret_cast<const float4*>(sdh + 16 * c + 4 * t);
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((w >> (4 * r + q)) & 1) m[r] = fmaxf(m[r], d[q]);
  }
  // In base 2: the logit times log2(e) is LeakyReLU(s_dst log2(e) + s_src log2(e)),
  // monotone in s_dst as before, and e = 2^(that - its row max).
  float s[2], mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s[r] = si[r] * kLog2e;
    mx[r] = leaky_relu(fmaf(lanes_max<4>(m[r]), kLog2e, s[r]));
  }
  for (int n0 = 0; n0 < dh; n0 += 8 * kTiles) {
    float acc[kTiles][4] = {};
    float sum[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      const uint32_t w = bits(c);
      const int j = 16 * c + 4 * t;
      const float4 d4 = *reinterpret_cast<const float4*>(sdh + j);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
      float e[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool edge = (w >> (4 * r + q)) & 1;
          e[r][q] = edge ? exp2_approx(leaky_relu(fmaf(d[q], kLog2e, s[r])) - mx[r]) : 0.f;
          sum[r] += e[r][q];
        }
      float part[kTiles][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float af[4] = {e[0][2 * k], e[1][2 * k], e[0][2 * k + 1], e[1][2 * k + 1]};
        const Split<4> pa = split(af);
        const int ja = j + 2 * k, jb = ja + 1;
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          if (n0 + 8 * nt >= dh) continue;
          const int col = n0 + 8 * nt + g;
          const float bv[2] = {col < dh ? vload(ja, col) : 0.f, col < dh ? vload(jb, col) : 0.f};
          mma3_acc(part[nt], pa, split(bv));
        }
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
    }
    const float den[2] = {fmaxf(lanes_sum<4>(sum[0]), 1e-20f),
                          fmaxf(lanes_sum<4>(sum[1]), 1e-20f)};
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = n0 + 8 * nt + 2 * t + (q & 1);
        if (col < dh) store(g + (q & 2) * 4, col, acc[nt][q] / den[q >> 1]);
      }
    }
  }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// For a kernel launched with `threads` threads and `smem` bytes of dynamic
// shared memory: info = {blocks an SM, registers a thread, local (spill)
// bytes a thread, dynamic shared bytes a block}.
template <typename Kernel>
inline int kernel_occupancy(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = static_cast<int>(smem);
  return cudaSuccess;
}

}  // namespace mmtraj

extern "C" const char* mmtraj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
