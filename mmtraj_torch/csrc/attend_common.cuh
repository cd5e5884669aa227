// The masked multi-head attend chain shared by the kernels of mmtraj_torch
// (attend.cu, attend_packed.cu, gat.cu, decoder.cu).
//
// For one output row i and each head h:
//   logits_j = LeakyReLU_0.2(s_src[h, i] + s_dst[h, j]), set to -1e9 where a_ij = 0
//   e_j      = exp(logits_j - max_j logits_j) * a_ij
//   out[h*dh + d] = sum_j e_j v[j, h*dh + d] / max(sum_j e_j, 1e-20)
// which is mmtraj/ops/fused_attend.py:attend_math.  The mask value is -1e9 and
// not -inf: a padded row has every logit masked, and -inf - (-inf) would give
// NaN where the reference gives exp(0) * 0 = 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmtraj {

constexpr float kNegInf = -1e9f;
constexpr int kMaxN = 256;             // widest graph: a lane holds kMaxJ entries of a row
constexpr int kMaxJ = kMaxN / 32;

// Max and sum over each group of kWidth consecutive lanes (32: the whole
// warp; 16: each half-warp on its own).  All 32 lanes call them together.
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

// Floats of per-row-group scratch attend_row needs: for each head, the N
// weights e_j and the denominator.  The row length N + 1 also puts
// consecutive heads on different shared-memory banks.
__host__ __device__ inline int attend_scratch_floats(int N, int H) { return H * (N + 1); }

// One output row i of the attend chain for all H heads, computed by a group
// of kWidth consecutive lanes (a whole warp, or a half-warp when two graphs
// share a warp).  a[t] holds a_ij for j = lane + kWidth t (0 beyond N).  In
// shared memory: s_src and s_dst head-major (H, N); v row-major (N, HD); p
// this group's scratch.  out: the HD floats of row i, in shared or global
// memory.  Every lane of the warp must call it with the same N, H and HD.
template <int kWidth>
__device__ inline void attend_row_lanes(int i, int N, int H, int HD,
                                        const float (&a)[kMaxN / kWidth],
                                        const float* s_src, const float* s_dst,
                                        const float* v, float* p, float* out) {
  constexpr int kJ = kMaxN / kWidth;
  const int lane = threadIdx.x & (kWidth - 1);
  const int dh = HD / H;
  for (int h = 0; h < H; ++h) {
    const float si = s_src[h * N + i];
    const float* sd = s_dst + h * N;
    float l[kJ];
    float mx = -INFINITY;  // every row has N >= 1 entries, each >= -1e9
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const int j = lane + kWidth * t;
      l[t] = kNegInf;
      if (j < N) {
        float x = si + sd[j];
        x = x > 0.f ? x : 0.2f * x;
        l[t] = a[t] > 0.f ? x : kNegInf;
        mx = fmaxf(mx, l[t]);
      }
    }
    mx = lanes_max<kWidth>(mx);
    float* ph = p + h * (N + 1);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const int j = lane + kWidth * t;
      if (j < N) {
        const float e = expf(l[t] - mx) * a[t];
        ph[j] = e;
        sum += e;
      }
    }
    sum = lanes_sum<kWidth>(sum);
    if (lane == 0) ph[N] = fmaxf(sum, 1e-20f);
  }
  __syncwarp();
  for (int c = lane; c < HD; c += kWidth) {
    const float* ph = p + (c / dh) * (N + 1);
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(ph[j], v[j * HD + c], acc);
    out[c] = acc / ph[N];
  }
  __syncwarp();  // the next row reuses p
}

// One output row, by a whole warp (kMaxJ entries of the attend row a lane).
__device__ inline void attend_row(int i, int N, int H, int HD, const float (&a)[kMaxJ],
                                  const float* s_src, const float* s_dst, const float* v,
                                  float* p, float* out) {
  attend_row_lanes<32>(i, N, H, HD, a, s_src, s_dst, v, p, out);
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mmtraj

extern "C" const char* mmtraj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
