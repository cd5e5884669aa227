// The masked multi-head attend chain shared by the three kernels of
// mmtraj_torch (attend.cu, gat.cu, decoder.cu).
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Floats of per-warp scratch attend_row needs: for each head, the N weights
// e_j and the denominator.  The row length N + 1 also puts consecutive heads
// on different shared-memory banks.
__host__ __device__ inline int attend_scratch_floats(int N, int H) { return H * (N + 1); }

// One output row i of the attend chain for all H heads, computed by one whole
// warp.  a[t] holds a_ij for j = lane + 32 t (0 beyond N).  In shared memory:
// s_src and s_dst head-major (H, N); v row-major (N, HD); p this warp's
// scratch.  out: the HD floats of row i, in shared or global memory.
__device__ inline void attend_row(int i, int N, int H, int HD, const float (&a)[kMaxJ],
                                  const float* s_src, const float* s_dst, const float* v,
                                  float* p, float* out) {
  const int lane = threadIdx.x & 31;
  const int dh = HD / H;
  for (int h = 0; h < H; ++h) {
    const float si = s_src[h * N + i];
    const float* sd = s_dst + h * N;
    float l[kMaxJ];
    float mx = -INFINITY;  // every row has N >= 1 entries, each >= -1e9
#pragma unroll
    for (int t = 0; t < kMaxJ; ++t) {
      const int j = lane + 32 * t;
      l[t] = kNegInf;
      if (j < N) {
        float x = si + sd[j];
        x = x > 0.f ? x : 0.2f * x;
        l[t] = a[t] > 0.f ? x : kNegInf;
        mx = fmaxf(mx, l[t]);
      }
    }
    mx = warp_max(mx);
    float* ph = p + h * (N + 1);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxJ; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        const float e = expf(l[t] - mx) * a[t];
        ph[j] = e;
        sum += e;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) ph[N] = fmaxf(sum, 1e-20f);
  }
  __syncwarp();
  for (int c = lane; c < HD; c += 32) {
    const float* ph = p + (c / dh) * (N + 1);
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(ph[j], v[j * HD + c], acc);
    out[c] = acc / ph[N];
  }
  __syncwarp();  // the warp's next row reuses p
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
