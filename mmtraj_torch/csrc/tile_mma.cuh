// Tensor-core tiles in float32-level precision, and asynchronous copies into
// shared memory, for the Hopper kernels of mmtraj_torch.
//
// Products run on mma.sync.aligned.m16n8k8 in TF32 with the 3xTF32 split:
// each operand x becomes big = tf32(x) (round to nearest, 10 stored mantissa
// bits) and small = tf32(x - big), and
//   acc += small_a big_b + big_a small_b + big_a big_b
// with float32 accumulators.  The dropped small_a small_b term is about 2^-22
// of the product.  The tensor cores' own accumulation truncates, and summed
// over a long K in one accumulator that bias, not the split, sets the error;
// so mma3 runs the three products into a fresh accumulator and adds it to the
// running sum in float32 with round to nearest (mma3_acc keeps the sum on the
// tensor cores, for a caller that adds short partial sums itself).
//
// Fragment layout of one m16n8k8 product (lane = 4 g + t, g in 0..7, t in 0..3):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A row-major operand in shared memory with a row stride of 4 mod 8 floats,
// and a B operand with a row stride of 8 mod 32 floats, are read without
// bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmtraj {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// An operand fragment of n floats, split into its big and small TF32 parts.
template <int n>
struct Split {
  uint32_t big[n], small[n];
};

template <int n>
__device__ __forceinline__ Split<n> split(const float (&x)[n]) {
  Split<n> s;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    s.big[i] = to_tf32(x[i]);
    s.small[i] = to_tf32(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// p += a b in 3xTF32, summed by the tensor cores: the two small cross terms
// first, then the big one.
__device__ __forceinline__ void mma3_acc(float (&p)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(p, a.small, b.big);
  mma_tf32(p, a.big, b.small);
  mma_tf32(p, a.big, b.big);
}

// d += a b in 3xTF32, the product added to d in float32.
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_acc(p, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// The A fragment of rows r0 .. r0 + 15 and columns k0 .. k0 + 7 of a row-major
// (rows, K) operand in shared memory with row stride ld; columns at or past K
// read as 0, so the padding of a row never enters a product.
__device__ __forceinline__ Split<4> load_a(const float* x, int ld, int r0, int k0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = x + (r0 + g) * ld + k0 + t;
  const bool lo = k0 + t < K, hi = k0 + t + 4 < K;
  const float a[4] = {lo ? p[0] : 0.f, lo ? p[8 * ld] : 0.f, hi ? p[4] : 0.f,
                      hi ? p[8 * ld + 4] : 0.f};
  return split(a);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_address(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_address(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying n floats from src to shared dst with threads tid of
// `threads` (by default every thread of the block): 16 bytes a copy where
// both sides are 16-byte aligned and n is a multiple of 4, else 4.  The
// caller commits and waits.
__device__ inline void stage(float* dst, const float* src, int n, int tid, int threads) {
  const bool wide =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 && n % 4 == 0;
  if (wide) {
    for (int k = 4 * tid; k < n; k += 4 * threads) cp_async16(dst + k, src + k);
  } else {
    for (int k = tid; k < n; k += threads) cp_async4(dst + k, src + k);
  }
}

__device__ inline void stage(float* dst, const float* src, int n) {
  stage(dst, src, n, threadIdx.x, blockDim.x);
}

// The same for a (rows, cols) row-major matrix into shared rows of stride ld.
__device__ inline void stage_rows(float* dst, int ld, const float* src, int rows, int cols) {
  const bool wide = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
                    cols % 4 == 0 && ld % 4 == 0;
  const int step = wide ? 4 : 1, per_row = cols / step;
  for (int k = threadIdx.x; k < rows * per_row; k += blockDim.x) {
    const int r = k / per_row, c = (k - r * per_row) * step;
    if (wide) {
      cp_async16(dst + r * ld + c, src + r * cols + c);
    } else {
      cp_async4(dst + r * ld + c, src + r * cols + c);
    }
  }
}

}  // namespace mmtraj
