// The weight gradient of mmtraj_torch's float32 dense products,
// dW[s] = X[s]^T G[s], as one Hopper kernel and a fixed-order sum
// (mmtraj_torch/ops/dense_grad.py: weight_grad, weight_grad_lanes).
//
// Replaces no TPU kernel: in the JAX package XLA computes this product, the
// transpose of x @ w in the backward pass.  It was added because cuBLAS's
// batched SGEMM for it (the "nt" product of a vmapped x @ w with a weight
// a lane) does not split the row axis: at config 3's population step the
// output is tiny (din x dout = 64 x 192 for the GRU, 64 x 64 for the GAT,
// 64 x 30 for the head), the row axis deep (R = 8,192 a lane at a
// variety-rollout step, 1,024 in the encoder), and its 32 x 32 tiles give a
// 64 x 192 gradient of 5 lanes 60 blocks on 132 SMs, each walking all R rows
// alone.
// Bound on the H100: bytes and operations alike.  Reading X and G once is
// 928 floats a row-step, about 1.8 GB a config-3 step (0.55 ms at
// 3.35 TB/s); the products are about 37 GFLOP (0.55 ms at 67 TFLOP/s in
// FFMA).
// Design: the grid is output tiles x lanes x row splits.  A block takes a
// TM x TN tile of one lane's dW (TM = 16 where din <= 16, else 64; TN = 32
// where dout <= 32, else 64) over its split's rows, staging kRows-row
// chunks of X and G through shared memory by cp.async in a ring of kStages,
// each thread summing an 8 x 4 block of the tile (4 x 4 in the 16-row tile)
// in float32 FFMA.  The split count comes from the shape
// (ops/dense_grad.py:plan): as many splits as keep about two blocks on every
// SM, none shorter than 64 rows, so R = 1,024 and R = 8,192 both spread
// over the card where the output alone makes 5-60 blocks.  Each split
// writes its partial tile to scratch, and a second kernel sums every
// element's splits in a fixed order.  No atomics: the result is the same to
// the bit on every call and replay, and a CUDA graph captures both launches.
// Ragged edges (din = 2, dout = 30, a split's last chunk) are zeros in
// shared memory and masked at the store.

#include <algorithm>

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kRows = 32;   // rows of X and G a stage holds (ops/dense_grad.py: STAGE_ROWS)
constexpr int kStages = 3;  // stages in flight
constexpr int kMaxGroups = 8;  // thread groups of the sum over the splits

struct Shape {
  int S, R, din, dout;
  int splits, rows;              // row splits, rows a split (a multiple of kRows)
  int wide_x, wide_g, wide_out;  // 16-byte copies and stores
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows r0 .. r0 + kRows - 1 and columns c0 .. c0 + W - 1 of the
// row-major (rows, ld) matrix src into the (kRows, W) stage dst; rows at or
// past r_end and columns at or past ld are zeros.  wide: 16-byte copies (ld
// a multiple of 4 and src 16-byte aligned).
template <int W, int kThreads>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int ld, int r0,
                                            int r_end, int c0, bool wide) {
  if (wide) {
    for (int e = threadIdx.x; e < kRows * W / 4; e += kThreads) {
      const int r = e / (W / 4), c = 4 * (e % (W / 4));
      float* d = dst + r * W + c;
      if (r0 + r < r_end && c0 + c < ld) {
        cp_async16(d, src + size_t(r0 + r) * ld + c0 + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
      const int r = e / W, c = e % W;
      float* d = dst + r * W + c;
      if (r0 + r < r_end && c0 + c < ld) {
        cp_async4(d, src + size_t(r0 + r) * ld + c0 + c);
      } else {
        *d = 0.f;
      }
    }
  }
}

// Rows of a TM-row tile that a thread sums, four columns each: 8 for the
// 64-row tile (half the shared-memory reads of 4 a product), 4 for the
// 16-row one (which would keep too few threads with 8).
__host__ __device__ constexpr int rows_a_thread(int tm) { return tm >= 64 ? 8 : 4; }

__host__ __device__ constexpr int tile_threads(int tm, int tn) {
  return tm * tn / (4 * rows_a_thread(tm));
}

// One block: the TM x TN tile of lane blockIdx.y's dW over the rows of split
// blockIdx.z, into out[(split, lane)] of (splits, S, din, dout) (with one
// split, dW itself).  Thread (ty, tx) sums rows kMi ty .. kMi ty + kMi - 1
// and columns 4 tx .. 4 tx + 3 of the tile.
template <int TM, int TN>
__global__ void __launch_bounds__(tile_threads(TM, TN))
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ out,
             Shape p) {
  constexpr int kMi = rows_a_thread(TM), kThreads = tile_threads(TM, TN);
  constexpr int kStage = kRows * (TM + TN);
  extern __shared__ __align__(16) float smem[];
  const int tiles_n = (p.dout + TN - 1) / TN;
  const int m0 = (blockIdx.x / tiles_n) * TM, n0 = (blockIdx.x % tiles_n) * TN;
  const int s = blockIdx.y, split = blockIdx.z;
  const int r_begin = split * p.rows, r_end = min(p.R, r_begin + p.rows);
  const int chunks = r_end > r_begin ? (r_end - r_begin + kRows - 1) / kRows : 0;
  const float* xl = x + size_t(s) * p.R * p.din;
  const float* gl = g + size_t(s) * p.R * p.dout;
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);

  auto load = [=](int c) {
    float* st = smem + (c % kStages) * kStage;
    const int r0 = r_begin + c * kRows;
    stage_chunk<TM, kThreads>(st, xl, p.din, r0, r_end, m0, p.wide_x);
    stage_chunk<TN, kThreads>(st + kRows * TM, gl, p.dout, r0, r_end, n0, p.wide_g);
  };

  float acc[kMi][4] = {};
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();               // everyone's, and chunk c - 1's stage is free
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (c % kStages) * kStage;
    const float* gs = xs + kRows * TM;
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      float av[kMi], bv[4];
#pragma unroll
      for (int q = 0; q < kMi / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(xs + k * TM + kMi * ty + 4 * q);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(gs + k * TN + 4 * tx);
      bv[0] = b.x, bv[1] = b.y, bv[2] = b.z, bv[3] = b.w;
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* o = out + (size_t(split) * p.S + s) * p.din * p.dout;
  const int col = n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    const int row = m0 + kMi * ty + i;
    if (row >= p.din || col >= p.dout) continue;
    float* d = o + size_t(row) * p.dout + col;
    if (p.wide_out) {  // dout % 4 == 0: the four columns are all in range
      *reinterpret_cast<float4*>(d) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < p.dout) d[j] = acc[i][j];
    }
  }
}

// out[e] = the sum over the splits k of partial[k][e], by blockDim.x / 32
// groups of 32 threads: a block takes 32 elements, group j sums splits j,
// j + groups, ... of each in turn, and the groups' sums are added in group
// order.  A fixed order: the same result to the bit on every call.
__global__ void __launch_bounds__(32 * kMaxGroups)
sum_splits(const float* __restrict__ partial, float* __restrict__ out, size_t n, int splits) {
  __shared__ float part[kMaxGroups][32];
  const int groups = blockDim.x / 32, lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const size_t e = size_t(blockIdx.x) * 32 + lane;
  float acc = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int k = grp; k < splits; k += groups) acc += partial[k * n + e];
  }
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && e < n) {
    for (int j = 1; j < groups; ++j) acc += part[j][lane];
    out[e] = acc;
  }
}

size_t shared_bytes(int tm, int tn) { return sizeof(float) * kStages * kRows * (tm + tn); }

// The kernel of tile tm x tn: its function, or nullptr for a tile not built.
const void* tile_kernel(int tm, int tn) {
  if (tm == 16 && tn == 32) return reinterpret_cast<const void*>(wgrad_kernel<16, 32>);
  if (tm == 16 && tn == 64) return reinterpret_cast<const void*>(wgrad_kernel<16, 64>);
  if (tm == 64 && tn == 32) return reinterpret_cast<const void*>(wgrad_kernel<64, 32>);
  if (tm == 64 && tn == 64) return reinterpret_cast<const void*>(wgrad_kernel<64, 64>);
  return nullptr;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (S, R, din), g (S, R, dout) -> out (S, din, dout), out[s] = x[s]^T g[s];
// all float32, contiguous.  The tile (tm x tn: tm 16 or 64, tn 32 or 64) and
// the split (splits of `rows` rows each, a multiple of 32, the last one
// shorter) come from ops/dense_grad.py:plan.  With splits > 1, partial holds
// splits x S x din x dout floats of scratch; with one split it is not read.
extern "C" int mmtraj_wgrad(const float* x, const float* g, float* out, float* partial, int S,
                            int R, int din, int dout, int tm, int tn, int splits, int rows,
                            cudaStream_t stream) {
  if (S < 0 || R < 0 || din <= 0 || dout <= 0 || !tile_kernel(tm, tn) || splits < 1 ||
      rows < kRows || rows % kRows || size_t(splits) * rows < size_t(R) ||
      (splits > 1 && (size_t(splits) - 1) * rows >= size_t(R)) || (splits > 1 && !partial))
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const void* kernel = tile_kernel(tm, tn);
  const size_t smem = shared_bytes(tm, tn);
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  float* dst = splits > 1 ? partial : out;
  Shape p{S, R, din, dout, splits, rows, din % 4 == 0 && aligned16(x),
          dout % 4 == 0 && aligned16(g), dout % 4 == 0 && aligned16(dst)};
  void* args[] = {&x, &g, &dst, &p};
  const dim3 grid(((din + tm - 1) / tm) * ((dout + tn - 1) / tn), S, splits);
  err = cudaLaunchKernel(kernel, grid, dim3(tile_threads(tm, tn)), args, smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = size_t(S) * din * dout;
  const int groups = std::min(kMaxGroups, std::max(1, splits / 4));  // four splits or more each
  sum_splits<<<static_cast<unsigned>((n + 31) / 32), 32 * groups, 0, stream>>>(partial, out, n,
                                                                             splits);
  return cudaGetLastError();
}

// Occupancy of the tile tm x tn's kernel: see kernel_occupancy.
extern "C" int mmtraj_wgrad_occupancy(int tm, int tn, int* info) {
  const void* kernel = tile_kernel(tm, tn);
  if (!kernel) return cudaErrorInvalidValue;
  return kernel_occupancy(kernel, tile_threads(tm, tn), shared_bytes(tm, tn), info);
}
