// Layer norm over the last axis, forward and backward, as Hopper kernels
// (mmtraj_torch/ops/fused_layer_norm.py: the ops mmtraj::layer_norm and
// mmtraj::layer_norm_grad, in the attention encoder's layer norms).
//
// Replaces no TPU kernel: the JAX package's layer norm is plain jnp, which
// XLA fuses.  It was added for speed: in PyTorch the plain chain
// (models/layers.py:layer_norm: mean, sub, square, mean, add, rsqrt, mul,
// mul, add) is 10 kernels forward and autograd adds 29 backward, about 72
// passes over a (P, H) tensor a layer norm in a remat-"full" training step.
// Bound on the H100: bytes.  At (P, H) = (65,536, 64) the forward reads x and
// writes y, 33.6 MB (0.010 ms at 3.35 TB/s); the backward reads x and dy and
// writes dx, 50.3 MB (0.015 ms); the rows' statistics add 8 bytes a row.
//
// For a row x of width H (float32 throughout, as the plain chain):
//   mu = sum(x) / H,  var = sum((x - mu)^2) / H,  rstd = rsqrt(var + eps),
//   xhat = (x - mu) rstd,  y = xhat scale + bias;
// and for the gradient dy of y, with g = dy scale,
//   dx = rstd (g - mean(g) - xhat mean(g xhat)),
//   dscale = sum over rows of dy xhat,  dbias = sum over rows of dy.
//
// Design: a warp a row, H / 32 values a lane in registers, element 32 j +
// lane, so that each load and store of a warp is 128 contiguous bytes
// whatever the row's alignment; the row sums by pairs in the lane, then by
// a butterfly of shuffles, which gives every lane the same bits (and a
// constant row's mean exactly).  x is read through a row stride, so a
// strided slice (the readout's last step, x[:, :, -1]) needs no copy.  Each
// elementwise step is rounded as the plain chain rounds it (no fused
// multiply-add), so with the same mu and rstd the forward gives its bits.
//  - ln_fwd_kernel: one row a warp; writes y and each row's mu and rstd for
//    the backward.
//  - ln_bwd_kernel: a block takes a run of rows, its warps the rows in turn
//    (the next row's loads issued before this row's sums); dx is written
//    row by row and each lane keeps its columns' dscale and dbias in
//    float64 over its rows.  The block adds its warps' sums in warp order
//    and writes them to a float64 scratch, a row of 2 H a block.
//  - ln_sum_kernel adds the blocks' rows in a fixed order and rounds once to
//    float32.  No atomics: the result is the same to the bit on every call
//    and replay, and a CUDA graph captures all three launches.  The sums
//    over up to 65,536 rows are float64 because a float32 sum there is as
//    far from exact as the plain chain's own and the attention encoder's
//    per-step check then has the two roundings to absorb.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kFwdWarps = 8;    // rows a forward block (a warp each)
constexpr int kBwdWarps = 16;   // warps a backward block
constexpr int kSumGroups = 16;  // thread groups of the sum over the blocks

__device__ __forceinline__ float warp_sum(float v) { return lanes_sum<32>(v); }

// v[0] + ... + v[V - 1] by pairs: V equal values sum exactly (each level
// doubles), so with the butterfly a constant row's mean is its value and
// x - mu is 0.
template <int V>
__device__ __forceinline__ float pair_sum(const float* v) {
  if constexpr (V == 1) {
    return v[0];
  } else {
    return pair_sum<V / 2>(v) + pair_sum<V / 2>(v + V / 2);
  }
}

template <int H>
__global__ void __launch_bounds__(32 * kFwdWarps)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ mu,
              float* __restrict__ rstd, int P, int ldx, float eps) {
  constexpr int V = H / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kFwdWarps + threadIdx.x / 32;
  if (row >= P) return;
  const float* xr = x + size_t(row) * ldx;
  float v[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = xr[32 * j + lane];
  const float m = __fmul_rn(warp_sum(pair_sum<V>(v)), 1.f / H);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = __fsub_rn(v[j], m);
    sq[j] = __fmul_rn(v[j], v[j]);
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(pair_sum<V>(sq)), 1.f / H), eps));
  float* yr = y + size_t(row) * H;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = 32 * j + lane;
    yr[c] = __fadd_rn(__fmul_rn(__fmul_rn(v[j], r), scale[c]), bias[c]);
  }
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

template <int H>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ scale, const float* __restrict__ mu,
              const float* __restrict__ rstd, float* __restrict__ dx, double* __restrict__ partial,
              int P, int ldx, int lddy, int rows_a_warp) {
  constexpr int V = H / 32;
  extern __shared__ double sums[];  // (kBwdWarps, 2, H): each warp's dscale, dbias
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first = blockIdx.x * kBwdWarps * rows_a_warp + warp;
  float sc[V], xv[V], gv[V], xn[V] = {}, gn[V] = {};
  double ds[V], db[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sc[j] = scale[32 * j + lane];
    ds[j] = 0.0;
    db[j] = 0.0;
  }
  auto load = [&](int row, float* xo, float* go) {
    const float* xr = x + size_t(row) * ldx;
    const float* gr = dy + size_t(row) * lddy;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xo[j] = xr[32 * j + lane];
      go[j] = gr[32 * j + lane];
    }
  };
  if (first < P) load(first, xv, gv);
  for (int k = 0; k < rows_a_warp; ++k) {
    const int row = first + k * kBwdWarps;
    if (row >= P) break;
    const int next = row + kBwdWarps;
    if (k + 1 < rows_a_warp && next < P) load(next, xn, gn);
    const float m = mu[row], r = rstd[row];
    float xh[V], g[V], sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xh[j] = __fmul_rn(__fsub_rn(xv[j], m), r);
      g[j] = __fmul_rn(gv[j], sc[j]);
      sg += g[j];
      sgx = __fmaf_rn(g[j], xh[j], sgx);
      ds[j] += double(gv[j]) * double(xh[j]);
      db[j] += double(gv[j]);
    }
    const float mg = __fmul_rn(warp_sum(sg), 1.f / H);
    const float mgx = __fmul_rn(warp_sum(sgx), 1.f / H);
    float* dr = dx + size_t(row) * H;
#pragma unroll
    for (int j = 0; j < V; ++j)
      dr[32 * j + lane] = __fmul_rn(r, __fsub_rn(__fsub_rn(g[j], mg), __fmul_rn(xh[j], mgx)));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xv[j] = xn[j];
      gv[j] = gn[j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sums[(2 * warp) * H + 32 * j + lane] = ds[j];
    sums[(2 * warp + 1) * H + 32 * j + lane] = db[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * H; c += blockDim.x) {
    const int which = c / H, col = c % H;
    double t = 0.0;
    for (int w = 0; w < kBwdWarps; ++w) t += sums[(2 * w + which) * H + col];
    partial[size_t(blockIdx.x) * 2 * H + c] = t;
  }
}

// dscale[c] (c < H) and dbias[c - H] = the sum over the blocks k of
// partial[k][c], by kSumGroups groups of 32 threads: a block takes 32 of the
// 2 H columns, group j sums blocks j, j + kSumGroups, ... of each, and the
// groups' sums are added in group order; rounded to float32 once.
__global__ void __launch_bounds__(32 * kSumGroups)
ln_sum_kernel(const double* __restrict__ partial, float* __restrict__ dscale,
              float* __restrict__ dbias, int blocks, int H) {
  __shared__ double part[kSumGroups][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  double acc = 0.0;
#pragma unroll 4
  for (int k = grp; k < blocks; k += kSumGroups) acc += partial[size_t(k) * 2 * H + c];
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0) {
    for (int j = 1; j < kSumGroups; ++j) acc += part[j][lane];
    if (c < H) {
      dscale[c] = static_cast<float>(acc);
    } else {
      dbias[c - H] = static_cast<float>(acc);
    }
  }
}

template <int H>
size_t bwd_shared_bytes() {
  return sizeof(double) * 2 * kBwdWarps * H;
}

bool width_ok(int H) { return H == 64 || H == 128; }

}  // namespace

// x (P rows of H, row r at x + r * ldx), scale and bias (H) -> y (P, H)
// contiguous, mu and rstd (P); all float32.  H is 64 or 128.
extern "C" int mmtraj_layer_norm(const float* x, const float* scale, const float* bias, float* y,
                                 float* mu, float* rstd, int P, int H, int ldx, float eps,
                                 cudaStream_t stream) {
  if (P < 0 || !width_ok(H) || ldx < 0) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  const dim3 grid((P + kFwdWarps - 1) / kFwdWarps), block(32 * kFwdWarps);
  if (H == 64) {
    ln_fwd_kernel<64><<<grid, block, 0, stream>>>(x, scale, bias, y, mu, rstd, P, ldx, eps);
  } else {
    ln_fwd_kernel<128><<<grid, block, 0, stream>>>(x, scale, bias, y, mu, rstd, P, ldx, eps);
  }
  return cudaGetLastError();
}

// The gradient of mmtraj_layer_norm at dy (P rows of H, row r at dy + r *
// lddy), from its x, scale, mu and rstd -> dx (P, H) contiguous, dscale and
// dbias (H).  `blocks` blocks of 16 warps take rows_a_warp rows a warp
// (ops/fused_layer_norm.py:plan): blocks * 16 * rows_a_warp >= P, and no
// block without a row; partial holds blocks x 2 H doubles of scratch.  With
// P = 0 dscale and dbias are zeros.
extern "C" int mmtraj_layer_norm_grad(const float* x, const float* dy, const float* scale,
                                      const float* mu, const float* rstd, float* dx,
                                      float* dscale, float* dbias, double* partial, int P, int H,
                                      int ldx, int lddy, int blocks, int rows_a_warp,
                                      cudaStream_t stream) {
  const long long per_block = 1LL * kBwdWarps * rows_a_warp;
  if (P < 0 || !width_ok(H) || ldx < 0 || lddy < 0 || blocks < 1 || rows_a_warp < 1 ||
      per_block * blocks < P || (P > 0 && per_block * (blocks - 1) >= P))
    return cudaErrorInvalidValue;
  const int used = P > 0 ? blocks : 0;
  if (P > 0) {
    const dim3 block(32 * kBwdWarps);
    if (H == 64) {
      ln_bwd_kernel<64><<<blocks, block, bwd_shared_bytes<64>(), stream>>>(
          x, dy, scale, mu, rstd, dx, partial, P, ldx, lddy, rows_a_warp);
    } else {
      ln_bwd_kernel<128><<<blocks, block, bwd_shared_bytes<128>(), stream>>>(
          x, dy, scale, mu, rstd, dx, partial, P, ldx, lddy, rows_a_warp);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ln_sum_kernel<<<2 * H / 32, 32 * kSumGroups, 0, stream>>>(partial, dscale, dbias, used, H);
  return cudaGetLastError();
}

// Occupancy of the forward (backward = 0) or the backward kernel at width H:
// see kernel_occupancy.
extern "C" int mmtraj_layer_norm_occupancy(int H, int backward, int* info) {
  if (!width_ok(H)) return cudaErrorInvalidValue;
  if (backward) {
    return H == 64 ? kernel_occupancy(ln_bwd_kernel<64>, 32 * kBwdWarps, bwd_shared_bytes<64>(),
                                      info)
                   : kernel_occupancy(ln_bwd_kernel<128>, 32 * kBwdWarps,
                                      bwd_shared_bytes<128>(), info);
  }
  return H == 64 ? kernel_occupancy(ln_fwd_kernel<64>, 32 * kFwdWarps, 0, info)
                 : kernel_occupancy(ln_fwd_kernel<128>, 32 * kFwdWarps, 0, info);
}
