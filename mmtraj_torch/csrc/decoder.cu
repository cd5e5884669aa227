// The whole sampled rollout of the decoder as one Hopper kernel
// (mmtraj_torch/ops/fused_decoder.py:fused_decode).
//
// Replaces mmtraj/ops/fused_decoder.py:fused_decode (kernel _decoder_kernel,
// step _step_math).  Each of the T steps, for every agent of a rollout graph:
// GMM head (columns in permute_head order), first-max Gumbel pick of the
// component, correlated normal draw, denormalize and integrate, proximity
// adjacency with self-loops for valid agents, ReLU embed, GRU, multi-head
// GAT residual with padded rows zeroed.
//
// Bound on the H100: operations.  At 500 rollout graphs of N = 64 agents,
// hidden = embed = 64, 4 heads, M = 5 and T = 12 it does about 31 GFLOP of f32
// work (the GRU's two products are about 60% of it) and moves about 22 MB.
// Design: one block per rollout graph runs all T steps with the recurrent
// state (h, xy) and every intermediate in shared memory, so nothing but the
// random streams and the trajectory touches device memory after the first
// load.  Each adjacency row is built in registers from the positions inside
// the attend chain (attend_row, shared with attend.cu and gat.cu), so no
// N x N tile exists.  The weights (about 150 KB in all) are read through the
// read-only cache from L2, where every block finds them.  The products are
// per-thread f32 dot products with consecutive threads on consecutive output
// columns; tensor-core tiles are the next step for speed.

#include <algorithm>

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Weights {
  const float *emb_w, *emb_b, *wx, *wh, *cb, *wv, *a_src, *a_dst, *wo, *bo, *hw, *hb;
};

struct Dims {
  int T, N, Hd, E, H, HD, M;
  float r2, sigma_min, rho_max;
};

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// out[n, c] = sum_k in[n, k] w[k, c] for an (N, K) shared-memory operand and a
// (K, C) weight in device memory; returns the sum for flat index idx = n*C + c.
__device__ __forceinline__ float row_dot(const float* in, int K, const float* __restrict__ w,
                                         int C, int n, int c) {
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(in[n * K + k], __ldg(w + k * C + c), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ h0, const float* __restrict__ xy0,
              const float* __restrict__ mask, const float* __restrict__ gumbel,
              const float* __restrict__ normal, const float* __restrict__ stats,
              Weights w, Dims dm, float* __restrict__ traj) {
  const int T = dm.T, N = dm.N, Hd = dm.Hd, E = dm.E, H = dm.H, HD = dm.HD, M = dm.M;
  const int A = max(max(6 * M, E), HD);
  extern __shared__ float smem[];
  float* sh = smem;              // (N, Hd) hidden state
  float* sn = sh + N * Hd;       // (N, Hd) hidden state after the GRU
  float* sa = sn + N * Hd;       // (N, A): head output, then embedding, then v
  float* sg = sa + N * A;        // (N, HD) attend aggregate
  float* ss = sg + N * HD;       // (H, N) source scores
  float* sd = ss + H * N;        // (H, N) destination scores
  float* sxy = sd + H * N;       // (N, 2) positions
  float* sdx = sxy + 2 * N;      // (N, 2) sampled normalized offsets
  float* sm = sdx + 2 * N;       // (N) mask 0/1
  float* scratch = sm + N;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float mean_x = stats[0], mean_y = stats[1], std_x = stats[2], std_y = stats[3];
  const int dh = HD / H;

  for (int k = tid; k < N * Hd; k += kThreads) sh[k] = h0[b * N * Hd + k];
  for (int k = tid; k < 2 * N; k += kThreads) sxy[k] = xy0[b * N * 2 + k];
  for (int k = tid; k < N; k += kThreads) sm[k] = mask[b * N + k];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Head: raw = h hw + hb, columns [logits | mu_x | mu_y | s_x | s_y | rho].
    for (int k = tid; k < N * 6 * M; k += kThreads) {
      const int n = k / (6 * M), c = k % (6 * M);
      sa[k] = row_dot(sh, Hd, w.hw, 6 * M, n, c) + __ldg(w.hb + c);
    }
    __syncthreads();

    // Sample each agent's offset and integrate its position.
    for (int n = tid; n < N; n += kThreads) {
      const float* raw = sa + n * 6 * M;
      const size_t row = (b * T + t) * N + n;
      const float* g = gumbel + row * M;
      int best = 0;
      float top = raw[0] + g[0];
      for (int m = 1; m < M; ++m) {
        const float s = raw[m] + g[m];
        if (s > top) {  // strict: the first maximum wins, as argmax
          top = s;
          best = m;
        }
      }
      const float mu_x = raw[M + best], mu_y = raw[2 * M + best];
      const float s_x = softplus(raw[3 * M + best]) + dm.sigma_min;
      const float s_y = softplus(raw[4 * M + best]) + dm.sigma_min;
      const float rho = dm.rho_max * tanhf(raw[5 * M + best]);
      const float z0 = normal[row * 2], z1 = normal[row * 2 + 1];
      const float dx = mu_x + s_x * z0;
      const float dy = mu_y + s_y * (rho * z0 + sqrtf(fmaxf(1.f - rho * rho, 1e-6f)) * z1);
      sdx[2 * n] = dx;
      sdx[2 * n + 1] = dy;
      const float x = sxy[2 * n] + (dx * std_x + mean_x);
      const float y = sxy[2 * n + 1] + (dy * std_y + mean_y);
      sxy[2 * n] = x;
      sxy[2 * n + 1] = y;
      traj[row * 2] = x;
      traj[row * 2 + 1] = y;
    }
    __syncthreads();

    // Embed: x_in = relu(dxy_n emb_w + emb_b).
    for (int k = tid; k < N * E; k += kThreads) {
      const int n = k / E, c = k % E;
      const float acc = row_dot(sdx, 2, w.emb_w, E, n, c);
      sa[k] = fmaxf(acc + __ldg(w.emb_b + c), 0.f);
    }
    __syncthreads();

    // GRU, gates (z, r, n): n = tanh(x Wxn + b_n + r (h Whn)).
    for (int k = tid; k < N * Hd; k += kThreads) {
      const int n = k / Hd, c = k % Hd;
      const float xz = row_dot(sa, E, w.wx, 3 * Hd, n, c) + __ldg(w.cb + c);
      const float xr = row_dot(sa, E, w.wx, 3 * Hd, n, Hd + c) + __ldg(w.cb + Hd + c);
      const float xn = row_dot(sa, E, w.wx, 3 * Hd, n, 2 * Hd + c) + __ldg(w.cb + 2 * Hd + c);
      const float hz = row_dot(sh, Hd, w.wh, 3 * Hd, n, c);
      const float hr = row_dot(sh, Hd, w.wh, 3 * Hd, n, Hd + c);
      const float hn = row_dot(sh, Hd, w.wh, 3 * Hd, n, 2 * Hd + c);
      const float z = sigmoid(xz + hz);
      const float r = sigmoid(xr + hr);
      const float nn = tanhf(xn + r * hn);
      sn[k] = (1.f - z) * nn + z * sh[k];
    }
    __syncthreads();

    // GAT: v = h wv, then the per-head scores.
    for (int k = tid; k < N * HD; k += kThreads) {
      const int n = k / HD, c = k % HD;
      sa[k] = row_dot(sn, Hd, w.wv, HD, n, c);
    }
    __syncthreads();
    for (int k = tid; k < N * H; k += kThreads) {
      const int n = k / H, hh = k % H;
      float s1 = 0.f, s2 = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float x = sa[n * HD + hh * dh + d];
        s1 = fmaf(x, __ldg(w.a_src + hh * dh + d), s1);
        s2 = fmaf(x, __ldg(w.a_dst + hh * dh + d), s2);
      }
      ss[hh * N + n] = s1;
      sd[hh * N + n] = s2;
    }
    __syncthreads();

    // Attend over the proximity graph of the new positions: an edge where
    // both agents are valid and d^2 <= r^2, plus a self-loop for a valid agent.
    // The products and the sum are rounded separately (no fused multiply-add),
    // as the reference computes d^2.
    float* p = scratch + warp * attend_scratch_floats(N, H);
    for (int i = warp; i < N; i += kWarps) {
      const float xi = sxy[2 * i], yi = sxy[2 * i + 1], mi = sm[i];
      float a[kMaxJ];
#pragma unroll
      for (int t2 = 0; t2 < kMaxJ; ++t2) {
        const int j = lane + 32 * t2;
        float aij = 0.f;
        if (j < N) {
          const float pair = mi * sm[j];
          if (j == i) {
            aij = pair;
          } else {
            const float ddx = __fsub_rn(xi, sxy[2 * j]);
            const float ddy = __fsub_rn(yi, sxy[2 * j + 1]);
            const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
            aij = d2 <= dm.r2 ? pair : 0.f;
          }
        }
        a[t2] = aij;
      }
      attend_row(i, N, H, HD, a, ss, sd, sa, p, sg + i * HD);
    }
    __syncthreads();

    // Residual: h = h_gru + mask * (agg wo + bo).
    for (int k = tid; k < N * Hd; k += kThreads) {
      const int n = k / Hd, c = k % Hd;
      const float g = row_dot(sg, HD, w.wo, Hd, n, c) + __ldg(w.bo + c);
      sh[k] = sn[k] + g * sm[n];
    }
    __syncthreads();
  }
}

}  // namespace

// h0 (B, N, Hd), xy0 (B, N, 2), mask (B, N) 0/1, gumbel (B, T, N, M),
// normal (B, T, N, 2), stats [mean_x, mean_y, std_x, std_y]; the decoder's
// weights in the JAX (in, out) orientation, the head permuted; -> traj
// (B, T, N, 2).  All float32, contiguous.
extern "C" int mmtraj_decode(const float* h0, const float* xy0, const float* mask,
                             const float* gumbel, const float* normal, const float* stats,
                             const float* emb_w, const float* emb_b, const float* wx,
                             const float* wh, const float* cb, const float* wv,
                             const float* a_src, const float* a_dst, const float* wo,
                             const float* bo, const float* hw, const float* hb, float* traj,
                             int B, int T, int N, int Hd, int E, int H, int HD, int M,
                             float r2, float sigma_min, float rho_max, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || Hd <= 0 || E <= 0 || H <= 0 || HD <= 0 || HD % H || M <= 0)
    return cudaErrorInvalidValue;
  const int A = std::max(std::max(6 * M, E), HD);
  const size_t smem =
      sizeof(float) * (2 * size_t(N) * Hd + size_t(N) * A + size_t(N) * HD + 2 * H * N +
                       5 * N + kWarps * attend_scratch_floats(N, H));
  cudaError_t err = allow_shared_memory(decode_kernel, smem);
  if (err != cudaSuccess) return err;
  const Weights w{emb_w, emb_b, wx, wh, cb, wv, a_src, a_dst, wo, bo, hw, hb};
  const Dims dm{T, N, Hd, E, H, HD, M, r2, sigma_min, rho_max};
  decode_kernel<<<B, kThreads, smem, stream>>>(h0, xy0, mask, gumbel, normal, stats, w, dm,
                                               traj);
  return cudaGetLastError();
}
