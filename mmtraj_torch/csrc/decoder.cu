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
// hidden = embed = 64, 4 heads, M = 5 and T = 12 it does about 31 GFLOP, most
// of it in matrix products (the GRU's two are about 60%), and moves about
// 22 MB.
// Design: one block per rollout graph runs all T steps with the recurrent
// state (h, xy) and every intermediate in shared memory, so nothing but the
// random streams and the trajectory touches device memory after the first
// load; step t + 1's random rows arrive by cp.async while step t computes.
// Every product (head, GRU, value, the per-head attend aggregate, output) runs
// on the tensor cores in 3xTF32 (tile_mma.cuh): a warp owns an 8-column tile
// of the output for a group of 16-row slabs, so each weight fragment it loads
// (through L1 from L2, where every block finds the weights) feeds every slab
// of the group, and fetches the next fragment while the products of this one
// run.  The GRU is one pass: z and r accumulate [x | h] [wx; wh] over
// K = E + Hd, the n gate keeps x wx_n and h wh_n apart (r scales only the
// second), and each warp's accumulators hold the same columns of all four, so
// the update is computed in registers and written once.  The attend chain of
// a 16-row slab and a head is attend_slab (attend_common.cuh), as in
// attend.cu, with its edges from an adjacency bit mask that the warp computes
// once from the positions (squared distances rounded as the reference rounds
// them), so no N x N tile exists.  K and the column tiles are padded with
// zeros in the fragments: any Hd, E, HD and M.

#include <algorithm>

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAgents = 128;  // 8 sixteen-column chunks of 8 adjacency bits: one 64-bit mask
constexpr int kGroup = 4;        // 16-row slabs a warp carries through one pass over K
constexpr int kTiles = 4;        // 8-column tiles of a head in one pass of the attend weights

struct Weights {
  const float *emb_w, *emb_b, *wx, *wh, *cb, *wv, *a_src, *a_dst, *wo, *bo, *hw, *hb;
};

struct Dims {
  int T, N, Hd, E, H, HD, M;
  float r2, sigma_min, rho_max;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory, in floats.  Row strides are 4 mod 8 for an A operand and
// 8 mod 32 for v (a B operand).  Two buffers serve two values each, whose
// lives do not overlap within a step: x_in (sampling to GRU) then v (value
// product to attend); the head output (head to sampling) then the aggregate
// (attend to output product).
struct Layout {
  int slabs, Np, ldh, ldx, ldv, ldg, ldr, rnd_floats;
  int h, n, xv, rg, ss, sd, xy, m, rnd;
  size_t floats;
  __host__ __device__ Layout(const Dims& d) {
    slabs = (d.N + 15) / 16;
    Np = 16 * slabs;
    ldh = round_up(d.Hd, 8) + 4;
    ldx = round_up(d.E, 8) + 4;
    ldv = round_up(d.HD, 32) + 8;
    ldg = round_up(d.HD, 8) + 4;
    ldr = 6 * d.M;
    rnd_floats = d.N * d.M + 2 * d.N;  // one step's gumbel and normal rows
    h = 0;
    n = h + Np * ldh;
    xv = n + Np * ldh;
    rg = xv + Np * (ldx > ldv ? ldx : ldv);
    ss = rg + Np * (ldg > ldr ? ldg : ldr);
    sd = ss + d.H * Np;
    xy = sd + d.H * Np;
    m = xy + 2 * Np;
    rnd = round_up(m + Np, 4);
    floats = size_t(rnd) + 2 * size_t(rnd_floats);
  }
};

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The B fragment of rows k0 .. k0 + 7 and column col of a (K, ld) weight in
// device memory, as loaded: the loops fetch step k0 + 8's while step k0's
// products run, and split it at use.  0 past K, and where cok is false.
struct Fetched {
  float x[2];
};

__device__ __forceinline__ Fetched fetch_b(const float* __restrict__ w, int ld, int K, int k0,
                                           int col, bool cok) {
  const int t = threadIdx.x & 3;
  return {{cok && k0 + t < K ? __ldg(w + (k0 + t) * ld + col) : 0.f,
           cok && k0 + t + 4 < K ? __ldg(w + (k0 + t + 4) * ld + col) : 0.f}};
}

// Row and column of accumulator q of slab s: c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ int acc_row(int s, int q) {
  return 16 * s + ((threadIdx.x & 31) >> 2) + (q & 2) * 4;
}
__device__ __forceinline__ int acc_col(int n0, int q) { return n0 + 2 * (threadIdx.x & 3) + (q & 1); }

// Y = X W, X (Np, K) in shared memory (row stride ldx), W (K, C) in device
// memory; epi(row, col, y) for every row < Np and col < C.  A warp takes an
// (8-column tile, group of kGroup slabs) item at a time.
template <typename Epi>
__device__ __forceinline__ void product(const float* X, int ldx, int K,
                                        const float* __restrict__ W, int C, int slabs, Epi epi) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int tiles = (C + 7) / 8, groups = (slabs + kGroup - 1) / kGroup;
  for (int it = warp; it < tiles * groups; it += kWarps) {
    const int n0 = (it % tiles) * 8, s0 = (it / tiles) * kGroup;
    float acc[kGroup][4] = {};
    Fetched next = fetch_b(W, C, K, 0, n0 + g, n0 + g < C);
    for (int k0 = 0; k0 < K; k0 += 8) {
      const Split<2> bw = split(next.x);
      if (k0 + 8 < K) next = fetch_b(W, C, K, k0 + 8, n0 + g, n0 + g < C);
#pragma unroll
      for (int s = 0; s < kGroup; ++s)
        if (s0 + s < slabs) mma3(acc[s], load_a(X, ldx, 16 * (s0 + s), k0, K), bw);
    }
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (s0 + s >= slabs) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = acc_col(n0, q);
        if (col < C) epi(acc_row(s0 + s, q), col, acc[s][q]);
      }
    }
  }
}

// sn = GRU(x_in, h) in one pass (gates z, r, n; n = tanh(x Wxn + b_n + r (h Whn))).
__device__ __forceinline__ void gru(const float* sx, const float* sh, float* sn, const Layout& L,
                                    const Weights& w, int E, int Hd) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int tiles = (Hd + 7) / 8, groups = (L.slabs + kGroup - 1) / kGroup;
  const int ld = 3 * Hd;
  for (int it = warp; it < tiles * groups; it += kWarps) {
    const int n0 = (it % tiles) * 8, s0 = (it / tiles) * kGroup;
    const int col = n0 + g;
    const bool cok = col < Hd;
    float z[kGroup][4] = {}, r[kGroup][4] = {}, xn[kGroup][4] = {}, hn[kGroup][4] = {};
    Fetched nz = fetch_b(w.wx, ld, E, 0, col, cok), nr = fetch_b(w.wx, ld, E, 0, Hd + col, cok),
            nn = fetch_b(w.wx, ld, E, 0, 2 * Hd + col, cok);
    for (int k0 = 0; k0 < E; k0 += 8) {
      const Split<2> bz = split(nz.x), br = split(nr.x), bn = split(nn.x);
      const bool more = k0 + 8 < E;
      const float* wn = more ? w.wx : w.wh;  // the h part's first step follows the x part's last
      const int kn = more ? k0 + 8 : 0, Kn = more ? E : Hd;
      nz = fetch_b(wn, ld, Kn, kn, col, cok);
      nr = fetch_b(wn, ld, Kn, kn, Hd + col, cok);
      nn = fetch_b(wn, ld, Kn, kn, 2 * Hd + col, cok);
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        if (s0 + s >= L.slabs) continue;
        const Split<4> a = load_a(sx, L.ldx, 16 * (s0 + s), k0, E);
        mma3(z[s], a, bz);
        mma3(r[s], a, br);
        mma3(xn[s], a, bn);
      }
    }
    for (int k0 = 0; k0 < Hd; k0 += 8) {
      const Split<2> bz = split(nz.x), br = split(nr.x), bn = split(nn.x);
      if (k0 + 8 < Hd) {
        nz = fetch_b(w.wh, ld, Hd, k0 + 8, col, cok);
        nr = fetch_b(w.wh, ld, Hd, k0 + 8, Hd + col, cok);
        nn = fetch_b(w.wh, ld, Hd, k0 + 8, 2 * Hd + col, cok);
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        if (s0 + s >= L.slabs) continue;
        const Split<4> a = load_a(sh, L.ldh, 16 * (s0 + s), k0, Hd);
        mma3(z[s], a, bz);
        mma3(r[s], a, br);
        mma3(hn[s], a, bn);
      }
    }
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (s0 + s >= L.slabs) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = acc_col(n0, q), k = acc_row(s0 + s, q) * L.ldh + c;
        if (c >= Hd) continue;
        const float zz = sigmoid(z[s][q] + __ldg(w.cb + c));
        const float rr = sigmoid(r[s][q] + __ldg(w.cb + Hd + c));
        const float nn = tanhf(xn[s][q] + __ldg(w.cb + 2 * Hd + c) + rr * hn[s][q]);
        sn[k] = (1.f - zz) * nn + zz * sh[k];
      }
    }
  }
}

// The aggregate of every head over the proximity graph of the positions, into
// sg (Np, ldg).  A warp takes one 16-row slab and some of its heads; an edge
// where both agents are valid and d^2 <= r^2, plus a self-loop for a valid
// agent, with d^2's products and sum rounded separately (no fused
// multiply-add), as the reference computes it.
__device__ __forceinline__ void attend(const float* sv, const float* ss, const float* sd,
                                       const float* sxy, const float* sm, float* sg,
                                       const Layout& L, const Dims& dm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int H = dm.H, dh = dm.HD / dm.H;
  const int wps = max(1, kWarps / L.slabs);  // warps a slab
  for (int slab = warp / wps; slab < L.slabs; slab += kWarps / wps) {
    const int i0 = 16 * slab + g;
    // Bit 8 c + 4 r + q: the edge of row i0 + 8 r and column 16 c + 4 t + q,
    // in attend_slab's order.  Rows and columns past N have a mask of 0.
    uint64_t adj = 0;
    for (int c = 0; c < L.slabs; ++c) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + 8 * r, j = 16 * c + 4 * t + q;
          bool edge = sm[i] > 0.f && sm[j] > 0.f;
          if (edge && j != i) {
            const float dx = __fsub_rn(sxy[2 * i], sxy[2 * j]);
            const float dy = __fsub_rn(sxy[2 * i + 1], sxy[2 * j + 1]);
            edge = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= dm.r2;
          }
          adj |= uint64_t(edge) << (8 * c + 4 * r + q);
        }
    }
    for (int h = warp % wps; h < H; h += wps) {
      const float s_i[2] = {ss[h * L.Np + i0], ss[h * L.Np + i0 + 8]};
      const float* vh = sv + h * dh;
      attend_slab<kTiles>(
          L.slabs, dh, sd + h * L.Np, s_i,
          [&](int c) { return uint32_t(adj >> (8 * c)) & 0xffu; },
          [&](int j, int col) { return vh[j * L.ldv + col]; },
          [&](int row, int col, float y) { sg[(16 * slab + row) * L.ldg + h * dh + col] = y; });
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
decode_kernel(const float* __restrict__ h0, const float* __restrict__ xy0,
              const float* __restrict__ mask, const float* __restrict__ gumbel,
              const float* __restrict__ normal, const float* __restrict__ stats,
              Weights w, Dims dm, float* __restrict__ traj) {
  const int T = dm.T, N = dm.N, Hd = dm.Hd, E = dm.E, H = dm.H, HD = dm.HD, M = dm.M;
  extern __shared__ __align__(16) float smem[];
  const Layout L(dm);
  float* sh = smem + L.h;    // (Np, ldh) hidden state
  float* sn = smem + L.n;    // (Np, ldh) hidden state after the GRU
  float* sx = smem + L.xv;   // (Np, ldx) embedded offsets x_in ...
  float* sv = sx;            // ... then (Np, ldv) v
  float* sr = smem + L.rg;   // (Np, 6M) head output ...
  float* sg = sr;            // ... then (Np, ldg) attend aggregate
  float* ss = smem + L.ss;   // (H, Np) source scores
  float* sd = smem + L.sd;   // (H, Np) destination scores
  float* sxy = smem + L.xy;  // (Np, 2) positions
  float* sm = smem + L.m;    // (Np) mask 0/1
  float* rnd = smem + L.rnd; // 2 x one step's (gumbel (N, M), normal (N, 2))
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const float mean_x = stats[0], mean_y = stats[1], std_x = stats[2], std_y = stats[3];
  const int dh = HD / H;

  // Padded rows and columns start at zero, and stay finite.
  for (size_t k = tid; k < L.floats; k += kThreads) smem[k] = 0.f;
  __syncthreads();
  for (int k = tid; k < N * Hd; k += kThreads) sh[(k / Hd) * L.ldh + k % Hd] = h0[b * N * Hd + k];
  for (int k = tid; k < 2 * N; k += kThreads) sxy[k] = xy0[b * N * 2 + k];
  for (int k = tid; k < N; k += kThreads) sm[k] = mask[b * N + k];
  auto fetch = [&](int step) {  // step's random rows into buffer step % 2
    float* buf = rnd + (step & 1) * L.rnd_floats;
    const size_t row = (b * T + step) * N;
    stage(buf, gumbel + row * M, N * M);
    stage(buf + N * M, normal + row * 2, 2 * N);
    cp_async_commit();
  };
  fetch(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Head: raw = h hw + hb, columns [logits | mu_x | mu_y | s_x | s_y | rho].
    product(sh, L.ldh, Hd, w.hw, 6 * M, L.slabs,
            [&](int row, int col, float y) { sr[row * L.ldr + col] = y + __ldg(w.hb + col); });
    cp_async_wait_all();  // this step's random rows (fetched a step ago)
    __syncthreads();
    if (t + 1 < T) fetch(t + 1);  // the other buffer: step t - 1 is done with it

    // Sample each agent's offset, integrate its position and embed the
    // offset: x_in = relu(dxy_n emb_w + emb_b).  q threads an agent share the
    // E columns; each computes the (cheap) draw itself.
    const float* gum = rnd + (t & 1) * L.rnd_floats;
    const float* nrm = gum + N * M;
    const int q = max(1, kThreads / N);
    for (int idx = tid; idx < N * q; idx += kThreads) {
      const int n = idx / q, sub = idx - n * q;
      const float* raw = sr + n * L.ldr;
      const float* gn = gum + n * M;
      int best = 0;
      float top = raw[0] + gn[0];
      for (int m = 1; m < M; ++m) {
        const float s = raw[m] + gn[m];
        if (s > top) {  // strict: the first maximum wins, as argmax
          top = s;
          best = m;
        }
      }
      const float mu_x = raw[M + best], mu_y = raw[2 * M + best];
      const float s_x = softplus(raw[3 * M + best]) + dm.sigma_min;
      const float s_y = softplus(raw[4 * M + best]) + dm.sigma_min;
      const float rho = dm.rho_max * tanhf(raw[5 * M + best]);
      const float z0 = nrm[2 * n], z1 = nrm[2 * n + 1];
      const float dx = mu_x + s_x * z0;
      const float dy = mu_y + s_y * (rho * z0 + sqrtf(fmaxf(1.f - rho * rho, 1e-6f)) * z1);
      if (sub == 0) {
        const size_t row = (b * T + t) * N + n;
        const float x = sxy[2 * n] + (dx * std_x + mean_x);
        const float y = sxy[2 * n + 1] + (dy * std_y + mean_y);
        sxy[2 * n] = x;
        sxy[2 * n + 1] = y;
        traj[row * 2] = x;
        traj[row * 2 + 1] = y;
      }
      for (int c = sub; c < E; c += q) {
        const float acc = fmaf(dy, __ldg(w.emb_w + E + c), dx * __ldg(w.emb_w + c));
        sx[n * L.ldx + c] = fmaxf(acc + __ldg(w.emb_b + c), 0.f);
      }
    }
    __syncthreads();

    gru(sx, sh, sn, L, w, E, Hd);
    __syncthreads();

    // GAT: v = h wv, then the per-head scores.
    product(sn, L.ldh, Hd, w.wv, HD, L.slabs,
            [&](int row, int col, float y) { sv[row * L.ldv + col] = y; });
    __syncthreads();
    for (int k = tid; k < N * H; k += kThreads) {
      const int n = k / H, hh = k % H;
      float s1 = 0.f, s2 = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float x = sv[n * L.ldv + hh * dh + d];
        s1 = fmaf(x, __ldg(w.a_src + hh * dh + d), s1);
        s2 = fmaf(x, __ldg(w.a_dst + hh * dh + d), s2);
      }
      ss[hh * L.Np + n] = s1;
      sd[hh * L.Np + n] = s2;
    }
    __syncthreads();

    attend(sv, ss, sd, sxy, sm, sg, L, dm);
    __syncthreads();

    // Residual: h = h_gru + mask * (agg wo + bo).
    product(sg, L.ldg, HD, w.wo, Hd, L.slabs, [&](int row, int col, float y) {
      const int k = row * L.ldh + col;
      sh[k] = sn[k] + (y + __ldg(w.bo + col)) * sm[row];
    });
    __syncthreads();
  }
}

size_t shared_bytes(const Dims& dm) { return sizeof(float) * Layout(dm).floats; }

}  // namespace

// h0 (B, N, Hd), xy0 (B, N, 2), mask (B, N) 0/1, gumbel (B, T, N, M),
// normal (B, T, N, 2), stats [mean_x, mean_y, std_x, std_y]; the decoder's
// weights in the JAX (in, out) orientation, the head permuted; -> traj
// (B, T, N, 2).  All float32, contiguous.  N a multiple of 8, at most 128.
extern "C" int mmtraj_decode(const float* h0, const float* xy0, const float* mask,
                             const float* gumbel, const float* normal, const float* stats,
                             const float* emb_w, const float* emb_b, const float* wx,
                             const float* wh, const float* cb, const float* wv,
                             const float* a_src, const float* a_dst, const float* wo,
                             const float* bo, const float* hw, const float* hb, float* traj,
                             int B, int T, int N, int Hd, int E, int H, int HD, int M,
                             float r2, float sigma_min, float rho_max, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxAgents || N % 8 || Hd <= 0 || E <= 0 || H <= 0 || HD <= 0 || HD % H ||
      M <= 0)
    return cudaErrorInvalidValue;
  const Dims dm{T, N, Hd, E, H, HD, M, r2, sigma_min, rho_max};
  const size_t smem = shared_bytes(dm);
  cudaError_t err = allow_shared_memory(decode_kernel, smem);
  if (err != cudaSuccess) return err;
  const Weights w{emb_w, emb_b, wx, wh, cb, wv, a_src, a_dst, wo, bo, hw, hb};
  decode_kernel<<<B, kThreads, smem, stream>>>(h0, xy0, mask, gumbel, normal, stats, w, dm,
                                               traj);
  return cudaGetLastError();
}

// Occupancy of a launch at (N, Hd, E, H, HD, M): see kernel_occupancy.
extern "C" int mmtraj_decoder_occupancy(int N, int Hd, int E, int H, int HD, int M, int* info) {
  const Dims dm{1, N, Hd, E, H, HD, M, 0.f, 0.f, 0.f};
  return kernel_occupancy(decode_kernel, kThreads, shared_bytes(dm), info);
}
