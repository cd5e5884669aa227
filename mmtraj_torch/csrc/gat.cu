// The whole multi-head GAT layer as one Hopper kernel
// (mmtraj_torch/ops/fused_gat.py:fused_gat).
//
// Replaces mmtraj/ops/fused_gat.py:_fused_gat_fwd_impl (kernel _gat_kernel).
// Bound on the H100: operations.  Per graph it moves h, the attend tile and
// the output (about 50 KB at N = D = 64) but does about 1.8 MFLOP of f32 work:
// the value product (2 N D HD), the score products, the attend chain
// (2 N^2 HD) and the output product (2 N HD Dout).  With one block a graph
// the grid is small (25 blocks on 132 SMs at the main path's B = 25), so
// latency, not work, sets the time.
// Design: a graph's rows are cut into 16-row slabs, a block takes one slab
// (two where N > 128), and a graph's C = ceil(N / 16 / slabs) <= 8 blocks
// form one thread block cluster: at (B, N) = (25, 64) the grid is 100
// blocks.  Each block
//  1. stages its rows of h and wv by cp.async, reads its attend rows once
//     into edge bit masks (edge_word), computes its rows of v = h wv on the
//     tensor cores in 3xTF32 (tile_mma.cuh: each k-step's products in a
//     fresh accumulator, added in float32), a warp on two 8-column tiles at
//     a time, and their head scores;
//  2. after a cluster barrier, copies the rest of the graph's v and
//     destination scores from its peers' shared memory (distributed shared
//     memory) into its own, while wo arrives by cp.async in wv's buffer;
//  3. runs the attend chain of each (slab, head), attend_slab
//     (attend_common.cuh, the chain of every kernel of the port), into the
//     aggregate, which takes h's place;
//  4. computes out = agg wo + bo on the tensor cores and stores its rows.
// The second cluster barrier is split: a block arrives once it has read
// its peers' memory and waits only before it exits, so no block's shared
// memory goes away while a peer still reads it, and nobody waits for it in
// between.  A padded row has no edge, so its aggregate is 0 and its output
// exactly bo.

#include <cooperative_groups.h>

#include "attend_common.cuh"

namespace cg = cooperative_groups;
using namespace mmtraj;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlabs = 2;  // slabs a block: N <= 256 in at most 8 blocks
constexpr int kTiles = 2;     // 8-column tiles of a head in one pass of attend_slab
constexpr int kPair = 2;      // 8-column tiles of a product a warp takes together
constexpr int kCopyUnroll = 4;
static_assert(kMaxN <= 8 * kMaxSlabs * kSlabRows, "a graph fits a portable cluster");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Dims {
  int N, D, H, HD, Dout;
};

// How a graph's rows are spread over its cluster, and the block's shared
// memory in floats (every offset a multiple of 4).  Row strides: 4 mod 8 for
// an A operand (h, the aggregate), 8 mod 32 for a B operand (wv, wo), and
// 2 mod 8 for v, whose rows 4 apart make one of attend_slab's B fragments.
struct Layout {
  int S, R, C, Np;  // slabs and rows a block, blocks a graph, N rounded up to 64
  int ldh, ldv, ldwv, ldwo;
  int h, w, v, sd, si, bits;
  int floats;
  __host__ __device__ explicit Layout(const Dims& d) {
    S = (d.N + 8 * kSlabRows - 1) / (8 * kSlabRows);
    R = kSlabRows * S;
    C = (d.N + R - 1) / R;
    Np = round_up(d.N, 64);
    ldh = round_up(d.D > d.HD ? d.D : d.HD, 8) + 4;
    ldv = round_up(d.HD, 8) + 2;
    ldwv = round_up(d.HD, 32) + 8;
    ldwo = round_up(d.Dout, 32) + 8;
    h = 0;                                        // (R, ldh) h's rows, then the aggregate
    w = h + R * ldh;                              // (D, ldwv) wv, then (HD, ldwo) wo
    v = w + (d.D * ldwv > d.HD * ldwo ? d.D * ldwv : d.HD * ldwo);  // (Np, ldv) the graph's v
    sd = v + Np * ldv;                            // (H, Np) the graph's destination scores
    si = sd + d.H * Np;                           // (R, H) the block's source scores
    bits = si + round_up(R * d.H, 4);             // (S, 32 lanes, kMaskWords) edge masks
    floats = bits + S * 32 * kMaskWords;
  }
};

// The cluster barrier in two halves: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Y = X W for the block's S slabs, X (R, K) and W (K, cols) in shared memory
// (row strides ldx and ldw); epi(row, col, y) for every row < R and col <
// cols.  A warp takes kPair 8-column tiles of every slab at a time, so each
// A fragment feeds kPair products and each B fragment S, in independent
// chains.  K and the columns are padded with zeros in the fragments.
template <typename Epi>
__device__ __forceinline__ void product(const float* X, int ldx, int K, const float* W, int ldw,
                                        int cols, int S, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int n0 = 8 * kPair * warp; n0 < cols; n0 += 8 * kPair * kWarps) {
    float acc[kMaxSlabs][kPair][4] = {};
    for (int k0 = 0; k0 < K; k0 += 8) {
      Split<2> b[kPair];
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        const int col = n0 + 8 * p + g;
        const float bw[2] = {col < cols && k0 + t < K ? W[(k0 + t) * ldw + col] : 0.f,
                             col < cols && k0 + t + 4 < K ? W[(k0 + t + 4) * ldw + col] : 0.f};
        b[p] = split(bw);
      }
#pragma unroll
      for (int s = 0; s < kMaxSlabs; ++s) {
        if (s >= S) continue;
        const Split<4> a = load_a(X, ldx, kSlabRows * s, k0, K);
#pragma unroll
        for (int p = 0; p < kPair; ++p) mma3(acc[s][p], a, b[p]);
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s) {
      if (s >= S) continue;
#pragma unroll
      for (int p = 0; p < kPair; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = n0 + 8 * p + 2 * t + (q & 1);
          if (c < cols) epi(kSlabRows * s + g + (q & 2) * 4, c, acc[s][p][q]);
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
gat_kernel(const float* __restrict__ h, const float* __restrict__ att,
           const float* __restrict__ wv, const float* __restrict__ a_src,
           const float* __restrict__ a_dst, const float* __restrict__ wo,
           const float* __restrict__ bo, float* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(d);
  const int N = d.N, H = d.H, HD = d.HD, dh = HD / H;
  float* sh = smem + L.h;  // h's rows ...
  float* sg = sh;          // ... then the aggregate
  float* sw = smem + L.w;  // wv, then wo
  float* sv = smem + L.v;
  float* sd = smem + L.sd;
  float* si = smem + L.si;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem + L.bits);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / L.C;
  const int r0 = rank * L.R, rows = min(L.R, N - r0);  // rank < C, so rows >= 1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int words = L.Np / 64, covered = L.C * L.R;

  // 1. The block's own rows: v, its scores and its edge masks.
  stage_rows(sh, L.ldh, h + (b * N + r0) * d.D, rows, d.D);
  stage_rows(sw, L.ldwv, wv, d.D, HD);
  cp_async_commit();
  // Rows of v and columns of the scores past every block's rows are 0.
  for (int k = covered * L.ldv + tid; k < L.Np * L.ldv; k += kThreads) sv[k] = 0.f;
  for (int k = tid; k < (L.Np - covered) * H; k += kThreads)
    sd[(k % H) * L.Np + covered + k / H] = 0.f;
  for (int it = warp; it < L.S * words; it += kWarps) {
    const int s = it / words, w = it % words;
    sbits[(s * 32 + lane) * kMaskWords + w] =
        edge_word(att + (b * N + r0 + kSlabRows * s) * N, N, rows - kSlabRows * s, w);
  }
  cp_async_wait_all();
  __syncthreads();
  product(sh, L.ldh, d.D, sw, L.ldwv, HD, L.S, [&](int row, int col, float y) {
    sv[(r0 + row) * L.ldv + col] = row < rows ? y : 0.f;
  });
  __syncthreads();
  stage_rows(sw, L.ldwo, wo, HD, d.Dout);
  cp_async_commit();
  for (int k = tid; k < L.R * H; k += kThreads) {
    const int row = k / H, hh = k % H;
    const float* x = sv + (r0 + row) * L.ldv + hh * dh;
    float s1 = 0.f, s2 = 0.f;
    for (int e = 0; e < dh; ++e) {
      s1 = fmaf(x[e], __ldg(a_src + hh * dh + e), s1);
      s2 = fmaf(x[e], __ldg(a_dst + hh * dh + e), s2);
    }
    si[k] = s1;
    sd[hh * L.Np + r0 + row] = s2;
  }

  // 2. The rest of the graph's v and destination scores, from the peers.
  cluster_arrive();
  cluster_wait();
  // Each peer's rows of v and its columns of every head's scores, as
  // float4s; kCopyUnroll loads are issued before their stores, which the
  // compiler would not move past a store that might alias them.
  {
    const int n_v = L.R * L.ldv / 4, n_s = L.R / 4, per = n_v + H * n_s;  // float4s a block
    const int total = L.C * per;
    for (int k0 = tid; k0 < total; k0 += kThreads * kCopyUnroll) {
      float4 x[kCopyUnroll];
      float* to[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int k = k0 + u * kThreads, p = k / per, i = k - p * per;
        to[u] = nullptr;
        if (k >= total || p == rank) continue;
        to[u] = i < n_v ? sv + p * L.R * L.ldv + 4 * i
                        : sd + (i - n_v) / n_s * L.Np + p * L.R + 4 * ((i - n_v) % n_s);
        x[u] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(to[u], p));
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u)
        if (to[u]) *reinterpret_cast<float4*>(to[u]) = x[u];
    }
  }
  cluster_arrive();  // done reading the peers' memory
  __syncthreads();

  // 3. The attend chain of each (slab, head) into the aggregate.
  for (int it = warp; it < L.S * H; it += kWarps) {
    const int s = it % L.S, hh = it / L.S, i0 = kSlabRows * s;
    const uint32_t* lane_bits = sbits + (s * 32 + lane) * kMaskWords;
    const float s_i[2] = {si[(i0 + g) * H + hh], si[(i0 + g + 8) * H + hh]};
    const float* vh = sv + hh * dh;
    attend_slab<kTiles>(
        4 * words, dh, sd + hh * L.Np, s_i,
        [&](int c) { return (lane_bits[c >> 2] >> (8 * (c & 3))) & 0xffu; },
        [&](int j, int col) { return vh[j * L.ldv + col]; },
        [&](int row, int col, float y) { sg[(i0 + row) * L.ldh + hh * dh + col] = y; });
  }
  cp_async_wait_all();  // wo
  __syncthreads();

  // 4. out = agg wo + bo for the block's rows of the graph.
  float* ob = out + (b * N + r0) * d.Dout;
  product(sg, L.ldh, HD, sw, L.ldwo, d.Dout, L.S, [&](int row, int col, float y) {
    if (row < rows) ob[row * d.Dout + col] = y + __ldg(bo + col);
  });
  cluster_wait();  // no peer reads this block's memory any more
}

size_t shared_bytes(const Dims& d) { return sizeof(float) * size_t(Layout(d).floats); }

// A launch of `blocks` blocks in clusters of C.
cudaLaunchConfig_t launch_config(int C, size_t blocks, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// h (B, N, D), att (B, N, N) 0/1, wv (D, HD), a_src/a_dst (H, HD/H),
// wo (HD, Dout), bo (Dout) -> out (B, N, Dout); all float32, contiguous.
extern "C" int mmtraj_gat(const float* h, const float* att, const float* wv,
                          const float* a_src, const float* a_dst, const float* wo,
                          const float* bo, float* out, int B, int N, int D, int H, int HD,
                          int Dout, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || D <= 0 || H <= 0 || HD <= 0 || HD % H || Dout <= 0)
    return cudaErrorInvalidValue;
  const Dims d{N, D, H, HD, Dout};
  const Layout L(d);
  const size_t smem = shared_bytes(d);
  cudaError_t err = allow_shared_memory(gat_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(L.C, size_t(B) * L.C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gat_kernel, h, att, wv, a_src, a_dst, wo, bo, out, d);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Occupancy of a launch at (N, D, H, HD, Dout): see kernel_occupancy; and
// info[4] the cluster's blocks, info[5] how many such clusters the card
// holds at once.
extern "C" int mmtraj_gat_occupancy(int N, int D, int H, int HD, int Dout, int* info) {
  const Dims d{N, D, H, HD, Dout};
  const Layout L(d);
  const size_t smem = shared_bytes(d);
  int err = kernel_occupancy(gat_kernel, kThreads, smem, info);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(L.C, L.C, smem, nullptr, &attr);
  info[4] = L.C;
  return cudaOccupancyMaxActiveClusters(&info[5], gat_kernel, &cfg);
}
