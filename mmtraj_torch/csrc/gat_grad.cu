// The backward of the GAT's masked attend chain as Hopper kernels
// (mmtraj_torch/ops/fused_gat.py: fused_gat_grad, the op
// mmtraj::gat_attend_grad, in _FusedGat's backward).
//
// Replaces no TPU kernel: the JAX package differentiates the plain math
// (mmtraj/ops/fused_gat.py:_bwd, XLA's ops).  It was added for speed: the
// autograd of the plain chain runs about 200 ops a call at 4 heads, each
// over a (B, N, N) tensor; at (B, N, HD) = (1,024, 64, 64), 4 heads of 16,
// they move about 4.9 GB.  These kernels read v, the scores, the attend tile
// and d_agg, and write agg, dv and the score gradients, 88 MB there, with
// every N x N value in registers (and the tile's edges as bits, three
// numbers a row between the two main kernels).
// Bound on the H100: float32 operations and bytes alike, about 0.028 ms at
// that shape (1.9 GFLOP: three products of 2 N^2 dh a head and graph and the
// chain; 88 MB).
//
// For one graph and head, with l_ij = s_src_i + s_dst_j, the forward's
//   alpha_ij = a_ij exp(LeakyReLU_0.2(l_ij) - m_i) / max(sum_j ..., 1e-20)
// (m_i the row max, which takes no gradient) and agg_i = sum_j alpha_ij v_j,
// the gradient for d_agg is
//   dalpha_ij = d_agg_i . v_j,   D_i = d_agg_i . agg_i,
//   dl_ij = alpha_ij (dalpha_ij - D_i) (1 where l_ij > 0, else 0.2),
//   ds_src_i = sum_j dl_ij,   ds_dst_j = sum_i dl_ij,   dv_j = sum_i alpha_ij d_agg_i.
// A row without edges has no weight (its sum is clamped at 1e-20, which
// passes no gradient), so its agg, D and dl are 0, as in the plain VJP.
//
// Design: edge_bits_kernel turns the attend tile into bit masks once a call,
// by rows and by columns (every head of both kernels below reads them).
// Then a block takes one graph and one head, and up to four of its 16-row
// slabs, a warp each.  The block stages the head's columns of the other
// side's matrix (all of the graph's rows: v for the rows, d_agg for the
// columns) and the other side's scores in shared memory by cp.async, each
// warp its slab's rows and edge bits; after one block barrier every warp
// works alone.  Each weight's exp is the plain chain's float32 one (not the
// forward kernel's base-2 approximation); the products run on the tensor
// cores in float64 (mma m8n8k4) and every sum after the exp is taken in
// float64, so each output is the chain's gradient to its own float32
// rounding.  A float32-faithful version (3xTF32 products, float32 sums) was
// as close to float64 as the plain float32 VJP, but its rounding, on top of
// the forward kernel's, took config4-attn3's per-step check past its limit
// on a steep seed where the float64 form stays far inside it (PERF.md §6).
//  - rows_kernel (kCols false), the slab's rows i: the row max (from the
//    largest s_dst over the row's edges, as attend_slab in
//    attend_common.cuh), then, 8 columns at a time, agg = e v on the tensor
//    cores (the weights built in registers as the A operands) with the sum
//    of e, agg normalised and D_i = d_agg_i . agg_i from it; then,
//    tile by tile, dalpha = d_agg v^T on the tensor cores and dl from it,
//    summed over the row into ds_src.  Writes agg, ds_src and each row's
//    (max, 1 / sum, D).
//  - cols_kernel (kCols true), the slab's columns j over every row i, the
//    roles swapped, 8 rows at a time: dalpha^T = v d_agg^T and dl^T, summed
//    into ds_dst, and dv += alpha^T d_agg, from the rows' numbers.
// Every sum is taken in one fixed order inside one warp, so the result
// repeats to the bit: no atomics.

#include "attend_common.cuh"

using namespace mmtraj;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 2;  // 8-column tiles of a head in one pass of weighted_tile

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Dims {
  int B, N, H, HD;
};

// The block's shared memory, in floats; every offset a multiple of 4.  Row
// strides are 4 mod 8: an A operand's rows (X) and both B operands' (Y read
// by rows for agg and dv, by columns for dalpha) are read without bank
// conflicts.
struct Layout {
  int dh, Np, words, ld, slabs, warps;
  int y, col, stats, x, bits, floats;
  __host__ __device__ explicit Layout(const Dims& d) {
    dh = d.HD / d.H;
    Np = round_up(d.N, 8);       // the other side's rows, in whole k-steps
    words = (d.N + 31) / 32;     // edge-bit words of a slab row
    ld = round_up(dh, 8) + 4;
    slabs = (d.N + kSlabRows - 1) / kSlabRows;
    warps = slabs < kWarps ? slabs : kWarps;
    y = 0;                                // (Np, ld) the head's columns of v (rows) or d_agg (cols)
    col = y + Np * ld;                    // (Np) s_dst (rows) or s_src (cols)
    stats = col + Np;                     // (3, Np) doubles, cols_kernel: each row i's max, 1 / sum, D
    x = stats + 6 * Np;                   // (warps, 16, ld) each warp's slab rows of the other
    bits = x + warps * kSlabRows * ld;    // (warps, 16, words) its edges, bit k of a row column k
    floats = round_up(bits + warps * kSlabRows * words, 4);
  }
};

// Rows row0 .. row0 + rows - 1 of a head's dh columns of a matrix (src at
// row 0, column 0; row stride ldsrc) into dst (row stride ld), by cp.async
// with every thread of the block, 16 bytes a copy where the widths allow;
// rows at or past N are zeros.  The caller commits and waits.
__device__ __forceinline__ void stage_head(float* dst, int ld, const float* src, int ldsrc,
                                           int row0, int rows, int N, int dh) {
  const bool wide =
      dh % 4 == 0 && ldsrc % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int step = wide ? 4 : 1, per = dh / step;
  for (int k = threadIdx.x; k < rows * per; k += blockDim.x) {
    const int r = k / per, c = (k - r * per) * step, row = row0 + r;
    float* to = dst + r * ld + c;
    if (row >= N) {
      for (int u = 0; u < step; ++u) to[u] = 0.f;
    } else if (wide) {
      cp_async16(to, src + size_t(row) * ldsrc + c);
    } else {
      cp_async4(to, src + size_t(row) * ldsrc + c);
    }
  }
}

// e_ij = exp(LeakyReLU_0.2(s_src_i + s_dst_j) - m_i), the weight before the
// row's normalisation, in the plain chain's float32 operations (so alpha is
// the plain chain's to exp's rounding).
__device__ __forceinline__ float weight(float s_src, float s_dst, float m) {
  const float l = s_src + s_dst;
  return expf((l > 0.f ? l : 0.2f * l) - m);
}

// LeakyReLU's slope at the logit, 0.2 where it is <= 0, as torch.where(l > 0, ...).
__device__ __forceinline__ float slope(float s_src, float s_dst) {
  return s_src + s_dst > 0.f ? 1.f : 0.2f;
}

// d += a b on the tensor cores in float64, one m8n8k4 step: lane 4 g + t
// gives a = A[g][t] and b = B[t][g], and holds D[g][2 t] and D[g][2 t + 1].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// Sum over each group of 4 consecutive lanes (the lanes of one fragment row).
__device__ __forceinline__ double lanes_sum4(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The 16 x 8 tile of X Z^T at columns j0 .. j0 + 7, X the slab's rows and Z
// the other side's (Np rows), both in shared memory with row stride ld, dh
// deep, on the tensor cores in float64 -> this lane's part: acc[q] is row
// g + 8 (q >> 1) and column j0 + 2 t + (q & 1).
__device__ __forceinline__ void gram_tile(int j0, int dh, const float* sx, const float* sz,
                                          int ld, double (&acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* zrow = sz + (j0 + g) * ld;
  double hi[2] = {0.0, 0.0}, lo[2] = {0.0, 0.0};  // rows g and g + 8
  for (int k = t; k < dh + t; k += 4) {
    const bool in = k < dh;
    const double b = in ? zrow[k] : 0.0;
    dmma(hi, in ? sx[g * ld + k] : 0.0, b);
    dmma(lo, in ? sx[(g + 8) * ld + k] : 0.0, b);
  }
  acc[0] = hi[0], acc[1] = hi[1], acc[2] = lo[0], acc[3] = lo[1];
}

// acc[nt] += P Y for the 8-column tiles nt of the head's columns n0 ..
// n0 + 8 kTiles - 1 (those < dh), P the 16 x 8 weights of columns k0 .. k0 + 7
// as gram_tile's part holds them (p[q]: row g + 8 (q >> 1), column k0 + 2 t +
// (q & 1)), Y in shared memory with row stride ld, on the tensor cores in
// float64, two k-steps of 4: step u's slot t is column k0 + 2 t + u, so each
// lane's weights are its A operands as they stand; Y's rows are read in the
// same order.
__device__ __forceinline__ void weighted_tile(int k0, int n0, int dh, const double (&p)[4],
                                              const float* sy, int ld,
                                              double (&acc)[kTiles][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float* yrow = sy + (k0 + 2 * t + u) * ld;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      if (n0 + 8 * nt >= dh) continue;  // the same on every lane
      const int col = n0 + 8 * nt + g;
      const double b = col < dh ? yrow[col] : 0.0;
      double hi[2] = {acc[nt][0], acc[nt][1]}, lo[2] = {acc[nt][2], acc[nt][3]};
      dmma(hi, p[u], b);
      dmma(lo, p[2 + u], b);
      acc[nt][0] = hi[0], acc[nt][1] = hi[1], acc[nt][2] = lo[0], acc[nt][3] = lo[1];
    }
  }
}

// The attend tile's edges as bits, once a call, for both kernels: rows (B, N,
// words), bit j % 32 of word j / 32 of row i is a_ij > 0, and cols (B, N,
// words), bit i % 32 of word i / 32 of row j the same edge.  A warp takes a
// 32 x 32 tile of one graph: lane l reads column j0 + l of its 32 rows, all
// loads first; a ballot a row gives the rows' words, the lane's own 32 reads
// its column's word.
__global__ void __launch_bounds__(kThreads)
edge_bits_kernel(const float* __restrict__ att, uint32_t* __restrict__ rows,
                 uint32_t* __restrict__ cols, int B, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = (N + 31) / 32;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (tile >= static_cast<long long>(B) * words * words) return;
  const int tj = static_cast<int>(tile % words), ti = static_cast<int>(tile / words % words);
  const size_t b = static_cast<size_t>(tile / (static_cast<long long>(words) * words));
  const int i0 = 32 * ti, j = 32 * tj + lane;
  const float* ab = att + b * N * N;
  float x[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) x[r] = i0 + r < N && j < N ? ab[size_t(i0 + r) * N + j] : 0.f;
  uint32_t row = 0, col = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const uint32_t w = __ballot_sync(0xffffffffu, x[r] > 0.f);
    if (lane == r) row = w;
    col |= uint32_t(x[r] > 0.f) << r;
  }
  if (i0 + lane < N) rows[(b * N + i0 + lane) * words + tj] = row;
  if (j < N) cols[(b * N + j) * words + ti] = col;
}

// kCols false: rows_kernel, out = agg, ds = ds_src, stats written, bits the
// edge_bits rows.  kCols true: cols_kernel, out = dv, ds = ds_dst, stats
// read, bits the edge_bits columns.
// stats is (B, H, 3, N) float64: each row's max m, 1 / its clamped sum, and D.
template <bool kCols>
__global__ void __launch_bounds__(kThreads)
gat_grad_kernel(const float* __restrict__ v, const float* __restrict__ s_src,
                const float* __restrict__ s_dst,
                const float* __restrict__ d_agg, const uint32_t* __restrict__ bits,
                float* __restrict__ out, float* __restrict__ ds, double* __restrict__ stats,
                Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(d);
  const int N = d.N, H = d.H, HD = d.HD, dh = L.dh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // Blocks in (graph, group of slabs, head) order, heads fastest, so that
  // neighbouring blocks read the same edge bits.
  const int groups = (L.slabs + L.warps - 1) / L.warps;
  const int hh = blockIdx.x % H;
  const int first = static_cast<int>(blockIdx.x / H % groups) * L.warps;  // the block's first slab
  const size_t b = blockIdx.x / (static_cast<size_t>(H) * groups);
  const int r0 = (first + warp) * kSlabRows;  // the warp's slab
  float* sy = smem + L.y;
  float* scol = smem + L.col;
  double* sst = reinterpret_cast<double*>(smem + L.stats);
  float* sx = smem + L.x + warp * kSlabRows * L.ld;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem + L.bits) + warp * kSlabRows * L.words;
  // The slab side's matrix and scores, and the other side's.
  const float* X = (kCols ? v : d_agg) + b * N * HD + hh * dh;
  const float* Y = (kCols ? d_agg : v) + b * N * HD + hh * dh;
  const float* own = (kCols ? s_dst : s_src) + b * N * H + hh;
  const float* other = (kCols ? s_src : s_dst) + b * N * H + hh;
  double* st = stats + (b * H + hh) * 3 * N;

  stage_head(sy, L.ld, Y, HD, 0, L.Np, N, dh);
  stage_head(smem + L.x, L.ld, X, HD, first * kSlabRows, L.warps * kSlabRows, N, dh);
  cp_async_commit();
  for (int k = threadIdx.x; k < L.Np; k += blockDim.x) scol[k] = k < N ? other[size_t(k) * H] : 0.f;
  if constexpr (kCols)
    for (int k = threadIdx.x; k < 3 * L.Np; k += blockDim.x) {
      const int s = k / L.Np, i = k - s * L.Np;
      sst[k] = i < N ? st[s * N + i] : 0.0;
    }
  // The warp's edge bits: its slab's words of edge_bits_kernel's rows (or columns).
  const uint32_t* slab_bits = bits + (b * N + r0) * L.words;
  for (int k = lane; k < kSlabRows * L.words; k += 32)
    sbits[k] = r0 + k / L.words < N ? slab_bits[k] : 0u;
  cp_async_wait_all();
  __syncthreads();
  if (first + warp >= L.slabs) return;  // past the graph's last slab

  auto edge = [&](int r, int k) -> bool {
    return (sbits[(g + 8 * r) * L.words + (k >> 5)] >> (k & 31)) & 1u;
  };
  float sown[2];  // the scores of this lane's slab rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = r0 + g + 8 * r;
    sown[r] = m < N ? own[size_t(m) * H] : 0.f;
  }
  float* ob = out + b * N * HD + hh * dh;
  double sum[2] = {0.0, 0.0};  // the slab rows' sums of dl

  if constexpr (!kCols) {
    // The row max needs no pass over the logits: LeakyReLU and rounding are
    // monotone, so it is the logit of the row's largest s_dst over its edges
    // (-inf for a row without edges, whose weights are all 0).
    float m[2];
    double rden[2] = {1.0, 1.0}, D[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
      for (int k = t; k < N; k += 4)
        if (edge(r, k)) mx = fmaxf(mx, scol[k]);
      const float l = sown[r] + lanes_max<4>(mx);
      m[r] = l > 0.f ? l : 0.2f * l;
    }
    // agg = (e v) / the clamped sum of e, the sum taken on the first pass.
    double esum[2] = {0.0, 0.0}, part[2] = {0.0, 0.0};
    for (int n0 = 0; n0 < dh; n0 += 8 * kTiles) {
      double acc[kTiles][4] = {};
      for (int j0 = 0; j0 < L.Np; j0 += 8) {
        double e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1, k = j0 + 2 * t + (q & 1);
          e[q] = edge(r, k) ? weight(sown[r], scol[k], m[r]) : 0.f;
        }
        if (n0 == 0) {
          esum[0] += e[0] + e[1];
          esum[1] += e[2] + e[3];
        }
        weighted_tile(j0, n0, dh, e, sy, L.ld, acc);
      }
      if (n0 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) rden[r] = 1.0 / fmax(lanes_sum4(esum[r]), 1e-20);
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1, row = g + 8 * r, col = n0 + 8 * nt + 2 * t + (q & 1);
          if (col >= dh) continue;
          const double y = acc[nt][q] * rden[r];
          part[r] = fma(y, double(sx[row * L.ld + col]), part[r]);
          if (r0 + row < N) ob[size_t(r0 + row) * HD + col] = float(y);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) D[r] = lanes_sum4(part[r]);
    // dl_ij = alpha_ij (dalpha_ij - D_i) slope_ij, tile by tile, summed over j.
    for (int j0 = 0; j0 < L.Np; j0 += 8) {
      double dp[4];
      gram_tile(j0, dh, sx, sy, L.ld, dp);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q >> 1, k = j0 + 2 * t + (q & 1);
        if (edge(r, k))
          sum[r] += weight(sown[r], scol[k], m[r]) * rden[r] * (dp[q] - D[r]) *
                    slope(sown[r], scol[k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (t == 0 && row < N) {
        st[row] = m[r];
        st[N + row] = rden[r];
        st[2 * N + row] = D[r];
      }
    }
  } else {
    // Over the rows i, 8 at a time: dl^T from dalpha^T = v d_agg^T (first
    // pass), summed into ds_dst, and dv += alpha^T d_agg.
    const double* sm = sst;
    const double* srden = sst + L.Np;
    const double* sD = sst + 2 * L.Np;
    for (int n0 = 0; n0 < dh; n0 += 8 * kTiles) {
      double acc[kTiles][4] = {};
      for (int i0 = 0; i0 < L.Np; i0 += 8) {
        double p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1, k = i0 + 2 * t + (q & 1);
          p[q] = edge(r, k) ? weight(scol[k], sown[r], float(sm[k])) * srden[k] : 0.0;
        }
        if (n0 == 0) {
          double dp[4];
          gram_tile(i0, dh, sx, sy, L.ld, dp);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q >> 1, k = i0 + 2 * t + (q & 1);
            sum[r] += p[q] * (dp[q] - sD[k]) * slope(scol[k], sown[r]);
          }
        }
        weighted_tile(i0, n0, dh, p, sy, L.ld, acc);
      }
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = r0 + g + 8 * (q >> 1), col = n0 + 8 * nt + 2 * t + (q & 1);
          if (col < dh && row < N) ob[size_t(row) * HD + col] = float(acc[nt][q]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const double s = lanes_sum4(sum[r]);
    const int row = r0 + g + 8 * r;
    if (t == 0 && row < N) ds[(b * N + row) * H + hh] = float(s);
  }
}

size_t shared_bytes(const Dims& d) { return sizeof(float) * size_t(Layout(d).floats); }

template <bool kCols>
cudaError_t launch(const float* v, const float* s_src, const float* s_dst, const float* d_agg,
                   const uint32_t* bits, float* out, float* ds, double* stats, const Dims& d,
                   cudaStream_t stream) {
  const Layout L(d);
  const size_t smem = shared_bytes(d);
  cudaError_t err = allow_shared_memory(gat_grad_kernel<kCols>, smem);
  if (err != cudaSuccess) return err;
  const size_t blocks = size_t(d.B) * d.H * ((L.slabs + L.warps - 1) / L.warps);
  gat_grad_kernel<kCols><<<static_cast<unsigned>(blocks), 32 * L.warps, smem, stream>>>(
      v, s_src, s_dst, d_agg, bits, out, ds, stats, d);
  return cudaGetLastError();
}

}  // namespace

// v (B, N, HD), s_src/s_dst (B, N, H), att (B, N, N) 0/1, d_agg (B, N, HD)
// -> agg (B, N, HD), dv (B, N, HD): alpha^T d_agg, the scores' terms left to
// the caller, ds_src/ds_dst (B, N, H); scratch stats (B, H, 3, N) float64 and
// bits (2, B, N, ceil(N / 32)) 32-bit words.  All contiguous.  Three
// launches on the stream: the edge bits, the rows, the columns (which read
// the rows' stats).
extern "C" int mmtraj_gat_grad(const float* v, const float* s_src, const float* s_dst,
                               const float* att, const float* d_agg, float* agg, float* dv,
                               float* ds_src, float* ds_dst, double* stats, uint32_t* bits, int B,
                               int N, int H, int HD, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (N <= 0 || N > kMaxN || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const Dims d{B, N, H, HD};
  const int words = (N + 31) / 32;
  uint32_t* rows = bits;
  uint32_t* cols = bits + size_t(B) * N * words;
  const size_t tiles = size_t(B) * words * words;
  edge_bits_kernel<<<static_cast<unsigned>((tiles + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      att, rows, cols, B, N);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch<false>(v, s_src, s_dst, d_agg, rows, agg, ds_src, stats, d, stream);
  if (err == cudaSuccess)
    err = launch<true>(v, s_src, s_dst, d_agg, cols, dv, ds_dst, stats, d, stream);
  return err;
}

// Occupancy of a launch at (N, H, HD), the worse of rows_kernel and cols_kernel: see
// kernel_occupancy.
extern "C" int mmtraj_gat_grad_occupancy(int N, int H, int HD, int* info) {
  if (N <= 0 || H <= 0 || HD <= 0 || HD % H) return cudaErrorInvalidValue;
  const Dims d{1, N, H, HD};
  const size_t smem = shared_bytes(d);
  const int threads = 32 * Layout(d).warps;
  int cols[4];
  int err = kernel_occupancy(gat_grad_kernel<false>, threads, smem, info);
  if (err == cudaSuccess) err = kernel_occupancy(gat_grad_kernel<true>, threads, smem, cols);
  if (err != cudaSuccess) return err;
  info[0] = info[0] < cols[0] ? info[0] : cols[0];
  info[1] = info[1] > cols[1] ? info[1] : cols[1];
  info[2] = info[2] > cols[2] ? info[2] : cols[2];
  return cudaSuccess;
}
