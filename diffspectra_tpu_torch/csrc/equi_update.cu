// Equivariant coordinate update of one DMT block, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel diffspectra_tpu/ops/pallas_equi_update.py::_kernel
// (entry point equi_update_fused, shared math _chain_math). For every pair
// (b, i, j):
//
//   pair = node_i + node_j + [edge_ij | dist_ij] @ [We; Wd] + bias  [Dh]
//   pair = LayerNorm(pair, no affine, eps) * (1 + scale_b) + shift_b
//   inv  = silu(pair @ W0 + b0)                                     [Dh]
//   g    = tanh(inv @ W1)                                           [1 + A]
//   gate = mean(g * [1, adj_ij])
//   out_i = sum_j normed_diff_ij * gate * mask_ij                   [3]
//
// What bounds it on this card. At the serving shape (B=10, N=29, De=Dd=64,
// Dh=256, A=2) a pair costs 2*128*256 operations for the gate projections
// and 2*256*256 for the W0 product: about 1.7 GFLOP against about 5.5 MB of
// inputs and outputs, some 300 operations per byte, so in f32 on the CUDA
// cores (67 TFLOP/s, 3.35 TB/s) it is bound by operations. Per row (b, i)
// the weights are 384 KB, so a design that reads them for each row moves
// 111 MB through L2 a call and waits on it.
//
// What the design does about it. One block per tile of R rows of one
// molecule (row_tile.cuh: 64 pair rows and 256 threads, or 32 and 128), so
// every weight is read once a tile. The tile's [edge | dist] rows (one
// contiguous slab each, transposed into shared memory), node_j of the
// molecule, node_i of the R rows, and adj, the mask and normed_diff of its
// pairs come in by cp.async; [We; Wd] streams through the ring as one
// K = De + Dd product whose [TR, Dh] result stays in the 8 x 8 register
// tiles. W0's first chunks are on their way while the epilogue adds
// node_i + node_j + bias and runs the LayerNorm and modulation in the
// registers (a row's sums: 8 lanes by shuffles, then 4 warps in order);
// the modulated pairs go, transposed, over the slab as the left operand of
// the W0 product. silu, the 1 + A wide W1 product (each thread's 8
// columns, then 8 lanes by shuffles and 4 warps in order, so the result
// does not depend on timing), tanh, the adjacency mean and the mask leave
// one gate a pair in shared memory, and 3 R threads sum normed_diff * gate
// over j. No [B, N, N, > 3] tensor reaches device memory, as on the TPU.
//
// Shared memory, in floats: max(Dh (TR + 4), (De + Dd)(TR + 4) + (N + R) Dh)
// for the slab, node_j and node_i, then the pairs; the ring (3 x 8 x 256,
// then the gates); the row sums (TR x 4 x 4); adj, mask and normed_diff
// (7 TR). At the flagship widths that is 100,096 bytes for TR = 64 (two
// blocks an SM, at most 128 registers a thread) and 76,672 for TR = 32
// (three, at most 170 registers). The plan (ops/equi_update.py::
// launch_plan, re-checked here) gives:
//   B=10: N=17 R=2 90 tiles of 64, N=21 R=2 110, N=25 R=2 130 (one wave
//         of one block an SM); N=29 R=1 290 tiles of 32 (one wave, at most
//         three an SM);
//   B=80: N=17 R=3 480 tiles of 64, N=21 R=3 560, N=25 R=2 1040,
//         N=29 R=2 1200 (1.8 to 4.5 waves of two an SM).
// f32 FMAs on the CUDA cores: single TF32 cannot hold the 1e-5 tolerance,
// and a 3xTF32 mma.sync product was no faster in block_fused (PERF.md).
// What the chip showed (PERF.md): the tile product runs well below the
// f32 rate; deeper or shallower weight chunks and a faster silu moved the
// time by a few percent; where 64-row tiles overflow one wave by a little,
// tiles of 32 rows are faster (tools/row_tiles.py times both).

#include "row_tile.cuh"

namespace {

using namespace dstt;
using namespace dstt::rows;

constexpr int kMaxGate = 4;  // 1 + A adjacency gates

struct Args {
  const float *node_i, *node_j, *edge, *dist, *normed, *adj, *mask;
  const float *we, *wd, *bias, *shift, *scale, *w0, *b0, *w1;
  float* out;
  int n, de, dd, dh, n_adj, rows_per_tile, tiles;
  float eps;
};

// Shared-memory floats of a tile of tr rows: the transposed slab, node_j
// and node_i, then the transposed pairs over them; the ring (then the
// gates); the row sums of 4 warps for up to kMaxGate gates; adj, the mask
// and normed_diff of the tile's pairs.
__host__ __device__ inline int front_floats(int tr, int n, int r, int de, int dd, int dh) {
  return imax(dh * (tr + 4), (de + dd) * (tr + 4) + (n + r) * dh);
}

Plan make_plan(int batch, int n, int de, int dd, int dh) {
  return plan_rows(batch, n, [&](int tr, int r) {
    return front_floats(tr, n, r, de, dd, dh) + kRing + tr * 4 * kMaxGate + tr * (kMaxGate + 3);
  });
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

template <int TR>
__global__ void __launch_bounds__(Tiling<TR>::kThreads, Tiling<TR>::kMinBlocks)
    equi_update_kernel(Args a) {
  using T = Tiling<TR>;
  extern __shared__ __align__(16) float smem[];
  const Tile t = tile_of(a.n, a.rows_per_tile, a.tiles);
  const int n = a.n, dh = a.dh, n_adj = a.n_adj, n_gate = 1 + n_adj;
  const int wc = warp_col(), lc = lane_col();
  float* slab_t = smem;                               // [De + Dd, kLdT]: edge | dist, transposed
  float* nj_s = slab_t + (a.de + a.dd) * T::kLdT;     // [n, Dh]
  float* ni_s = nj_s + n * dh;                        // [R, Dh]
  float* pair_t = smem;                               // [Dh, kLdT], over the above
  float* ring = smem + front_floats(TR, n, a.rows_per_tile, a.de, a.dd, dh);
  float* gate_s = ring;                               // [TR], once the ring is free
  float* red_s = ring + kRing;                        // [TR, 4 warps, kMaxGate] row sums
  float* adj_s = red_s + TR * 4 * kMaxGate;           // [TR, A]
  float* mask_s = adj_s + TR * (kMaxGate - 1);        // [TR]
  float* normed_s = mask_s + TR;                      // [TR, 3]

  copy_rows_transposed_async<T::kThreads>(slab_t, T::kLdT, a.edge + (size_t)t.row0 * n * a.de,
                                          a.de, t.pairs, a.de);
  copy_rows_transposed_async<T::kThreads>(slab_t + a.de * T::kLdT, T::kLdT,
                                          a.dist + (size_t)t.row0 * n * a.dd, a.dd, t.pairs, a.dd);
  copy_rows_async<T::kThreads>(nj_s, dh, a.node_j + (size_t)t.b * n * dh, dh, n, dh);
  copy_rows_async<T::kThreads>(ni_s, dh, a.node_i + (size_t)t.row0 * dh, dh, t.rows, dh);
  copy_async<T::kThreads>(adj_s, a.adj + (size_t)t.row0 * n * n_adj, t.pairs * n_adj);
  copy_async<T::kThreads>(mask_s, a.mask + (size_t)t.row0 * n, t.pairs);
  copy_async<T::kThreads>(normed_s, a.normed + (size_t)t.row0 * n * 3, t.pairs * 3);
  cp_async_commit();  // lands by the product's first wait
  const Weight wed{a.we, a.wd, a.de, a.de + a.dd, dh}, w0{a.w0, a.w0, dh, dh, dh};
  start_ring<TR>(wed, ring);

  // pair = (node_i + node_j) + [edge | dist] @ [We; Wd] + bias, and its
  // row sums
  float acc[8][8];
  tile_product<TR>(acc, slab_t, t.pairs, wed, ring);
  start_ring<TR>(w0, ring);  // W0's first chunks come in under the LayerNorm
  float bias[8];  // the thread's columns of bias
#pragma unroll
  for (int q = 0; q < 8; ++q) bias[q] = col_of(q) < dh ? __ldg(a.bias + col_of(q)) : 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = imin(row_of(m), t.pairs - 1);  // rows past the tile repeat its last
    const int r = p / n;
    const float* ni = ni_s + r * dh;
    const float* nj = nj_s + (p - r * n) * dh;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col_of(4 * h);
      float* x = acc[m] + 4 * h;
      if (c0 < dh) {
        const float4 vi = *reinterpret_cast<const float4*>(ni + c0);
        const float4 vj = *reinterpret_cast<const float4*>(nj + c0);
        x[0] = (vi.x + vj.x) + x[0] + bias[4 * h];
        x[1] = (vi.y + vj.y) + x[1] + bias[4 * h + 1];
        x[2] = (vi.z + vj.z) + x[2] + bias[4 * h + 2];
        x[3] = (vi.w + vj.w) + x[3] + bias[4 * h + 3];
        s += (x[0] + x[1]) + (x[2] + x[3]);
      } else {
        x[0] = x[1] = x[2] = x[3] = 0.f;
      }
    }
    s = lanes_sum(s);
    if (lc == 0) red_s[row_of(m) * 4 + wc] = s;
  }
  __syncthreads();

  // LayerNorm (no affine, two passes) and modulation, in the registers
  float mu[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float* rs = red_s + row_of(m) * 4;
    mu[m] = (((rs[0] + rs[1]) + rs[2]) + rs[3]) / dh;
  }
  __syncthreads();  // the means are read: the variances take their place
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float d = acc[m][q] - mu[m];
      if (col_of(q) < dh) v = fmaf(d, d, v);
    }
    v = lanes_sum(v);
    if (lc == 0) red_s[row_of(m) * 4 + wc] = v;
  }
  __syncthreads();
  float gain[8], shift[8];  // 1 + scale and shift of the thread's columns
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = col_of(q);
    gain[q] = c < dh ? 1.f + __ldg(a.scale + (size_t)t.b * dh + c) : 0.f;
    shift[q] = c < dh ? __ldg(a.shift + (size_t)t.b * dh + c) : 0.f;
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float* rv = red_s + row_of(m) * 4;
    const float r = 1.f / sqrtf((((rv[0] + rv[1]) + rv[2]) + rv[3]) / dh + a.eps);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = (acc[m][q] - mu[m]) * r * gain[q] + shift[q];
  }
  // the modulated pairs, transposed, over the slab: every thread is past
  // the product and the reads of node_i and node_j (the barriers above)
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = col_of(q);
    if (c < dh) {
      float* d = pair_t + c * T::kLdT + row_of(0);
      *reinterpret_cast<float4*>(d) = make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
      *reinterpret_cast<float4*>(d + 4) = make_float4(acc[4][q], acc[5][q], acc[6][q], acc[7][q]);
    }
  }

  // g = silu(pair @ W0 + b0) @ W1: each thread's 8 columns, the 8 lanes of
  // its rows by shuffles, then the 4 warps in order
  tile_product<TR>(acc, pair_t, t.pairs, w0, ring);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = col_of(q);
    const float b = c < dh ? __ldg(a.b0 + c) : 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m][q] = silu(acc[m][q] + b);
  }
  for (int g = 0; g < n_gate; ++g) {
    float wg[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = col_of(q);
      wg[q] = c < dh ? __ldg(a.w1 + (size_t)c * n_gate + g) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) s = fmaf(acc[m][q], wg[q], s);
      s = lanes_sum(s);
      if (lc == 0) red_s[(row_of(m) * 4 + wc) * kMaxGate + g] = s;
    }
  }
  __syncthreads();

  // gate = mean(tanh(g) * [1, adj]) * mask, then out_i = sum_j normed_diff * gate
  for (int p = threadIdx.x; p < t.pairs; p += T::kThreads) {
    float gsum = 0.f;
    for (int g = 0; g < n_gate; ++g) {
      const float* rg = red_s + p * 4 * kMaxGate + g;
      const float v = tanhf(((rg[0] + rg[kMaxGate]) + rg[2 * kMaxGate]) + rg[3 * kMaxGate]);
      gsum += g == 0 ? v : v * adj_s[p * n_adj + g - 1];
    }
    gate_s[p] = gsum / n_gate * mask_s[p];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < t.rows * 3; idx += T::kThreads) {
    const int r = idx / 3;
    const int d = idx - r * 3;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(normed_s[(r * n + j) * 3 + d], gate_s[r * n + j], o);
    a.out[(size_t)(t.row0 + r) * 3 + d] = o;
  }
}

Prepared prepared[2];  // the kernels of 64 and 32 rows a tile

const void* kernel_of(const Plan& p) {
  return p.tile_rows == 64 ? (const void*)equi_update_kernel<64>
                           : (const void*)equi_update_kernel<32>;
}

}  // namespace

// plan: the wrapper's launch plan (rows a tile, rows of its molecule, tiles
// a molecule, blocks, threads, shared-memory bytes, blocks an SM), which
// must equal this file's. Launches on `stream`; the caller checked shapes,
// types and contiguity. Returns the first CUDA error, so that a refused
// launch is seen at once.
extern "C" int dstt_equi_update(
    const float* node_i, const float* node_j, const float* edge,
    const float* dist, const float* normed, const float* adj,
    const float* mask, const float* we, const float* wd, const float* bias,
    const float* shift, const float* scale, const float* w0, const float* b0,
    const float* w1, float* out, int batch, int n, int de, int dd, int dh,
    int n_adj, float eps, const int* plan, int n_plan, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || de < 1 || dd < 1 || dh < 1 || dh > kCols ||
      dh % 4 != 0 || n_adj < 0 || 1 + n_adj > kMaxGate) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(batch, n, de, dd, dh);
  if (!plan_matches(p, plan, n_plan)) return (int)cudaErrorInvalidValue;
  Args a{node_i, node_j, edge, dist, normed, adj, mask, we, wd, bias, shift, scale, w0, b0, w1,
         out, n, de, dd, dh, n_adj, p.rows_per_tile, p.tiles, eps};
  return (int)launch(prepared[p.tile_rows == 64 ? 0 : 1], kernel_of(p), p, a, stream);
}

// Blocks an SM of the kernel at these shapes, as the card reports it.
extern "C" int dstt_equi_update_occupancy(int batch, int n, int de, int dd, int dh,
                                          int* blocks) {
  const Plan p = make_plan(batch, n, de, dd, dh);
  if (p.tile_rows == 0) return (int)cudaErrorInvalidValue;
  return (int)occupancy(prepared[p.tile_rows == 64 ? 0 : 1], kernel_of(p), p, blocks);
}
