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
//
// bf16 operands (equi_update_kernel<TR, true>; the JAX DMT in bf16 passes
// node_i, node_j, edge, dist, We, Wd and the bias so, the rest in f32).
// [edge | dist] @ [We; Wd] runs on the tensor cores (row_tile.cuh's
// mma_product: mma.sync m16n8k16 bf16 with f32 sums, exact products, so
// only the order of the sums differs from f32): the slab comes in as rows
// of pairs ([TR, De + Dd] bf16, De and Dd multiples of 16), We and then Wd
// whole into one [max(De, Dd), 256] bf16 tile. The epilogue works on the
// mma fragments (rows g, g + 8; columns 2t, 2t + 1 of each n8 tile): a
// row's sums over 4 lanes by shuffles, then over the 2 column warps in
// order; the modulated pairs go, transposed, over the slab as the f32 left
// operand of the W0 product, and the LayerNorm -> W0 -> silu -> W1 chain
// is the f32 path's, since W0 is an f32 parameter. Shared memory, bytes:
// max(Dh (TR + 4) 4, (TR (De + Dd + 8) + (N + R) ld16(Dh)) 2) for the slab,
// node_j and node_i, then the pairs; max(ring, max(De, Dd) 264 2) for the
// weight tile, then the ring; the rest as f32: 109,312 bytes for TR = 64
// at the flagship widths (two blocks an SM) and 73,600 for TR = 32.
//
// Dd = 1 (the DMT's dist_gbf=False: the raw distance, not its Gaussian
// basis). In f32 the [edge | dist] product takes K = De + 1 as any other
// depth (its last ring chunk short). In bf16 a 1-deep product cannot be an
// mma operand, whose k is 16: the tile would have to load Wd as a 16-row
// operand and the slab carry 15 zero columns a pair, or the wrapper write a
// [B, N, N, 16] zero-padded copy of dist on every call. Instead the product
// dist_ij Wd[0, :] is an outer product, folded into the f32 epilogue beside
// the bias: each thread reads the distance of its two fragment rows and Wd's
// values at its columns from device memory (bf16 x bf16 is exact in f32, so
// only the order of the sums differs from the plain version), the slab holds
// the edge rows alone ([TR, ld16(De)]) and the Wd chunk of the tensor-core
// product is skipped. Shared memory as above with De + Dd read as De.

#include "row_tile.cuh"

namespace {

using namespace dstt;
using namespace dstt::rows;

constexpr int kMaxGate = 4;  // 1 + A adjacency gates

struct Args {
  const void *node_i, *node_j, *edge, *dist;  // float, or bf16 (16 raw bits) with kBf16
  const float *normed, *adj, *mask;
  const void *we, *wd, *bias;                 // float, or bf16 with kBf16
  const float *shift, *scale, *w0, *b0, *w1;
  float* out;
  int n, de, dd, dh, n_adj, rows_per_tile, tiles;
  float eps;
};

// The bf16 slab's columns a pair: edge | dist, or the edge alone where a
// 1-wide dist is folded into the epilogue.
__host__ __device__ inline int bf16_slab_width(int de, int dd) { return dd == 1 ? de : de + dd; }

// Shared-memory floats of a tile of tr rows: the slab, node_j and node_i,
// then the transposed pairs over them; the ring (then the gates), which
// with bf16 operands first holds the weight tile.
__host__ __device__ inline int front_floats(int tr, int n, int r, int de, int dd, int dh,
                                            bool bf16) {
  if (bf16) {
    return imax(dh * (tr + 4), (tr * ld16(bf16_slab_width(de, dd)) + (n + r) * ld16(dh)) / 2);
  }
  return imax(dh * (tr + 4), (de + dd) * (tr + 4) + (n + r) * dh);
}
__host__ __device__ inline int weight_floats(int de, int dd, bool bf16) {
  return bf16 ? imax(kRing, imax(de, dd) * kMmaLd / 2) : kRing;
}

// The row sums of 4 warps for up to kMaxGate gates; adj, the mask and
// normed_diff of the tile's pairs.
Plan make_plan(int batch, int n, int de, int dd, int dh, bool bf16) {
  return plan_rows(batch, n, [&](int tr, int r) {
    return front_floats(tr, n, r, de, dd, dh, bf16) + weight_floats(de, dd, bf16) +
           tr * 4 * kMaxGate + tr * (kMaxGate + 3);
  });
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// The tile's shared memory past the front and the weights.
struct Tail {
  float *red_s, *adj_s, *mask_s, *normed_s;
};
template <int TR>
__device__ __forceinline__ Tail tail_of(float* ring) {
  Tail s;
  s.red_s = ring;                                 // [TR, 4 warps, kMaxGate] row sums
  s.adj_s = s.red_s + TR * 4 * kMaxGate;          // [TR, A]
  s.mask_s = s.adj_s + TR * (kMaxGate - 1);       // [TR]
  s.normed_s = s.mask_s + TR;                     // [TR, 3]
  return s;
}

// g = silu(pair @ W0 + b0) @ W1 from the modulated pairs pair_t [Dh, kLdT]
// (W0's first chunks in the ring, or on their way): each thread's 8
// columns, the 8 lanes of its rows by shuffles, then the 4 warps in order;
// then gate = mean(tanh(g) * [1, adj]) * mask and out_i = sum_j
// normed_diff * gate.
template <int TR>
__device__ inline void gate_and_sum(const Args& a, const Tile& t, const float* pair_t,
                                    const Weight& w0, float* ring, const Tail& s) {
  using T = Tiling<TR>;
  const int n = a.n, dh = a.dh, n_adj = a.n_adj, n_gate = 1 + n_adj;
  const int wc = warp_col(), lc = lane_col();
  float acc[8][8];
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
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum = fmaf(acc[m][q], wg[q], sum);
      sum = lanes_sum(sum);
      if (lc == 0) s.red_s[(row_of(m) * 4 + wc) * kMaxGate + g] = sum;
    }
  }
  __syncthreads();

  float* gate_s = ring;  // [TR], the ring being free
  for (int p = threadIdx.x; p < t.pairs; p += T::kThreads) {
    float gsum = 0.f;
    for (int g = 0; g < n_gate; ++g) {
      const float* rg = s.red_s + p * 4 * kMaxGate + g;
      const float v = tanhf(((rg[0] + rg[kMaxGate]) + rg[2 * kMaxGate]) + rg[3 * kMaxGate]);
      gsum += g == 0 ? v : v * s.adj_s[p * n_adj + g - 1];
    }
    gate_s[p] = gsum / n_gate * s.mask_s[p];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < t.rows * 3; idx += T::kThreads) {
    const int r = idx / 3;
    const int d = idx - r * 3;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(s.normed_s[(r * n + j) * 3 + d], gate_s[r * n + j], o);
    a.out[(size_t)(t.row0 + r) * 3 + d] = o;
  }
}

// adj, the mask and normed_diff of the tile's pairs by cp.async; the
// caller commits.
template <int TR>
__device__ __forceinline__ void copy_pair_data(const Args& a, const Tile& t, const Tail& s) {
  using T = Tiling<TR>;
  copy_async<T::kThreads>(s.adj_s, a.adj + (size_t)t.row0 * a.n * a.n_adj, t.pairs * a.n_adj);
  copy_async<T::kThreads>(s.mask_s, a.mask + (size_t)t.row0 * a.n, t.pairs);
  copy_async<T::kThreads>(s.normed_s, a.normed + (size_t)t.row0 * a.n * 3, t.pairs * 3);
}

template <int TR>
__device__ inline void equi_update_f32(const Args& a, float* smem) {
  using T = Tiling<TR>;
  const Tile t = tile_of(a.n, a.rows_per_tile, a.tiles);
  const int n = a.n, dh = a.dh;
  const int wc = warp_col(), lc = lane_col();
  float* slab_t = smem;                               // [De + Dd, kLdT]: edge | dist, transposed
  float* nj_s = slab_t + (a.de + a.dd) * T::kLdT;     // [n, Dh]
  float* ni_s = nj_s + n * dh;                        // [R, Dh]
  float* pair_t = smem;                               // [Dh, kLdT], over the above
  float* ring = smem + front_floats(TR, n, a.rows_per_tile, a.de, a.dd, dh, false);
  const Tail s = tail_of<TR>(ring + weight_floats(a.de, a.dd, false));

  copy_rows_transposed_async<T::kThreads>(
      slab_t, T::kLdT, static_cast<const float*>(a.edge) + (size_t)t.row0 * n * a.de, a.de,
      t.pairs, a.de);
  copy_rows_transposed_async<T::kThreads>(
      slab_t + a.de * T::kLdT, T::kLdT,
      static_cast<const float*>(a.dist) + (size_t)t.row0 * n * a.dd, a.dd, t.pairs, a.dd);
  copy_rows_async<T::kThreads>(nj_s, dh, static_cast<const float*>(a.node_j) + (size_t)t.b * n * dh,
                               dh, n, dh);
  copy_rows_async<T::kThreads>(ni_s, dh, static_cast<const float*>(a.node_i) + (size_t)t.row0 * dh,
                               dh, t.rows, dh);
  copy_pair_data<TR>(a, t, s);
  cp_async_commit();  // lands by the product's first wait
  const Weight wed{static_cast<const float*>(a.we), static_cast<const float*>(a.wd), a.de,
                   a.de + a.dd, dh};
  const Weight w0{a.w0, a.w0, dh, dh, dh};
  start_ring<TR>(wed, ring);

  // pair = (node_i + node_j) + [edge | dist] @ [We; Wd] + bias, and its
  // row sums
  float acc[8][8];
  tile_product<TR>(acc, slab_t, t.pairs, wed, ring);
  start_ring<TR>(w0, ring);  // W0's first chunks come in under the LayerNorm
  const float* bias_p = static_cast<const float*>(a.bias);
  float bias[8];  // the thread's columns of bias
#pragma unroll
  for (int q = 0; q < 8; ++q) bias[q] = col_of(q) < dh ? __ldg(bias_p + col_of(q)) : 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = imin(row_of(m), t.pairs - 1);  // rows past the tile repeat its last
    const int r = p / n;
    const float* ni = ni_s + r * dh;
    const float* nj = nj_s + (p - r * n) * dh;
    float sum = 0.f;
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
        sum += (x[0] + x[1]) + (x[2] + x[3]);
      } else {
        x[0] = x[1] = x[2] = x[3] = 0.f;
      }
    }
    sum = lanes_sum(sum);
    if (lc == 0) s.red_s[row_of(m) * 4 + wc] = sum;
  }
  __syncthreads();

  // LayerNorm (no affine, two passes) and modulation, in the registers
  float mu[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float* rs = s.red_s + row_of(m) * 4;
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
    if (lc == 0) s.red_s[row_of(m) * 4 + wc] = v;
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
    const float* rv = s.red_s + row_of(m) * 4;
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
  gate_and_sum<TR>(a, t, pair_t, w0, ring, s);
}

// The sum over the 4 lanes t of a fragment row, in a fixed order, on each
// of them.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int TR>
__device__ inline void equi_update_bf16(const Args& a, float* smem) {
  using T = Tiling<TR>;
  const Tile t = tile_of(a.n, a.rows_per_tile, a.tiles);
  const int n = a.n, dh = a.dh, de = a.de, dd = a.dd;
  const bool fold_dist = dd == 1;  // dist @ Wd as an outer product in the epilogue
  const int lds = ld16(bf16_slab_width(de, dd)), ldn = ld16(dh), wc = (threadIdx.x >> 5) & 1;
  const bool lead = (threadIdx.x & 3) == 0;  // lane t = 0 of its fragment rows
  uint16_t* slab_s = reinterpret_cast<uint16_t*>(smem);  // [TR, lds]: edge | dist rows
  uint16_t* nj_s = slab_s + TR * lds;                    // [n, ldn]
  uint16_t* ni_s = nj_s + n * ldn;                       // [R, ldn]
  float* pair_t = smem;                                  // [Dh, kLdT], over the above
  float* ring = smem + front_floats(TR, n, a.rows_per_tile, de, dd, dh, true);
  uint16_t* w_s = reinterpret_cast<uint16_t*>(ring);     // [max(De, Dd), kMmaLd]: We; then Wd
  const Tail s = tail_of<TR>(ring + weight_floats(de, dd, true));
  const uint16_t* dist = static_cast<const uint16_t*>(a.dist) + (size_t)t.row0 * n * dd;

  copy_bf16_rows_async<T::kThreads>(
      slab_s, lds, static_cast<const uint16_t*>(a.edge) + (size_t)t.row0 * n * de, de, t.pairs, de);
  if (!fold_dist) copy_bf16_rows_async<T::kThreads>(slab_s + de, lds, dist, dd, t.pairs, dd);
  copy_bf16_rows_async<T::kThreads>(
      nj_s, ldn, static_cast<const uint16_t*>(a.node_j) + (size_t)t.b * n * dh, dh, n, dh);
  copy_bf16_rows_async<T::kThreads>(
      ni_s, ldn, static_cast<const uint16_t*>(a.node_i) + (size_t)t.row0 * dh, dh, t.rows, dh);
  copy_pair_data<TR>(a, t, s);
  load_weight_bf16<T::kThreads>(w_s, static_cast<const uint16_t*>(a.we), de, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // pair = (node_i + node_j) + edge @ We + dist @ Wd + bias, and its row sums
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  mma_product(acc, slab_s, lds, 0, de, w_s, t.pairs);
  if (!fold_dist) {
    __syncthreads();  // every warp is done with We: Wd takes its place
    load_weight_bf16<T::kThreads>(w_s, static_cast<const uint16_t*>(a.wd), dd, dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mma_product(acc, slab_s, lds, de, dd, w_s, t.pairs);
  }
  __syncthreads();  // every warp is done with the weight tile: W0's first chunks take its place
  const Weight w0{a.w0, a.w0, dh, dh, dh};
  start_ring<TR>(w0, ring);

  const uint16_t* bias = static_cast<const uint16_t*>(a.bias);
  const uint16_t* wd = static_cast<const uint16_t*>(a.wd);  // [1, Dh] where fold_dist
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = imin(frag_row(h), t.pairs - 1);  // rows past the tile repeat its last
    const int r = p / n;
    const uint16_t* ni = ni_s + r * ldn;
    const uint16_t* nj = nj_s + (p - r * n) * ldn;
    const float dv = fold_dist ? bf16_to_float(__ldg(dist + p)) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = frag_col(nt);
      float* x = acc[nt] + 2 * h;
      if (c < dh) {
        const float2 vi = bf16x2_to_float2(ni + c), vj = bf16x2_to_float2(nj + c);
        if (fold_dist) {
          x[0] = fmaf(dv, bf16_to_float(__ldg(wd + c)), x[0]);
          x[1] = fmaf(dv, bf16_to_float(__ldg(wd + c + 1)), x[1]);
        }
        x[0] = (vi.x + vj.x) + x[0] + bf16_to_float(__ldg(bias + c));
        x[1] = (vi.y + vj.y) + x[1] + bf16_to_float(__ldg(bias + c + 1));
        sum[h] += x[0] + x[1];
      } else {
        x[0] = x[1] = 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] = quad_sum(sum[h]);
    if (lead) s.red_s[frag_row(h) * 4 + wc] = sum[h];
  }
  __syncthreads();

  // LayerNorm (no affine, two passes) and modulation, in the registers
  float mu[2], var[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* rs = s.red_s + frag_row(h) * 4;
    mu[h] = (rs[0] + rs[1]) / dh;
  }
  __syncthreads();  // the means are read: the variances take their place
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (frag_col(nt) < dh) {
        const float d0 = acc[nt][2 * h] - mu[h], d1 = acc[nt][2 * h + 1] - mu[h];
        var[h] = fmaf(d1, d1, fmaf(d0, d0, var[h]));
      }
    }
    var[h] = quad_sum(var[h]);
    if (lead) s.red_s[frag_row(h) * 4 + wc] = var[h];
  }
  __syncthreads();
  float rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* rv = s.red_s + frag_row(h) * 4;
    rstd[h] = 1.f / sqrtf((rv[0] + rv[1]) / dh + a.eps);
  }
  // the modulated pairs, transposed, over the slab: every thread is past
  // the products and the reads of node_i and node_j (the barriers above)
  const float* scale = a.scale + (size_t)t.b * dh;
  const float* shift = a.shift + (size_t)t.b * dh;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = frag_col(nt);
    if (c < dh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gain = 1.f + __ldg(scale + c + e), sh = __ldg(shift + c + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pair_t[(c + e) * T::kLdT + frag_row(h)] =
              (acc[nt][2 * h + e] - mu[h]) * rstd[h] * gain + sh;
        }
      }
    }
  }
  gate_and_sum<TR>(a, t, pair_t, w0, ring, s);
}

template <int TR, bool kBf16>
__global__ void __launch_bounds__(Tiling<TR>::kThreads, Tiling<TR>::kMinBlocks)
    equi_update_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kBf16) {
    equi_update_bf16<TR>(a, smem);
  } else {
    equi_update_f32<TR>(a, smem);
  }
}

Prepared prepared[4];  // the kernels of 64 and 32 rows a tile, f32 and bf16

int kernel_index(const Plan& p, bool bf16) { return (p.tile_rows == 64 ? 0 : 1) + (bf16 ? 2 : 0); }

const void* kernel_of(const Plan& p, bool bf16) {
  const void* kernels[4] = {(const void*)equi_update_kernel<64, false>,
                            (const void*)equi_update_kernel<32, false>,
                            (const void*)equi_update_kernel<64, true>,
                            (const void*)equi_update_kernel<32, true>};
  return kernels[kernel_index(p, bf16)];
}

}  // namespace

// node_i, node_j, edge, dist, we, wd, bias: float, or bf16 where bf16 is 1
// (then de a multiple of 16, dd one or a multiple of 16). plan: the wrapper's launch plan (rows a
// tile, rows of its molecule, tiles a molecule, blocks, threads,
// shared-memory bytes, blocks an SM), which must equal this file's.
// Launches on `stream`; the caller checked shapes, types and contiguity.
// Returns the first CUDA error, so that a refused launch is seen at once.
extern "C" int dstt_equi_update(
    const void* node_i, const void* node_j, const void* edge,
    const void* dist, const float* normed, const float* adj,
    const float* mask, const void* we, const void* wd, const void* bias,
    const float* shift, const float* scale, const float* w0, const float* b0,
    const float* w1, float* out, int batch, int n, int de, int dd, int dh,
    int n_adj, int bf16, float eps, const int* plan, int n_plan, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || de < 1 || dd < 1 || dh < 1 || dh > kCols ||
      dh % 4 != 0 || n_adj < 0 || 1 + n_adj > kMaxGate || (bf16 != 0 && bf16 != 1) ||
      (bf16 && (de % 16 != 0 || (dd % 16 != 0 && dd != 1)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(batch, n, de, dd, dh, bf16);
  if (!plan_matches(p, plan, n_plan)) return (int)cudaErrorInvalidValue;
  Args a{node_i, node_j, edge, dist, normed, adj, mask, we, wd, bias, shift, scale, w0, b0, w1,
         out, n, de, dd, dh, n_adj, p.rows_per_tile, p.tiles, eps};
  return (int)launch(prepared[kernel_index(p, bf16)], kernel_of(p, bf16), p, a, stream);
}

// Blocks an SM of the kernel at these shapes, as the card reports it.
extern "C" int dstt_equi_update_occupancy(int batch, int n, int de, int dd, int dh, int bf16,
                                          int* blocks) {
  const Plan p = make_plan(batch, n, de, dd, dh, bf16);
  if (p.tile_rows == 0) return (int)cudaErrorInvalidValue;
  return (int)occupancy(prepared[kernel_index(p, bf16)], kernel_of(p, bf16), p, blocks);
}
