// The whole pair-grid chain of one DMT EquivariantMixBlock, for Hopper
// (sm_90a), f32 on the CUDA cores.
//
// Replaces the TPU kernel diffspectra_tpu/ops/pallas_block.py::_kernel
// (entry point block_fused). For molecule b, rows i and pairs (i, j):
//
//   x        = d2 * (scale_t + 1) + shift_t,  gbf = [x, gauss(x; means, |stds| + 1e-5)]
//   e_attr   = gbf @ Kd + edge_in @ Ke + b
//   e_mod    = LN(e_attr) * (1 + e_scale_msa) + e_shift_msa
//   attn_i   = mixed attention over j, gated by tanh(e_mod @ W0a), tanh(e_mod @ W1a)
//   p        = attn @ Kn2e,  h_edge = p_i + p_j + b
//   h1       = (LN(h + gate_msa * attn) * (1 + scale_mlp) + shift_mlp) * nmask
//   h_out    = (h1 + gate_mlp * FFN(h1)) * nmask                    (256 -> 512 -> 256)
//   e_res    = LN(edge_in + e_gate_msa * h_edge) * (1 + e_scale_mlp) + e_shift_mlp
//   edge_out = e_res + e_gate_mlp * FFN(e_res)                      (64 -> 128 -> 64)
//   agg_i    = equivariant update on (h_out @ W_hi, h_out @ W_hj, edge_out, gbf)
//
// What bounds it on this card. At the serving shape (B=10, N=29, Dh=256,
// De=64) a pair costs about 0.31 MFLOP (edge_emb, the two gate products,
// the edge FFN, W_e/W_d and eq_k0) and a node about 0.82 MFLOP (n2e, the
// node FFN, W_hi/W_hj): about 2.9 GFLOP against some 8 MB of inputs and
// outputs, so in f32 on the CUDA cores (67 TFLOP/s, 3.35 TB/s) it is bound
// by operations.
//
// What the design does about it. Every product is a tile of rows held in
// shared memory times a weight that streams through shared memory in
// chunks of 8 rows (three chunks in flight by cp.async, 16-byte copies when
// the weight's rows allow it), computed by 256 threads that each own a
// register tile of TM rows x TN columns (columns 4 tx + 64 q, so that the
// float4 reads of a chunk meet no bank conflict). So a weight is read from
// L2 once per tile of rows, never per row. The chain needs every row j of a
// molecule at two points (p_j, and node_j = h_out_j @ W_hj), so it runs as
// five launches in stream order, the node tensors attn, h1, the FFN middle,
// p, node_i and node_j passing through device memory (1.9 MB at the
// serving shape); the launch plan (ops/block_fused.py::launch_plan) is
// computed by the wrapper and checked here against this file's own
// arithmetic (make_plan).
//   A  attn_stage: one block per tile of R rows of one molecule, R N <= 64
//      pairs: R = 64 / N, or 2 where that would leave SMs idle (R = 2 at
//      B=10 for N = 17..29: 90-150 blocks; R = 3 at B=80, N = 21: 560
//      blocks; R = 2 at B=80, N = 29: 1200 blocks). 100,352 bytes of
//      shared memory at the flagship widths, so two blocks an SM (one wave
//      of 150 on 132 SMs): the tile's gbf and edge_in (edge_in by
//      cp.async), e_mod, the q k tanh(e0) products and then the messages
//      [64, 256], the softmax weights, the weight ring. Weights: Kd with Ke
//      (one product over [gbf | edge_in]), W0a, W1a: 159 KB a tile,
//      24.4 MB a call at B=10, N=29. q_i k_j and alpha v_j are loaded
//      before their product, so that the product hides their latency.
//      Writes attn [B, N, H C].
//   N1 node_in_stage, N2 node_out_stage, N3 node_proj_stage: tiles of 16 to
//      31 rows over all B N rows (B N / 16 tiles, rows split evenly: 18
//      tiles at B N = 290), times column tiles: N1 computes h1 (the node
//      residual's LayerNorm needs whole rows, so each block holds its rows
//      entire) and silu(h1 @ fn1 + b) in 128-column tiles, and p = attn @
//      n2e; N2 h_out from fn2 in 64-column tiles; N3 [node_i | node_j] =
//      h_out @ [W_hi | W_hj] in 128-column tiles: 90, 72 and 72 blocks at
//      B N = 290, 45,568-72,192 bytes of shared memory. Every node weight is read
//      once a row tile: 1.6 MB a tile, 29.5 MB a call at B N = 290.
//   B  pair_stage: the tiles of A. 114,944 bytes of shared memory, two
//      blocks an SM: gbf, e_res then edge_out (in place), the edge FFN's middle then
//      the pair vectors [64, 256], the W1 sums, the gates, the weight ring.
//      Weights: fe1, fe2, W_e with W_d (one product over [edge_out | gbf])
//      and eq_k0: 448 KB a tile, 68.8 MB a call at B=10, N=29. The W1
//      product is reduced over each row's 16 column threads by shuffles,
//      then over the column passes in order, so the result does not depend
//      on timing.
// No [B, N, N, > 3] intermediate other than edge_out reaches device memory,
// as on the TPU. The products are f32 on the CUDA cores: a 3xTF32 version
// (mma.sync, three products on the TF32 halves) held the 1e-4 tolerance on
// the H100 but was no faster (PERF.md), so it is not used.
//
// q, k and v are float32 or bfloat16 (the JAX DMT in bfloat16 passes them
// so): attn_stage<T> reads them as T where it loads them, and computes in
// float32 from their values, as the Pallas kernel does. Every other operand
// is float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "async_copy.cuh"

namespace {

using dstt::cp_async16;
using dstt::cp_async4;
using dstt::cp_async_commit;
using dstt::cp_async_wait;

constexpr int kThreads = 256;   // 16 x 16 threads: tx owns columns, ty rows
constexpr int kPairRows = 64;   // pairs of a stage A / B tile
constexpr int kNodeRows = 32;   // rows of a node tile, at most (16 at least)
constexpr int kMaxN = 32;
constexpr int kMaxGate = 4;     // 1 + A adjacency gates of the equi chain
constexpr int kSms = 132;       // H100 SXM
constexpr int kMaxSmem = 232448;
constexpr float kMaskInf = -1e30f;  // padding and the diagonal
constexpr float kNegAdj = -1e10f;   // an adjacency head's zero entry

constexpr int kBufs = 48;  // pointers a call takes, in Args order
constexpr int kDims = 13;  // ints a call takes, in dstt_block_fused order
constexpr int kPlan = 13;  // launch-plan ints, in Plan order

struct Args {
  // per-molecule data
  const float* h;
  const void *q, *k, *v;  // float or bf16: attn_stage's template type
  const float *edge_in, *d2, *normed, *adj, *emask, *nmask;
  const float *nmods, *emods, *eqss, *gbfss;
  // weights
  const float *means, *stds, *emb_kd, *emb_ke, *emb_b, *w0a, *w1a, *n2e_k, *n2e_b;
  const float *fn1_k, *fn1_b, *fn2_k, *fn2_b, *fe1_k, *fe1_b, *fe2_k, *fe2_b;
  const float *w_hi, *w_hj, *w_e, *w_d, *eq_b, *eq_k0, *eq_b0, *eq_k1;
  // outputs
  float *h_out, *edge_out, *agg;
  // passed between the launches: attn [B,N,HC], h1 [B,N,Dh], mid [B,N,rn],
  // p [B,N,De], node_i and node_j [B,N,Dh]
  float *attn, *h1, *mid, *p, *node_i, *node_j;
  int n, dh, de, ec, sub_c, heads, out_ch, n_extra, rn, re, set_inf;
  int rows_per_tile, tiles, node_tiles, m_rows;  // from the plan
  float eps, sqrt_c;
};

// The launch plan, in the order of the wrapper's ints.
struct Plan {
  int rows_per_tile, tiles, node_tiles;
  int grid_a, smem_a, grid_n1, smem_n1, grid_n2, smem_n2, grid_n3, smem_n3, grid_b, smem_b;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// Row stride of a tile of `width` floats: a multiple of 4 floats (16-byte
// rows) plus 4, so that rows 4 and 8 apart fall in other banks.
__host__ __device__ inline int ld_of(int width) { return ((width + 3) & ~3) + 4; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }


// ---- the tile product ---------------------------------------------------

// The shape of a tile product: 256 threads, 16 down the rows (ty) and 16
// across the columns (tx), each owning TM rows x TN columns of the output
// in registers; the weight streams through a ring of kStages chunks of kKc
// rows.
constexpr int kKc = 8;      // weight rows a chunk
constexpr int kStages = 3;  // chunks in flight
template <int TM_, int TN_>
struct Shape {
  static constexpr int TM = TM_, TN = TN_;
  static constexpr int kRows = 16 * TM, kCols = 16 * TN, kRing = kStages * kKc * kCols;
};
using PairWide = Shape<4, 8>;    // 64 x 128
using PairNarrow = Shape<4, 4>;  // 64 x 64
using NodeWide = Shape<2, 8>;    // 32 x 128
using NodeNarrow = Shape<2, 4>;  // 32 x 64
static_assert(PairWide::kRows == kPairRows && NodeWide::kRows == kNodeRows, "tile rows");

// Four k steps of the register tile: TM row values as float4 along k
// (broadcast reads) times TN weight values a step (float4 reads,
// conflict-free across tx).
template <class S>
__device__ __forceinline__ void fma_step4(float (&acc)[S::TM][S::TN], const float* a, int lda,
                                          const float* w) {
  float4 av[S::TM];
#pragma unroll
  for (int m = 0; m < S::TM; ++m) av[m] = *reinterpret_cast<const float4*>(a + m * lda);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < S::TN / 4; ++h) {
      const float4 b = *reinterpret_cast<const float4*>(w + kk * S::kCols + 64 * h);
#pragma unroll
      for (int m = 0; m < S::TM; ++m) {
        const float x = kk == 0 ? av[m].x : kk == 1 ? av[m].y : kk == 2 ? av[m].z : av[m].w;
        acc[m][4 * h + 0] = fmaf(x, b.x, acc[m][4 * h + 0]);
        acc[m][4 * h + 1] = fmaf(x, b.y, acc[m][4 * h + 1]);
        acc[m][4 * h + 2] = fmaf(x, b.z, acc[m][4 * h + 2]);
        acc[m][4 * h + 3] = fmaf(x, b.w, acc[m][4 * h + 3]);
      }
    }
  }
}

// One k step, for the last chunk of a K that is not a multiple of kKc.
template <class S>
__device__ __forceinline__ void fma_step(float (&acc)[S::TM][S::TN], const float* a, int lda,
                                         const float* w) {
#pragma unroll
  for (int h = 0; h < S::TN / 4; ++h) {
    const float4 b = *reinterpret_cast<const float4*>(w + 64 * h);
#pragma unroll
    for (int m = 0; m < S::TM; ++m) {
      const float x = a[m * lda];
      acc[m][4 * h + 0] = fmaf(x, b.x, acc[m][4 * h + 0]);
      acc[m][4 * h + 1] = fmaf(x, b.y, acc[m][4 * h + 1]);
      acc[m][4 * h + 2] = fmaf(x, b.z, acc[m][4 * h + 2]);
      acc[m][4 * h + 3] = fmaf(x, b.w, acc[m][4 * h + 3]);
    }
  }
}

// acc[m][q] += A[row, 0:K] @ W[0:K, col] for row = ty * TM + m and
// col = col0 + 64 * (q / 4) + 4 * tx + q % 4, with A [rows, K] in shared
// memory (row stride lda, a multiple of 4, 16-byte aligned) and W [K, M] in
// device memory, streamed through `ring` by cp.async (16-byte copies when
// W's rows allow them). Columns at or past M and weight rows at or past K
// are copied as zeros. Ends with a barrier, so that the caller may
// overwrite A or reuse the ring.
template <class S>
__device__ void mma_tile(float (&acc)[S::TM][S::TN], const float* A, int lda, int rows,
                         const float* __restrict__ W, int K, int M, int col0, float* ring) {
  constexpr int kCols = S::kCols, kChunk = kKc * kCols;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool wide = (M % 4 == 0) && ((reinterpret_cast<uintptr_t>(W) & 15) == 0);
  const int n_chunks = cdiv(K, kKc);
  auto load = [&](int chunk) {
    float* dst = ring + (chunk % kStages) * kChunk;
    const int k0 = chunk * kKc;
    for (int idx = tid; idx < kChunk / 4; idx += kThreads) {
      const int kk = idx / (kCols / 4);
      const int c = col0 + 4 * (idx - kk * (kCols / 4));
      const int k = k0 + kk;
      float* d = dst + kk * kCols + (c - col0);
      if (wide) {
        const bool in = k < K && c < M;
        cp_async16(d, in ? W + (size_t)k * M + c : W, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = k < K && c + e < M;
          cp_async4(d + e, in ? W + (size_t)k * M + c + e : W, in ? 4 : 0);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s);
    cp_async_commit();
  }
  const bool active = ty * S::TM < rows;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk has landed for every thread; chunk - 1's slot is free
    if (chunk + kStages - 1 < n_chunks) load(chunk + kStages - 1);
    cp_async_commit();
    if (active) {
      const float* w = ring + (chunk % kStages) * kChunk + 4 * tx;
      const float* a = A + (size_t)(ty * S::TM) * lda + chunk * kKc;
      const int kn = K - chunk * kKc;
      if (kn >= kKc) {
#pragma unroll
        for (int kk = 0; kk < kKc; kk += 4) fma_step4<S>(acc, a + kk, lda, w + kk * kCols);
      } else {
        for (int kk = 0; kk < kn; ++kk) fma_step<S>(acc, a + kk, lda, w + kk * kCols);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <class S>
__device__ __forceinline__ void zero(float (&acc)[S::TM][S::TN]) {
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < S::TN; ++q) acc[m][q] = 0.f;
}

// The block-tile row and column of the thread's output (m, q).
template <class S>
__device__ __forceinline__ int out_row(int m) {
  return (threadIdx.x >> 4) * S::TM + m;
}
__device__ __forceinline__ int out_col(int col0, int q) {
  return col0 + 64 * (q >> 2) + 4 * (threadIdx.x & 15) + (q & 3);
}

// A1 @ W1 (+ A2 @ W2 when a2 is set): each A [rows, k] in shared memory at
// stride lda, each W [k, m] in device memory.
struct Product {
  const float *a1, *w1, *a2, *w2;
  int lda, rows, k, m;
};

// No value fetched before the product.
struct NoFetch {
  __device__ float operator()(int, int) const { return 0.f; }
};

// The product's columns [col_begin, col_end), kCols at a time:
// f(row, col, value, fetched) for each output inside [rows, m), where
// fetched = fetch(row, col) is loaded before the product, so that its
// latency hides under it (row and col clamped into range, so that every
// load is valid).
template <class S, class Fetch, class F>
__device__ void gemm(const Product& p, int col_begin, int col_end, float* ring, Fetch fetch, F f) {
  for (int col0 = col_begin; col0 < col_end; col0 += S::kCols) {
    float pre[S::TM][S::TN], acc[S::TM][S::TN];
#pragma unroll
    for (int m = 0; m < S::TM; ++m)
#pragma unroll
      for (int q = 0; q < S::TN; ++q) {
        pre[m][q] = fetch(min(out_row<S>(m), p.rows - 1), min(out_col(col0, q), p.m - 1));
        acc[m][q] = 0.f;
      }
    mma_tile<S>(acc, p.a1, p.lda, p.rows, p.w1, p.k, p.m, col0, ring);
    if (p.a2 != nullptr) mma_tile<S>(acc, p.a2, p.lda, p.rows, p.w2, p.k, p.m, col0, ring);
#pragma unroll
    for (int m = 0; m < S::TM; ++m) {
      const int row = out_row<S>(m);
      if (row >= p.rows) continue;
#pragma unroll
      for (int q = 0; q < S::TN; ++q) {
        const int col = out_col(col0, q);
        if (col < p.m) f(row, col, acc[m][q], pre[m][q]);
      }
    }
  }
}

template <class S, class Fetch, class F>
__device__ void gemm(const Product& p, float* ring, Fetch fetch, F f) {
  gemm<S>(p, 0, p.m, ring, fetch, f);
}

// ---- the launch plan ------------------------------------------------------

Plan make_plan(int batch, int n, int dh, int de, int ec, int hc, int heads, int rn, int re) {
  Plan p;
  int r = imax(1, kPairRows / n);
  if (r > n) r = n;
  if (batch * cdiv(n, r) < kSms && r > 2) r = 2;
  p.rows_per_tile = r;
  p.tiles = cdiv(n, r);
  const int m = batch * n;
  p.node_tiles = imax(1, m / 16);
  const int lde = ld_of(de);
  p.grid_a = batch * p.tiles;
  p.smem_a = 4 * (kPairRows * lde + imax(2 * kPairRows * lde, kPairRows * ld_of(imax(ec, hc))) +
                  kPairRows * heads + PairWide::kRing);
  p.grid_n1 = p.node_tiles * (cdiv(rn, NodeWide::kCols) + cdiv(de, NodeWide::kCols));
  p.smem_n1 = 4 * (kNodeRows * ld_of(dh) + NodeWide::kRing);
  p.grid_n2 = p.node_tiles * cdiv(dh, NodeNarrow::kCols);
  p.smem_n2 = 4 * (kNodeRows * ld_of(rn) + NodeNarrow::kRing);
  p.grid_n3 = p.node_tiles * 2 * cdiv(dh, NodeWide::kCols);
  p.smem_n3 = 4 * (kNodeRows * ld_of(dh) + NodeWide::kRing);
  p.grid_b = batch * p.tiles;
  p.smem_b = 4 * (2 * kPairRows * lde + kPairRows * imax(ld_of(re), ld_of(dh)) +
                  kPairRows * (kMaxGate + 1) + PairWide::kRing);
  return p;
}

// ---- row helpers --------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x[r] = (LN(x[r]) * (1 + scale[r]) + shift[r]) * mul[r] for `rows` rows of
// `width` floats at stride ld: no affine, two passes as in the JAX
// reference, one warp per row. row_mods(r, &shift, &scale, &mul) gives a
// row's modulation.
template <class Mods>
__device__ void ln_rows(float* x, int rows, int width, int ld, float eps, Mods row_mods) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    float* p = x + r * ld;
    const float* shift;
    const float* scale;
    float mul;
    row_mods(r, &shift, &scale, &mul);
    float s = 0.f;
    for (int u = lane; u < width; u += 32) s += p[u];
    const float mu = warp_sum(s) / width;
    float v = 0.f;
    for (int u = lane; u < width; u += 32) {
      const float t = p[u] - mu;
      v = fmaf(t, t, v);
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / width + eps);
    for (int u = lane; u < width; u += 32) {
      p[u] = ((p[u] - mu) * rs * (1.f + scale[u]) + shift[u]) * mul;
    }
  }
}

// The same modulation for every row.
__device__ void ln_rows(float* x, int rows, int width, int ld, float eps, const float* shift,
                        const float* scale) {
  ln_rows(x, rows, width, ld, eps, [&](int, const float** sh, const float** sc, float* mul) {
    *sh = shift;
    *sc = scale;
    *mul = 1.f;
  });
}

// The GBF distance features [pairs, de] (stride ld) of the tile's pairs,
// which are contiguous from pair row0 * n.
__device__ void gbf_rows(const Args& a, int b, int row0, int pairs, float* gbf_s, int ld) {
  constexpr float kPi = 3.14159f;  // the reference's value, kept for parity
  const float root = sqrtf(2.f * kPi);
  const float scale_t = a.gbfss[b * 2 + 0];
  const float shift_t = a.gbfss[b * 2 + 1];
  const float* d2 = a.d2 + (size_t)row0 * a.n;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < pairs * a.de; idx += kThreads) {
    const int p = idx / a.de;
    const int u = idx - p * a.de;
    const float x = d2[p] * (scale_t + 1.f) + shift_t;
    float g = x;
    if (u > 0) {
      const float std = fabsf(a.stds[u - 1]) + 1e-5f;
      const float z = (x - a.means[u - 1]) / std;
      g = expf(-0.5f * (z * z)) / (root * std);
    }
    gbf_s[p * ld + u] = g;
  }
}

// rows x width floats from src (stride src_ld) to dst (stride ld, a
// multiple of 4, 16-byte aligned) by cp.async, as one committed group; the
// caller waits for it (finish_copies).
__device__ void copy_rows_async(float* dst, int ld, const float* src, int src_ld, int rows,
                                int width) {
  if (width % 4 == 0 && src_ld % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int w4 = width / 4;
    for (int idx = threadIdx.x; idx < rows * w4; idx += kThreads) {
      const int r = idx / w4;
      const int c = 4 * (idx - r * w4);
      cp_async16(dst + r * ld + c, src + (size_t)r * src_ld + c, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
      const int r = idx / width;
      const int c = idx - r * width;
      cp_async4(dst + r * ld + c, src + (size_t)r * src_ld + c, 4);
    }
  }
  cp_async_commit();
}

// Every copy of this thread landed, and every thread got here.
__device__ __forceinline__ void finish_copies() {
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// The tile of a stage A / B block: molecule b, rows i0 .. i0 + rows - 1.
struct PairTile {
  int b, i0, rows, pairs, row0;
};
__device__ __forceinline__ PairTile pair_tile(const Args& a) {
  PairTile t;
  t.b = blockIdx.x / a.tiles;
  t.i0 = (blockIdx.x - t.b * a.tiles) * a.rows_per_tile;
  t.rows = min(a.rows_per_tile, a.n - t.i0);
  t.pairs = t.rows * a.n;
  t.row0 = t.b * a.n + t.i0;
  return t;
}

// The rows [r0, r1) of a node block's tile, and its column tile.
__device__ __forceinline__ void node_tile(const Args& a, int* r0, int* r1, int* ct) {
  const int t = blockIdx.x % a.node_tiles;
  *ct = blockIdx.x / a.node_tiles;
  *r0 = (int)((long long)t * a.m_rows / a.node_tiles);
  *r1 = (int)((long long)(t + 1) * a.m_rows / a.node_tiles);
}

// ---- stage A: edge embedding and mixed attention ------------------------

// A value of q, k or v as a float: float, or bf16 (its 16 raw bits).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) { return __uint_as_float(uint32_t(x) << 16); }

template <class T>
__global__ void __launch_bounds__(kThreads, 2) attn_stage(Args a) {
  extern __shared__ __align__(16) float smem[];
  const PairTile t = pair_tile(a);
  const int n = a.n, de = a.de, ec = a.ec, hc = a.dh, heads = a.heads;  // H C == Dh
  const int lde = ld_of(de), lpr = ld_of(imax(ec, hc));
  float* emod_s = smem;                              // [64, lde]
  float* u_s = emod_s + kPairRows * lde;             // edge_in, gbf; then q k e0; then messages
  float* edge_s = u_s;
  float* gbf_s = u_s + kPairRows * lde;
  float* alpha_s = u_s + imax(2 * kPairRows * lde, kPairRows * lpr);  // [64, heads]
  float* ring = alpha_s + kPairRows * heads;

  copy_rows_async(edge_s, lde, a.edge_in + (size_t)t.row0 * n * de, de, t.pairs, de);
  gbf_rows(a, t.b, t.row0, t.pairs, gbf_s, lde);
  finish_copies();

  // e_attr = gbf @ Kd + edge_in @ Ke + b, then its LayerNorm and modulation
  const Product emb{gbf_s, a.emb_kd, edge_s, a.emb_ke, lde, t.pairs, de, de};
  gemm<PairNarrow>(emb, ring, NoFetch(),
             [&](int p, int c, float v, float) { emod_s[p * lde + c] = v + a.emb_b[c]; });
  __syncthreads();
  const float* emods = a.emods + (size_t)t.b * 6 * de;  // shift, scale, gate (msa), ... (mlp)
  ln_rows(emod_s, t.pairs, de, lde, a.eps, emods, emods + de);
  __syncthreads();

  // q_i k_j tanh(e_mod @ W0a), the learned heads' products
  const T* q = static_cast<const T*>(a.q) + (size_t)t.row0 * ec;
  const T* kb = static_cast<const T*>(a.k) + (size_t)t.b * n * ec;
  const Product gate0{emod_s, a.w0a, nullptr, nullptr, lde, t.pairs, de, ec};
  gemm<PairWide>(
      gate0, ring,
      [&](int p, int c) {
        const int r = p / n;
        return to_float(q[r * ec + c]) * to_float(kb[(p - r * n) * ec + c]);
      },
      [&](int p, int c, float v, float qk) { u_s[p * lpr + c] = qk * tanhf(v); });
  __syncthreads();

  // logits: adjacency heads first, then the learned heads; masked
  const float* adj = a.adj + (size_t)t.row0 * n * a.n_extra;
  const float* emask = a.emask + (size_t)t.row0 * n;
  for (int idx = threadIdx.x; idx < t.pairs * heads; idx += kThreads) {
    const int p = idx / heads;
    const int h = idx - p * heads;
    float logit;
    if (h < a.n_extra) {
      logit = adj[p * a.n_extra + h];
      if (a.set_inf && logit == 0.f) logit = kNegAdj;
    } else {
      const float* pr = u_s + p * lpr + (h - a.n_extra) * a.sub_c;
      float s = 0.f;
      for (int u = 0; u < a.sub_c; ++u) s += pr[u];
      logit = s / a.sqrt_c;
    }
    alpha_s[idx] = emask[p] > 0.f ? logit : kMaskInf;
  }
  __syncthreads();

  // softmax over j for each row and head
  for (int idx = threadIdx.x; idx < t.rows * heads; idx += kThreads) {
    const int r = idx / heads;
    float* al = alpha_s + r * n * heads + (idx - r * heads);
    float mx = al[0];
    for (int j = 1; j < n; ++j) mx = fmaxf(mx, al[j * heads]);
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(al[j * heads] - mx);
      al[j * heads] = e;
      s += e;
    }
    for (int j = 0; j < n; ++j) al[j * heads] /= s;
  }
  __syncthreads();

  // messages alpha_ij v_j tanh(e_mod @ W1a), then their sum over j
  const T* vb = static_cast<const T*>(a.v) + (size_t)t.b * n * hc;
  const Product gate1{emod_s, a.w1a, nullptr, nullptr, lde, t.pairs, de, hc};
  gemm<PairWide>(
      gate1, ring,
      [&](int p, int c) {
        return alpha_s[p * heads + c / a.out_ch] * to_float(vb[(p % n) * hc + c]);
      },
      [&](int p, int c, float v, float av) { u_s[p * lpr + c] = av * tanhf(v); });
  __syncthreads();
  for (int idx = threadIdx.x; idx < t.rows * hc; idx += kThreads) {
    const int r = idx / hc;
    const int c = idx - r * hc;
    const float* msg = u_s + r * n * lpr + c;
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += msg[j * lpr];
    a.attn[(size_t)(t.row0 + r) * hc + c] = s;
  }
}

// ---- stages N1-N3: the node chain over row tiles -------------------------

// N1: column tiles of fn1 (h1 = the node residual's LayerNorm, modulated
// and masked; mid = silu(h1 @ fn1 + b)), then column tiles of n2e
// (p = attn @ n2e; its bias is added in stage B).
__global__ void __launch_bounds__(kThreads) node_in_stage(Args a) {
  extern __shared__ __align__(16) float smem[];
  int r0, r1, ct;
  node_tile(a, &r0, &r1, &ct);
  const int rows = r1 - r0, dh = a.dh, ldx = ld_of(dh);
  float* x_s = smem;  // [32, ldx]
  float* ring = x_s + kNodeRows * ldx;
  const int fn1_tiles = cdiv(a.rn, NodeWide::kCols);
  if (ct < fn1_tiles) {
    // nmods: gate_msa, shift_mlp, scale_mlp, gate_mlp
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * dh; idx += kThreads) {
      const int r = idx / dh;
      const int c = idx - r * dh;
      const size_t g = (size_t)(r0 + r) * dh + c;
      x_s[r * ldx + c] = a.h[g] + a.nmods[(size_t)((r0 + r) / a.n) * 4 * dh + c] * a.attn[g];
    }
    __syncthreads();
    ln_rows(x_s, rows, dh, ldx, a.eps, [&](int r, const float** sh, const float** sc, float* mul) {
      const float* nm = a.nmods + (size_t)((r0 + r) / a.n) * 4 * dh;
      *sh = nm + dh;
      *sc = nm + 2 * dh;
      *mul = a.nmask[r0 + r];
    });
    __syncthreads();
    if (ct == 0) {
      for (int idx = threadIdx.x; idx < rows * dh; idx += kThreads) {
        const int r = idx / dh;
        a.h1[(size_t)r0 * dh + idx] = x_s[r * ldx + idx - r * dh];
      }
    }
    const Product ffn1{x_s, a.fn1_k, nullptr, nullptr, ldx, rows, dh, a.rn};
    gemm<NodeWide>(ffn1, ct * NodeWide::kCols, (ct + 1) * NodeWide::kCols, ring, NoFetch(),
               [&](int r, int c, float v, float) {
                 a.mid[(size_t)(r0 + r) * a.rn + c] = silu(v + a.fn1_b[c]);
               });
  } else {
    copy_rows_async(x_s, ldx, a.attn + (size_t)r0 * dh, dh, rows, dh);
    finish_copies();
    const int col0 = (ct - fn1_tiles) * NodeWide::kCols;
    const Product n2e{x_s, a.n2e_k, nullptr, nullptr, ldx, rows, dh, a.de};
    gemm<NodeWide>(n2e, col0, col0 + NodeWide::kCols, ring, NoFetch(),
               [&](int r, int c, float v, float) { a.p[(size_t)(r0 + r) * a.de + c] = v; });
  }
}

// N2: h_out = (h1 + gate_mlp * (mid @ fn2 + b)) * nmask, 64-column tiles.
__global__ void __launch_bounds__(kThreads) node_out_stage(Args a) {
  extern __shared__ __align__(16) float smem[];
  int r0, r1, ct;
  node_tile(a, &r0, &r1, &ct);
  const int rows = r1 - r0, dh = a.dh, ldm = ld_of(a.rn);
  float* x_s = smem;  // [32, ldm]
  float* ring = x_s + kNodeRows * ldm;
  copy_rows_async(x_s, ldm, a.mid + (size_t)r0 * a.rn, a.rn, rows, a.rn);
  finish_copies();
  const Product ffn2{x_s, a.fn2_k, nullptr, nullptr, ldm, rows, a.rn, dh};
  gemm<NodeNarrow>(
      ffn2, ct * NodeNarrow::kCols, (ct + 1) * NodeNarrow::kCols, ring,
      [&](int r, int c) { return a.h1[(size_t)(r0 + r) * dh + c]; },
      [&](int r, int c, float v, float h1) {
        const int g = r0 + r;
        const float gate = a.nmods[(size_t)(g / a.n) * 4 * dh + 3 * dh + c];
        a.h_out[(size_t)g * dh + c] = (h1 + gate * (v + a.fn2_b[c])) * a.nmask[g];
      });
}

// N3: node_i = h_out @ W_hi, node_j = h_out @ W_hj, 128-column tiles.
__global__ void __launch_bounds__(kThreads) node_proj_stage(Args a) {
  extern __shared__ __align__(16) float smem[];
  int r0, r1, ct;
  node_tile(a, &r0, &r1, &ct);
  const int rows = r1 - r0, dh = a.dh, ldx = ld_of(dh);
  float* x_s = smem;  // [32, ldx]
  float* ring = x_s + kNodeRows * ldx;
  copy_rows_async(x_s, ldx, a.h_out + (size_t)r0 * dh, dh, rows, dh);
  finish_copies();
  const int w_tiles = cdiv(dh, NodeWide::kCols);
  const bool hi = ct < w_tiles;
  const int col0 = (hi ? ct : ct - w_tiles) * NodeWide::kCols;
  float* out = hi ? a.node_i : a.node_j;
  const Product proj{x_s, hi ? a.w_hi : a.w_hj, nullptr, nullptr, ldx, rows, dh, dh};
  gemm<NodeWide>(proj, col0, col0 + NodeWide::kCols, ring, NoFetch(),
             [&](int r, int c, float v, float) { out[(size_t)(r0 + r) * dh + c] = v; });
}

// ---- stage B: edge residual and FFN, equivariant update ------------------

__global__ void __launch_bounds__(kThreads, 2) pair_stage(Args a) {
  extern __shared__ __align__(16) float smem[];
  const PairTile t = pair_tile(a);
  const int n = a.n, de = a.de, dh = a.dh, re = a.re, n_gate = 1 + a.n_extra;
  const int lde = ld_of(de), ldm = ld_of(re), ldp = ld_of(dh);
  float* gbf_s = smem;                          // [64, lde]
  float* eres_s = gbf_s + kPairRows * lde;      // [64, lde] e_res, then edge_out
  float* u_s = eres_s + kPairRows * lde;        // [64, ldm] FFN middle, then [64, ldp] pairs
  float* g_s = u_s + kPairRows * imax(ldm, ldp);  // [64, kMaxGate] W1 sums
  float* gate_s = g_s + kPairRows * kMaxGate;   // [64]
  float* ring = gate_s + kPairRows;

  // e_res = edge_in + e_gate_msa * ((p_i + p_j) + n2e_b)
  const float* emods = a.emods + (size_t)t.b * 6 * de;
  const float* edge = a.edge_in + (size_t)t.row0 * n * de;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < t.pairs * de; idx += kThreads) {
    const int p = idx / de;
    const int c = idx - p * de;
    const int r = p / n, j = p - r * n;
    const float he = a.p[(size_t)(t.row0 + r) * de + c] + a.p[(size_t)(t.b * n + j) * de + c] +
                     a.n2e_b[c];
    eres_s[p * lde + c] = edge[idx] + emods[2 * de + c] * he;
  }
  gbf_rows(a, t.b, t.row0, t.pairs, gbf_s, lde);
  for (int idx = threadIdx.x; idx < kPairRows * kMaxGate; idx += kThreads) g_s[idx] = 0.f;
  __syncthreads();
  ln_rows(eres_s, t.pairs, de, lde, a.eps, emods + 3 * de, emods + 4 * de);
  __syncthreads();

  // edge FFN: edge_out = e_res + e_gate_mlp * (silu(e_res @ fe1 + b1) @ fe2 + b2)
  const Product ffn1{eres_s, a.fe1_k, nullptr, nullptr, lde, t.pairs, de, re};
  gemm<PairWide>(ffn1, ring, NoFetch(),
             [&](int p, int c, float v, float) { u_s[p * ldm + c] = silu(v + a.fe1_b[c]); });
  __syncthreads();
  float* eout = a.edge_out + (size_t)t.row0 * n * de;
  const Product ffn2{u_s, a.fe2_k, nullptr, nullptr, ldm, t.pairs, re, de};
  gemm<PairNarrow>(ffn2, ring, NoFetch(), [&](int p, int c, float v, float) {
    const float e = eres_s[p * lde + c] + emods[5 * de + c] * (v + a.fe2_b[c]);
    eres_s[p * lde + c] = e;  // read and written by this thread only
    eout[p * de + c] = e;
  });
  __syncthreads();

  // pair = node_i + node_j + edge_out @ W_e + gbf @ W_d + bias, its
  // LayerNorm and modulation (eqss: shift, scale)
  const Product pair{eres_s, a.w_e, gbf_s, a.w_d, lde, t.pairs, de, dh};
  gemm<PairWide>(
      pair, ring,
      [&](int p, int c) {
        const int r = p / n;
        return a.node_i[(size_t)(t.row0 + r) * dh + c] +
               a.node_j[(size_t)(t.b * n + p - r * n) * dh + c];
      },
      [&](int p, int c, float v, float nij) { u_s[p * ldp + c] = nij + v + a.eq_b[c]; });
  __syncthreads();
  const float* eqss = a.eqss + (size_t)t.b * 2 * dh;
  ln_rows(u_s, t.pairs, dh, ldp, a.eps, eqss, eqss + dh);
  __syncthreads();

  // g = silu(pair @ eq_k0 + b0) @ eq_k1: each thread's columns, then the
  // row's 16 column threads by shuffles, then the column passes in order
  const int tx = threadIdx.x & 15;
  for (int col0 = 0; col0 < dh; col0 += PairWide::kCols) {
    float acc[PairWide::TM][PairWide::TN];
    zero<PairWide>(acc);
    mma_tile<PairWide>(acc, u_s, ldp, t.pairs, a.eq_k0, dh, dh, col0, ring);
#pragma unroll
    for (int m = 0; m < PairWide::TM; ++m) {
      float part[kMaxGate] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < PairWide::TN; ++q) {
        const int col = out_col(col0, q);
        if (col < dh) {
          const float inv = silu(acc[m][q] + a.eq_b0[col]);
#pragma unroll
          for (int g = 0; g < kMaxGate; ++g)
            if (g < n_gate) part[g] = fmaf(inv, a.eq_k1[(size_t)col * n_gate + g], part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGate; ++g) {
        for (int off = 8; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      }
      const int row = out_row<PairWide>(m);
      if (tx == 0 && row < t.pairs) {
        for (int g = 0; g < n_gate; ++g) g_s[row * kMaxGate + g] += part[g];
      }
    }
  }
  __syncthreads();

  // gate = mean(tanh(g) * [1, adj]) * mask; agg_i = sum_j normed_diff * gate
  const float* adj = a.adj + (size_t)t.row0 * n * a.n_extra;
  const float* emask = a.emask + (size_t)t.row0 * n;
  for (int p = threadIdx.x; p < t.pairs; p += kThreads) {
    float gsum = 0.f;
    for (int g = 0; g < n_gate; ++g) {
      const float v = tanhf(g_s[p * kMaxGate + g]);
      gsum += g == 0 ? v : v * adj[p * a.n_extra + g - 1];
    }
    gate_s[p] = gsum / n_gate * emask[p];
  }
  __syncthreads();
  const float* normed = a.normed + (size_t)t.row0 * n * 3;
  for (int idx = threadIdx.x; idx < t.rows * 3; idx += kThreads) {
    const int r = idx / 3;
    const int d = idx - r * 3;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(normed[(r * n + j) * 3 + d], gate_s[r * n + j], o);
    a.agg[(size_t)(t.row0 + r) * 3 + d] = o;
  }
}

// The shared-memory limit and carveout of the five kernels, set once per
// device at the first call (not on every launch).
constexpr int kMaxDevices = 64;

cudaError_t prepare_device() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t status[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    const void* kernels[] = {(const void*)attn_stage<float>, (const void*)attn_stage<uint16_t>,
                             (const void*)node_in_stage,
                             (const void*)node_out_stage, (const void*)node_proj_stage,
                             (const void*)pair_stage};
    cudaError_t e = cudaSuccess;
    for (const void* k : kernels) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    status[dev] = e;
  });
  return status[dev];
}

cudaError_t launch(const void* kernel, int grid, int smem, Args& a, cudaStream_t stream) {
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), params, (size_t)smem,
                                     stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// bufs: kBufs device pointers in Args order (inputs, outputs, scratch);
// dims: batch, n, dh, de, n_sub, sub_c, heads, out_ch, n_extra, rn, re,
// set_inf, and 1 where q, k and v are bf16 (0: float); plan: the wrapper's launch plan (rows a tile, tiles a molecule,
// node tiles, then blocks and shared-memory bytes of launches A, N1, N2,
// N3, B), which must equal this file's. Launches A, N1, N2, N3, B on
// `stream`; the caller checked shapes, types and contiguity. Returns the
// first CUDA error, so that a refused launch is seen at once.
extern "C" int dstt_block_fused(void* const* bufs, int n_bufs, const int* dims, int n_dims,
                                const int* plan, int n_plan, float eps, void* stream) {
  if (n_bufs != kBufs || n_dims != kDims || n_plan != kPlan) return (int)cudaErrorInvalidValue;
  Args a;
  int u = 0;
  auto in = [&]() { return static_cast<const float*>(bufs[u++]); };
  auto out = [&]() { return static_cast<float*>(bufs[u++]); };
  a.h = in(), a.q = in(), a.k = in(), a.v = in(), a.edge_in = in(), a.d2 = in();
  a.normed = in(), a.adj = in(), a.emask = in(), a.nmask = in();
  a.nmods = in(), a.emods = in(), a.eqss = in(), a.gbfss = in();
  a.means = in(), a.stds = in(), a.emb_kd = in(), a.emb_ke = in(), a.emb_b = in();
  a.w0a = in(), a.w1a = in(), a.n2e_k = in(), a.n2e_b = in();
  a.fn1_k = in(), a.fn1_b = in(), a.fn2_k = in(), a.fn2_b = in();
  a.fe1_k = in(), a.fe1_b = in(), a.fe2_k = in(), a.fe2_b = in();
  a.w_hi = in(), a.w_hj = in(), a.w_e = in(), a.w_d = in();
  a.eq_b = in(), a.eq_k0 = in(), a.eq_b0 = in(), a.eq_k1 = in();
  a.h_out = out(), a.edge_out = out(), a.agg = out();
  a.attn = out(), a.h1 = out(), a.mid = out(), a.p = out(), a.node_i = out(), a.node_j = out();
  const int batch = dims[0];
  const int n_sub = dims[4];
  a.n = dims[1];
  a.dh = dims[2];
  a.de = dims[3];
  a.sub_c = dims[5];
  a.ec = n_sub * a.sub_c;
  a.heads = dims[6];
  a.out_ch = dims[7];
  a.n_extra = dims[8];
  a.rn = dims[9];
  a.re = dims[10];
  a.set_inf = dims[11];
  const int qkv_bf16 = dims[12];
  a.eps = eps;
  a.sqrt_c = sqrtf((float)a.out_ch);
  if (batch < 1 || a.n < 1 || a.n > kMaxN || a.n_extra < 0 || 1 + a.n_extra > kMaxGate ||
      a.dh % 32 != 0 || a.dh < 32 || a.dh > 1024 || a.heads * a.out_ch != a.dh || a.de < 2 ||
      n_sub < 1 || a.sub_c < 1 || a.rn < 1 || a.re < 1 || (qkv_bf16 != 0 && qkv_bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(batch, a.n, a.dh, a.de, a.ec, a.dh, a.heads, a.rn, a.re);
  const int mine[kPlan] = {p.rows_per_tile, p.tiles, p.node_tiles, p.grid_a, p.smem_a,
                           p.grid_n1, p.smem_n1, p.grid_n2, p.smem_n2, p.grid_n3, p.smem_n3,
                           p.grid_b, p.smem_b};
  for (int i = 0; i < kPlan; ++i)
    if (plan[i] != mine[i]) return (int)cudaErrorInvalidValue;
  if (imax(imax(p.smem_a, p.smem_b), imax(p.smem_n1, imax(p.smem_n2, p.smem_n3))) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  a.rows_per_tile = p.rows_per_tile;
  a.tiles = p.tiles;
  a.node_tiles = p.node_tiles;
  a.m_rows = batch * a.n;

  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return (int)err;
  const struct {
    const void* kernel;
    int grid, smem;
  } launches[] = {{qkv_bf16 ? (const void*)attn_stage<uint16_t> : (const void*)attn_stage<float>,
                   p.grid_a, p.smem_a},
                  {(const void*)node_in_stage, p.grid_n1, p.smem_n1},
                  {(const void*)node_out_stage, p.grid_n2, p.smem_n2},
                  {(const void*)node_proj_stage, p.grid_n3, p.smem_n3},
                  {(const void*)pair_stage, p.grid_b, p.smem_b}};
  for (const auto& l : launches) {
    err = launch(l.kernel, l.grid, l.smem, a, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
