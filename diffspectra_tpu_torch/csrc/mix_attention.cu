// Mixed edge-gated attention of one DMT block, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel diffspectra_tpu/ops/pallas_attention.py::_kernel
// (entry point mix_attention). For every pair (b, i, j):
//
//   e0 = tanh(edge_ij @ W0)                      [E*sc]
//   e1 = tanh(edge_ij @ W1)                      [H*C]
//   logit_h = sum_c q_i k_j e0 / sqrt(C)         (learned heads, h >= X)
//   logit_h = extra_ij[h], 0 -> -1e10 (set_inf) (X adjacency heads, h < X)
//   alpha = softmax_j(mask_ij > 0 ? logit : -1e30)
//   out_i = sum_j alpha_ij v_j e1_ij             [H*C]
//
// What bounds it on this card. At the serving shape (B=10, N=29, De=64,
// E*sc=252, H*C=256) the two gate projections are 2*64*508 operations per
// pair, about 0.55 GFLOP in all, against about 3.6 MB of inputs and
// outputs: some 150 operations per byte, so in f32 on the CUDA cores
// (67 TFLOP/s, 3.35 TB/s) it is bound by operations. Per row (b, i) W0, W1
// and the molecule's k and v are 187 KB, so a design that reads them for
// each row moves 54 MB through L2 a call.
//
// What the design does about it. One block per tile of R rows of one
// molecule (row_tile.cuh: 64 pair rows and 256 threads, or 32 and 128), so
// [W0 | W1] (one De x (E*sc + H*C) product, in two passes of at most 256
// columns) streams through the ring once a tile. The tile's edge rows (one
// contiguous slab, transposed into shared memory), the molecule's k, the
// tile's q, and extra and the mask of its pairs come in by cp.async. Pass
// W0 leaves e0 in the 8 x 8 register tiles; its epilogue forms
// q_i k_j tanh(e0) and writes the products to shared memory over the slab
// and k, where the threads sum each pair's heads over their sub_c = 18
// channels (not warp aligned: E*sc is 252, not 256) and add the adjacency
// logits with set_inf, keeping -1e10 and -1e30 finite. Then the slab comes
// in again with v and W1's first chunks (cp.async, under the softmax), one
// warp per (row, head) runs the masked softmax over j (N <= 32: one lane
// per j), and pass W1's epilogue forms alpha_ij v_j tanh(e1), written over
// the slab and summed over j by one thread per (row, channel), in order.
// No [B, N, N, > 3] tensor reaches device memory, as on the TPU.
//
// Shared memory, in floats: max(De (TR + 4) + N w, TR w), w = max(ld(E*sc),
// ld(H*C)), for the slab with k or v, then the products or the messages;
// R ld(E*sc) of q; TR H softmax weights; the ring (3 x 8 x 256); TR (H + 1)
// of extra and the mask. At the flagship widths that is 101,632 bytes for
// TR = 64 and R = 2 (two blocks an SM, at most 128 registers a thread)
// and 69,200 for TR = 32 (three, at most 170 registers). The plan
// (ops/mix_attention.py::launch_plan, re-checked here) gives:
//   B=10: N=17 R=2 90 tiles of 64, N=21 R=2 110, N=25 R=2 130 (one wave
//         of one block an SM); N=29 R=1 290 tiles of 32 (one wave, at most
//         three an SM);
//   B=80: N=17 R=3 480 tiles of 64, N=21 R=3 560, N=25 R=2 1040,
//         N=29 R=2 1200 (1.8 to 4.5 waves of two an SM).
// f32 FMAs on the CUDA cores: single TF32 cannot hold the 1e-5 tolerance,
// and a 3xTF32 mma.sync product was no faster in block_fused (PERF.md).
// What the chip showed (PERF.md): the two K = 64 passes are the smaller
// part of the time; the rest is the epilogues and their barriers, in which
// a faster tanh moved nothing. Where 64-row tiles overflow one wave by a
// little, tiles of 32 rows are faster (tools/row_tiles.py times both).
//
// bf16 operands (mix_attention_kernel<TR, true>; the JAX DMT in bf16 passes
// q, k, v, edge, W0 and W1 so, extra and the mask in f32). The two gate
// products run on the tensor cores (row_tile.cuh's mma_product: mma.sync
// m16n8k16 bf16 with f32 sums, exact products, so only the order of the
// sums differs from f32): the slab comes in as rows of pairs ([TR, De]
// bf16, De a multiple of 16), W0 and then W1 whole into one [De, 256] bf16
// tile (W0's 252 columns padded with zeros in shared memory, not in device
// memory), and the epilogues read the mma fragments (rows g, g + 8;
// columns 2t, 2t + 1 of each n8 tile) and k, q and v as bf16 pairs. The
// logits, softmax and sum over j are the f32 path's. Shared memory, bytes:
// max(TR (De + 8) 2 + N w' 2, TR w 4), w' = ld16(max(E*sc, H*C)), for the
// slab with k or v, then the f32 products or messages; R w' 2 of q; TR H 4
// softmax weights; De 264 2 of the weight; TR (H + 1) 4 of extra and the
// mask: 109,856 bytes for TR = 64 at the flagship widths (two blocks an SM)
// and 71,824 for TR = 32 (three).

#include "row_tile.cuh"

namespace {

using namespace dstt;
using namespace dstt::rows;

constexpr float kMaskInf = -1e30f;  // padding and the diagonal
constexpr float kNegAdj = -1e10f;   // an adjacency head's zero entry

struct Args {
  const void *q, *k, *v, *edge, *w0, *w1;  // float, or bf16 (16 raw bits) with kBf16
  const float *extra, *mask;
  float* out;
  int n, de, ec, sub_c, heads, out_ch, n_extra, set_inf, rows_per_tile, tiles;
  float sqrt_c;
};

// Shared-memory floats of a tile of tr rows ahead of q: the slab with k
// or v, then the products or the messages.
__host__ __device__ inline int front_floats(int tr, int n, int de, int ec, int hc, bool bf16) {
  const int ldw = imax(ld_of(ec), ld_of(hc));
  if (bf16) return imax((tr * (de + 8) + n * ld16(imax(ec, hc))) / 2, tr * ldw);
  return imax(de * (tr + 4) + n * ldw, tr * ldw);
}

// Shared-memory floats of q's rows and of a weight.
__host__ __device__ inline int q_floats(int r, int ec, int hc, bool bf16) {
  return bf16 ? r * ld16(imax(ec, hc)) / 2 : r * ld_of(ec);
}
__host__ __device__ inline int weight_floats(int de, bool bf16) {
  return bf16 ? de * kMmaLd / 2 : kRing;
}

Plan make_plan(int batch, int n, int de, int ec, int hc, int heads, bool bf16) {
  return plan_rows(batch, n, [&](int tr, int r) {
    return front_floats(tr, n, de, ec, hc, bf16) + q_floats(r, ec, hc, bf16) + tr * heads +
           weight_floats(de, bf16) + tr * (heads + 1);
  });
}

// logits: adjacency heads first, then the learned heads' sums of the
// products u_s [pairs, lde0]; masked, into alpha_s [pairs, heads].
template <int kThreads>
__device__ inline void logits(const Args& a, const Tile& t, const float* u_s, int lde0,
                              const float* extra_s, const float* mask_s, float* alpha_s) {
  const int heads = a.heads;
  for (int idx = threadIdx.x; idx < t.pairs * heads; idx += kThreads) {
    const int p = idx / heads;
    const int h = idx - p * heads;
    float logit;
    if (h < a.n_extra) {
      logit = extra_s[p * a.n_extra + h];
      if (a.set_inf && logit == 0.f) logit = kNegAdj;
    } else {
      const float* pr = u_s + p * lde0 + (h - a.n_extra) * a.sub_c;
      float s = 0.f;
      for (int u = 0; u < a.sub_c; ++u) s += pr[u];
      logit = s / a.sqrt_c;
    }
    alpha_s[idx] = mask_s[p] > 0.f ? logit : kMaskInf;
  }
}

// softmax over j, one warp per (row, head), one lane per j
template <int kThreads>
__device__ inline void softmax(const Args& a, const Tile& t, float* alpha_s) {
  const int n = a.n, heads = a.heads, lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < t.rows * heads; task += kThreads / 32) {
    const int r = task / heads;
    float* al = alpha_s + r * n * heads + (task - r * heads);
    const float x = lane < n ? al[lane * heads] : kMaskInf;
    const float mx = warp_max(x);
    const float e = lane < n ? expf(x - mx) : 0.f;
    const float s = warp_sum(e);
    if (lane < n) al[lane * heads] = e / s;
  }
}

// out_i = the sum over j of the messages u_s [pairs, lde1], in order
template <int kThreads>
__device__ inline void sum_messages(const Args& a, const Tile& t, const float* u_s, int lde1) {
  const int hc = a.heads * a.out_ch;
  for (int idx = threadIdx.x; idx < t.rows * hc; idx += kThreads) {
    const int r = idx / hc;
    const int c = idx - r * hc;
    const float* msg = u_s + r * a.n * lde1 + c;
    float s = 0.f;
    for (int j = 0; j < a.n; ++j) s += msg[j * lde1];
    a.out[(size_t)(t.row0 + r) * hc + c] = s;
  }
}

template <int TR>
__device__ inline void mix_attention_f32(const Args& a, float* smem) {
  using T = Tiling<TR>;
  const Tile t = tile_of(a.n, a.rows_per_tile, a.tiles);
  const int n = a.n, de = a.de, ec = a.ec, hc = a.heads * a.out_ch, heads = a.heads;
  const int lde0 = ld_of(ec), lde1 = ld_of(hc);
  float* edge_t = smem;                    // [De, kLdT]: edge, transposed
  float* kv_s = edge_t + de * T::kLdT;     // [n, lde0]: k; then [n, lde1]: v
  float* u_s = smem;                       // [TR, lde0]: products; then [TR, lde1]: messages
  float* q_s = smem + front_floats(TR, n, de, ec, hc, false);  // [R, lde0]
  float* alpha_s = q_s + q_floats(a.rows_per_tile, ec, hc, false);  // [TR, heads]
  float* ring = alpha_s + TR * heads;
  float* extra_s = ring + kRing;             // [TR, X]
  float* mask_s = extra_s + TR * heads;      // [TR]

  const float* edge = static_cast<const float*>(a.edge) + (size_t)t.row0 * n * de;
  copy_rows_transposed_async<T::kThreads>(edge_t, T::kLdT, edge, de, t.pairs, de);
  copy_rows_async<T::kThreads>(kv_s, lde0, static_cast<const float*>(a.k) + (size_t)t.b * n * ec,
                               ec, n, ec);
  copy_rows_async<T::kThreads>(q_s, lde0, static_cast<const float*>(a.q) + (size_t)t.row0 * ec,
                               ec, t.rows, ec);
  copy_async<T::kThreads>(extra_s, a.extra + (size_t)t.row0 * n * a.n_extra, t.pairs * a.n_extra);
  copy_async<T::kThreads>(mask_s, a.mask + (size_t)t.row0 * n, t.pairs);
  cp_async_commit();  // lands by the product's first wait
  const float* w0p = static_cast<const float*>(a.w0);
  const float* w1p = static_cast<const float*>(a.w1);
  const Weight w0{w0p, w0p, de, de, ec}, w1{w1p, w1p, de, de, hc};
  start_ring<TR>(w0, ring);

  // q_i k_j tanh(edge @ W0), the learned heads' products
  float acc[8][8];
  tile_product<TR>(acc, edge_t, t.pairs, w0, ring);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = imin(row_of(m), t.pairs - 1);  // rows past the tile repeat its last
    const int r = p / n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col_of(4 * h);
      if (c0 < ec) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * lde0 + c0);
        const float4 kv = *reinterpret_cast<const float4*>(kv_s + (p - r * n) * lde0 + c0);
        float* x = acc[m] + 4 * h;
        x[0] = qv.x * kv.x * tanhf(x[0]);
        x[1] = qv.y * kv.y * tanhf(x[1]);
        x[2] = qv.z * kv.z * tanhf(x[2]);
        x[3] = qv.w * kv.w * tanhf(x[3]);
      }
    }
  }
  __syncthreads();  // every thread has read k
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col_of(4 * h);
      if (c0 < ec) {
        const float* x = acc[m] + 4 * h;
        *reinterpret_cast<float4*>(u_s + row_of(m) * lde0 + c0) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }
  __syncthreads();

  logits<T::kThreads>(a, t, u_s, lde0, extra_s, mask_s, alpha_s);
  __syncthreads();  // the products are read: the slab and v come in under the softmax
  copy_rows_transposed_async<T::kThreads>(edge_t, T::kLdT, edge, de, t.pairs, de);
  copy_rows_async<T::kThreads>(kv_s, lde1, static_cast<const float*>(a.v) + (size_t)t.b * n * hc,
                               hc, n, hc);
  cp_async_commit();  // lands by the product's first wait
  start_ring<TR>(w1, ring);
  softmax<T::kThreads>(a, t, alpha_s);

  // alpha_ij v_j tanh(edge @ W1), then the sum over j
  tile_product<TR>(acc, edge_t, t.pairs, w1, ring);
  int head[8];  // the head of each of the thread's columns
#pragma unroll
  for (int q = 0; q < 8; ++q) head[q] = imin(col_of(q), hc - 1) / a.out_ch;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = imin(row_of(m), t.pairs - 1);
    const int j = p % n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col_of(4 * h);
      if (c0 < hc) {
        const float4 vv = *reinterpret_cast<const float4*>(kv_s + j * lde1 + c0);
        const float vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = acc[m][4 * h + e];
          x = alpha_s[p * heads + head[4 * h + e]] * vs[e] * tanhf(x);
        }
      }
    }
  }
  __syncthreads();  // every thread has read v
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col_of(4 * h);
      if (c0 < hc) {
        const float* x = acc[m] + 4 * h;
        *reinterpret_cast<float4*>(u_s + row_of(m) * lde1 + c0) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }
  __syncthreads();
  sum_messages<T::kThreads>(a, t, u_s, lde1);
}

template <int TR>
__device__ inline void mix_attention_bf16(const Args& a, float* smem) {
  using T = Tiling<TR>;
  const Tile t = tile_of(a.n, a.rows_per_tile, a.tiles);
  const int n = a.n, de = a.de, ec = a.ec, hc = a.heads * a.out_ch, heads = a.heads;
  const int lde0 = ld_of(ec), lde1 = ld_of(hc), lda = ld16(de), ldq = ld16(imax(ec, hc));
  uint16_t* slab_s = reinterpret_cast<uint16_t*>(smem);  // [TR, lda]: edge rows
  uint16_t* kv_s = slab_s + TR * lda;                    // [n, ldq]: k; then v
  float* u_s = smem;                       // [TR, lde0]: products; then [TR, lde1]: messages
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem + front_floats(TR, n, de, ec, hc, true));
  float* alpha_s = reinterpret_cast<float*>(q_s) + q_floats(a.rows_per_tile, ec, hc, true);
  uint16_t* w_s = reinterpret_cast<uint16_t*>(alpha_s + TR * heads);  // [De, kMmaLd]: W0; then W1
  float* extra_s = reinterpret_cast<float*>(w_s) + weight_floats(de, true);  // [TR, X]
  float* mask_s = extra_s + TR * heads;                                     // [TR]

  const uint16_t* edge = static_cast<const uint16_t*>(a.edge) + (size_t)t.row0 * n * de;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + (size_t)t.b * n * ec;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + (size_t)t.b * n * hc;
  copy_bf16_rows_async<T::kThreads>(slab_s, lda, edge, de, t.pairs, de);
  copy_bf16_rows_async<T::kThreads>(kv_s, ldq, kb, ec, n, ec);
  copy_bf16_rows_async<T::kThreads>(q_s, ldq, static_cast<const uint16_t*>(a.q) + (size_t)t.row0 * ec,
                                    ec, t.rows, ec);
  copy_async<T::kThreads>(extra_s, a.extra + (size_t)t.row0 * n * a.n_extra, t.pairs * a.n_extra);
  copy_async<T::kThreads>(mask_s, a.mask + (size_t)t.row0 * n, t.pairs);
  load_weight_bf16<T::kThreads>(w_s, static_cast<const uint16_t*>(a.w0), de, ec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // q_i k_j tanh(edge @ W0), the learned heads' products
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  mma_product(acc, slab_s, lda, 0, de, w_s, t.pairs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = imin(frag_row(h), t.pairs - 1);  // rows past the tile repeat its last
    const int r = p / n;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = frag_col(nt);
      if (c < ec) {
        const float2 qv = bf16x2_to_float2(q_s + r * ldq + c);
        const float2 kv = bf16x2_to_float2(kv_s + (p - r * n) * ldq + c);
        acc[nt][2 * h] = qv.x * kv.x * tanhf(acc[nt][2 * h]);
        acc[nt][2 * h + 1] = qv.y * kv.y * tanhf(acc[nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();  // every warp is past its product and has read k
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = frag_col(nt);
      if (c < ec) {
        *reinterpret_cast<float2*>(u_s + frag_row(h) * lde0 + c) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();

  logits<T::kThreads>(a, t, u_s, lde0, extra_s, mask_s, alpha_s);
  __syncthreads();  // the products are read: the slab, v and W1 come in under the softmax
  copy_bf16_rows_async<T::kThreads>(slab_s, lda, edge, de, t.pairs, de);
  copy_bf16_rows_async<T::kThreads>(kv_s, ldq, vb, hc, n, hc);
  load_weight_bf16<T::kThreads>(w_s, static_cast<const uint16_t*>(a.w1), de, hc);
  cp_async_commit();
  softmax<T::kThreads>(a, t, alpha_s);
  cp_async_wait<0>();
  __syncthreads();

  // alpha_ij v_j tanh(edge @ W1), then the sum over j
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  mma_product(acc, slab_s, lda, 0, de, w_s, t.pairs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = imin(frag_row(h), t.pairs - 1);
    const int j = p % n;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = frag_col(nt);
      if (c < hc) {
        const float2 vv = bf16x2_to_float2(kv_s + j * ldq + c);
        acc[nt][2 * h] = alpha_s[p * heads + c / a.out_ch] * vv.x * tanhf(acc[nt][2 * h]);
        acc[nt][2 * h + 1] =
            alpha_s[p * heads + (c + 1) / a.out_ch] * vv.y * tanhf(acc[nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();  // every warp is past its product and has read v
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = frag_col(nt);
      if (c < hc) {
        *reinterpret_cast<float2*>(u_s + frag_row(h) * lde1 + c) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  sum_messages<T::kThreads>(a, t, u_s, lde1);
}

template <int TR, bool kBf16>
__global__ void __launch_bounds__(Tiling<TR>::kThreads, Tiling<TR>::kMinBlocks)
    mix_attention_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kBf16) {
    mix_attention_bf16<TR>(a, smem);
  } else {
    mix_attention_f32<TR>(a, smem);
  }
}

Prepared prepared[4];  // the kernels of 64 and 32 rows a tile, f32 and bf16

int kernel_index(const Plan& p, bool bf16) { return (p.tile_rows == 64 ? 0 : 1) + (bf16 ? 2 : 0); }

const void* kernel_of(const Plan& p, bool bf16) {
  const void* kernels[4] = {(const void*)mix_attention_kernel<64, false>,
                            (const void*)mix_attention_kernel<32, false>,
                            (const void*)mix_attention_kernel<64, true>,
                            (const void*)mix_attention_kernel<32, true>};
  return kernels[kernel_index(p, bf16)];
}

}  // namespace

// q, k, v, edge, w0, w1: float, or bf16 where bf16 is 1 (then de a multiple
// of 16). plan: the wrapper's launch plan (rows a tile, rows of its
// molecule, tiles a molecule, blocks, threads, shared-memory bytes, blocks
// an SM), which must equal this file's. Launches on `stream`; the caller
// checked shapes, types and contiguity. Returns the first CUDA error, so
// that a refused launch is seen at once.
extern "C" int dstt_mix_attention(
    const void* q, const void* k, const void* v, const void* edge,
    const void* w0, const void* w1, const float* extra, const float* mask,
    float* out, int batch, int n, int de, int n_sub, int sub_c, int heads,
    int out_ch, int n_extra, int set_inf, int bf16, const int* plan, int n_plan, void* stream) {
  const int ec = n_sub * sub_c, hc = heads * out_ch;
  if (batch < 1 || n < 1 || n > kMaxN || de < 1 || n_sub < 1 || sub_c < 1 || out_ch < 1 ||
      n_extra < 0 || n_extra + n_sub != heads || ec > kCols || hc > kCols || ec % 4 != 0 ||
      hc % 4 != 0 || (bf16 != 0 && bf16 != 1) || (bf16 && de % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(batch, n, de, ec, hc, heads, bf16);
  if (!plan_matches(p, plan, n_plan)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, edge, w0, w1, extra, mask, out, n, de, ec, sub_c, heads, out_ch, n_extra,
         set_inf, p.rows_per_tile, p.tiles, sqrtf((float)out_ch)};
  return (int)launch(prepared[kernel_index(p, bf16)], kernel_of(p, bf16), p, a, stream);
}

// Blocks an SM of the kernel at these shapes, as the card reports it.
extern "C" int dstt_mix_attention_occupancy(int batch, int n, int de, int ec, int hc,
                                            int heads, int bf16, int* blocks) {
  const Plan p = make_plan(batch, n, de, ec, hc, heads, bf16);
  if (p.tile_rows == 0) return (int)cudaErrorInvalidValue;
  return (int)occupancy(prepared[kernel_index(p, bf16)], kernel_of(p, bf16), p, blocks);
}
