// The whole pair-grid chain of one DMT EquivariantMixBlock, for Hopper
// (sm_90a), f32.
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
// the edge FFN, W_e/W_d and W0 of the equi chain) and a node about
// 0.82 MFLOP (n2e, the node FFN, W_hi/W_hj): about 2.9 GFLOP against some
// 8 MB of inputs and outputs, so in f32 on the CUDA cores (67 TFLOP/s,
// 3.35 TB/s) it is bound by operations.
//
// What the design does about it. The chain needs every row j of a
// molecule at two points: p_j (node -> edge) and h_out_j @ W_hj (the equi
// chain). So it runs as two launches of one thread block per row (b, i),
// B*N blocks of Dh threads, with the node-level products passed through
// device memory (0.67 MB at the serving shape):
//   A (rows_kernel): gbf, edge_emb and its LayerNorm for the row's N pairs
//     in shared memory, the mixed attention (mix_attention.cu's design:
//     thread c owns gate channel c for every j), then the node-level chain
//     of row i: p_i, the node residual and FFN, h_out_i, h_out_i @ W_hi
//     and h_out_i @ W_hj (matrix-vector products, weights read from L2).
//   B (pairs_kernel): the gbf again from d2 (cheaper than storing it), the
//     edge residual, LayerNorm and FFN for the row's N pairs in shared
//     memory, edge_out, then the equi chain (equi_update.cu's design:
//     thread c owns channel c of the N pair vectors, W0 read from L2).
// No [B, N, N, >64] intermediate reaches device memory, as on the TPU.
// Tensor cores (wgmma, bf16) and several rows a block are later work.

#include "dmt_rows.cuh"

namespace {

constexpr int kBufs = 45;  // pointers a call takes, in BlockArgs order
constexpr int kDims = 12;  // ints a call takes, in dstt_block_fused order

struct BlockArgs {
  // per-molecule data
  const float *h, *q, *k, *v, *edge_in, *d2, *normed, *adj, *emask, *nmask;
  const float *nmods, *emods, *eqss, *gbfss;
  // weights
  const float *means, *stds, *emb_kd, *emb_ke, *emb_b, *w0a, *w1a, *n2e_k, *n2e_b;
  const float *fn1_k, *fn1_b, *fn2_k, *fn2_b, *fe1_k, *fe1_b, *fe2_k, *fe2_b;
  const float *w_hi, *w_hj, *w_e, *w_d, *eq_b, *eq_k0, *eq_b0, *eq_k1;
  // outputs
  float *h_out, *edge_out, *agg;
  // written by launch A, read by launch B: p [B,N,De], node_i, node_j [B,N,Dh]
  float *p, *node_i, *node_j;
  int n, dh, de, n_sub, sub_c, heads, out_ch, n_extra, rn, re, set_inf;
  float eps, sqrt_c;
};

// Floats of shared memory each launch uses; pair_s of launch B starts at a
// multiple of 4 floats for its float4 reads.
__host__ __device__ inline int rows_smem(const BlockArgs& a) {
  return 3 * a.n * a.de + a.n * a.n_sub * a.sub_c + a.n * a.heads +
         a.heads * a.out_ch + a.dh + a.rn + a.dh;
}
__host__ __device__ inline int pairs_pair_offset(const BlockArgs& a) {
  return (3 * a.n * a.de + a.n * a.re + 3) & ~3;
}
__host__ __device__ inline int pairs_smem(const BlockArgs& a) {
  return pairs_pair_offset(a) + a.n * a.dh + (a.dh / 32) * a.n * (1 + a.n_extra) + a.n;
}

// The row's GBF distance features [n, de] from its squared distances.
__device__ inline void gbf_row(const BlockArgs& a, int row, int b, float* gbf_s) {
  constexpr float kPi = 3.14159f;  // the reference's value, kept for parity
  const float root = sqrtf(2.f * kPi);
  const float scale_t = a.gbfss[b * 2 + 0];
  const float shift_t = a.gbfss[b * 2 + 1];
  const float* d2_row = a.d2 + (size_t)row * a.n;
  for (int idx = threadIdx.x; idx < a.n * a.de; idx += blockDim.x) {
    const int j = idx / a.de;
    const int u = idx - j * a.de;
    const float x = d2_row[j] * (scale_t + 1.f) + shift_t;
    if (u == 0) {
      gbf_s[idx] = x;
    } else {
      const float std = fabsf(a.stds[u - 1]) + 1e-5f;
      const float z = (x - a.means[u - 1]) / std;
      gbf_s[idx] = expf(-0.5f * (z * z)) / (root * std);
    }
  }
}

// x @ w[:, c] for one vector x [k] in shared memory and
// w [k, m] in global memory (read from L2, coalesced across c).
__device__ inline float vec_dot_col(const float* x, const float* __restrict__ w, int k, int m,
                                    int c) {
  float s0 = 0.f, s1 = 0.f;
  int u = 0;
  for (; u + 1 < k; u += 2) {
    s0 = fmaf(x[u], __ldg(w + (size_t)u * m + c), s0);
    s1 = fmaf(x[u + 1], __ldg(w + (size_t)(u + 1) * m + c), s1);
  }
  if (u < k) s0 = fmaf(x[u], __ldg(w + (size_t)u * m + c), s0);
  return s0 + s1;
}

// Block-wide sum of one value per thread (every thread gets the total);
// red_s holds blockDim.x / 32 floats.
__device__ inline float block_sum(float v, float* red_s) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red_s may still be read from a previous call
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) s += red_s[w];
  return s;
}

// Both kernels run blockDim.x == Dh threads (== H*C >= E*sc).
__global__ void rows_kernel(BlockArgs a) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;  // b * n + i
  const int n = a.n, de = a.de, dh = a.dh, b = row / n;
  const int ec = a.n_sub * a.sub_c, hc = a.heads * a.out_ch;
  const int tid = threadIdx.x;
  float* edge_s = smem;              // [n, de] edge_in
  float* gbf_s = edge_s + n * de;    // [n, de]
  float* emod_s = gbf_s + n * de;    // [n, de] e_attr, then e_mod
  float* prod_s = emod_s + n * de;   // [n, ec]
  float* alpha_s = prod_s + n * ec;  // [n, heads]
  float* attn_s = alpha_s + n * a.heads;  // [hc]
  float* x_s = attn_s + hc;          // [dh] h1, then h_out
  float* mid_s = x_s + dh;           // [rn]
  float* red_s = mid_s + a.rn;       // [dh]

  const float* edge_row = a.edge_in + (size_t)row * n * de;
  for (int idx = tid; idx < n * de; idx += blockDim.x) edge_s[idx] = edge_row[idx];
  gbf_row(a, row, b, gbf_s);
  __syncthreads();

  // e_attr = (gbf @ Kd + edge_in @ Ke) + b
  for (int idx = tid; idx < n * de; idx += blockDim.x) {
    const int j = idx / de;
    const int c = idx - j * de;
    float sd = 0.f, se = 0.f;
    for (int d = 0; d < de; ++d) {
      sd = fmaf(gbf_s[j * de + d], __ldg(a.emb_kd + d * de + c), sd);
      se = fmaf(edge_s[j * de + d], __ldg(a.emb_ke + d * de + c), se);
    }
    emod_s[idx] = sd + se + a.emb_b[c];
  }
  __syncthreads();
  const float* emods = a.emods + (size_t)b * 6 * de;  // shift, scale, gate (msa), ... (mlp)
  dmt::ln_modulate_rows(emod_s, n, de, emods, emods + de, a.eps);
  __syncthreads();

  dmt::attention_row(emod_s, prod_s, alpha_s, a.q + (size_t)row * ec, a.k + (size_t)b * n * ec,
                     a.v + (size_t)b * n * hc, a.w0a, a.w1a, a.adj + (size_t)row * n * a.n_extra,
                     a.emask + (size_t)row * n, attn_s, n, de, a.n_sub, a.sub_c, a.heads,
                     a.out_ch, a.n_extra, a.set_inf, a.sqrt_c);
  __syncthreads();

  // p_i = attn_i @ Kn2e (the bias is added with p_j in launch B)
  for (int c = tid; c < de; c += blockDim.x)
    a.p[(size_t)row * de + c] = vec_dot_col(attn_s, a.n2e_k, dh, de, c);

  // node residual: h1 = (LN(h + gate_msa * attn) * (1 + scale_mlp) + shift_mlp) * nmask
  const float* nmods = a.nmods + (size_t)b * 4 * dh;  // gate_msa, shift_mlp, scale_mlp, gate_mlp
  const float nm = a.nmask[row];
  const float h1 = a.h[(size_t)row * dh + tid] + nmods[tid] * attn_s[tid];
  const float mu = block_sum(h1, red_s) / dh;
  const float t = h1 - mu;
  const float var = block_sum(t * t, red_s) / dh;
  const float r = 1.f / sqrtf(var + a.eps);
  x_s[tid] = (t * r * (1.f + nmods[2 * dh + tid]) + nmods[dh + tid]) * nm;
  __syncthreads();

  // node FFN: h_out = (h1 + gate_mlp * (silu(h1 @ fn1 + b1) @ fn2 + b2)) * nmask
  for (int c = tid; c < a.rn; c += blockDim.x) {
    const float y = vec_dot_col(x_s, a.fn1_k, dh, a.rn, c) + a.fn1_b[c];
    mid_s[c] = y / (1.f + expf(-y));
  }
  __syncthreads();
  const float f = vec_dot_col(mid_s, a.fn2_k, a.rn, dh, tid) + a.fn2_b[tid];
  const float hout = (x_s[tid] + nmods[3 * dh + tid] * f) * nm;
  __syncthreads();  // every thread has read x_s
  x_s[tid] = hout;
  a.h_out[(size_t)row * dh + tid] = hout;
  __syncthreads();

  // the equi chain's node-level products of row i
  a.node_i[(size_t)row * dh + tid] = vec_dot_col(x_s, a.w_hi, dh, dh, tid);
  a.node_j[(size_t)row * dh + tid] = vec_dot_col(x_s, a.w_hj, dh, dh, tid);
}

__global__ void pairs_kernel(BlockArgs a) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;  // b * n + i
  const int n = a.n, de = a.de, dh = a.dh, re = a.re, b = row / n;
  const int tid = threadIdx.x;
  float* eres_s = smem;              // [n, de] edge_in, then e_res
  float* gbf_s = eres_s + n * de;    // [n, de]
  float* eout_s = gbf_s + n * de;    // [n, de]
  float* mid_s = eout_s + n * de;    // [n, re]
  float* pair_s = smem + pairs_pair_offset(a);  // [n, dh]
  float* red_s = pair_s + n * dh;    // [dh / 32, n, 1 + A]
  float* gate_s = red_s + (dh / 32) * n * (1 + a.n_extra);  // [n]

  const float* emods = a.emods + (size_t)b * 6 * de;
  const float* p_i = a.p + (size_t)row * de;
  const float* p_b = a.p + (size_t)b * n * de;
  const float* edge_row = a.edge_in + (size_t)row * n * de;
  // e_res = edge_in + e_gate_msa * ((p_i + p_j) + n2e_b)
  for (int idx = tid; idx < n * de; idx += blockDim.x) {
    const int j = idx / de;
    const int c = idx - j * de;
    const float he = p_i[c] + p_b[j * de + c] + a.n2e_b[c];
    eres_s[idx] = edge_row[idx] + emods[2 * de + c] * he;
  }
  gbf_row(a, row, b, gbf_s);
  __syncthreads();
  dmt::ln_modulate_rows(eres_s, n, de, emods + 3 * de, emods + 4 * de, a.eps);
  __syncthreads();

  // edge FFN: edge_out = e_res + e_gate_mlp * (silu(e_res @ fe1 + b1) @ fe2 + b2)
  for (int idx = tid; idx < n * re; idx += blockDim.x) {
    const int j = idx / re;
    const int c = idx - j * re;
    float s = 0.f;
    for (int d = 0; d < de; ++d) s = fmaf(eres_s[j * de + d], __ldg(a.fe1_k + d * re + c), s);
    const float y = s + a.fe1_b[c];
    mid_s[idx] = y / (1.f + expf(-y));
  }
  __syncthreads();
  float* eout_row = a.edge_out + (size_t)row * n * de;
  for (int idx = tid; idx < n * de; idx += blockDim.x) {
    const int j = idx / de;
    const int c = idx - j * de;
    float s = 0.f;
    for (int d = 0; d < re; ++d) s = fmaf(mid_s[j * re + d], __ldg(a.fe2_k + d * de + c), s);
    const float e = eres_s[idx] + emods[5 * de + c] * (s + a.fe2_b[c]);
    eout_s[idx] = e;
    eout_row[idx] = e;
  }
  __syncthreads();

  const float* eqss = a.eqss + (size_t)b * 2 * dh;  // shift, scale
  dmt::equi_chain_row(eout_s, gbf_s, pair_s, red_s, gate_s, a.node_i + (size_t)row * dh,
                      a.node_j + (size_t)b * n * dh, a.w_e, a.w_d, a.eq_b, eqss, eqss + dh,
                      a.eq_k0, a.eq_b0, a.eq_k1, a.adj + (size_t)row * n * a.n_extra,
                      a.emask + (size_t)row * n, a.normed + (size_t)row * n * 3,
                      a.agg + (size_t)row * 3, n, de, de, dh, a.n_extra, a.eps);
}

}  // namespace

// bufs: kBufs device pointers in BlockArgs order (inputs, outputs,
// scratch); dims: batch, n, dh, de, n_sub, sub_c, heads, out_ch, n_extra,
// rn, re, set_inf. Launches A then B on `stream`; the caller checked
// shapes, types and contiguity. Returns the first CUDA error, so that a
// refused launch is seen at once.
extern "C" int dstt_block_fused(void* const* bufs, int n_bufs, const int* dims, int n_dims,
                                float eps, void* stream) {
  if (n_bufs != kBufs || n_dims != kDims) return (int)cudaErrorInvalidValue;
  BlockArgs a;
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
  a.p = out(), a.node_i = out(), a.node_j = out();
  const int batch = dims[0];
  a.n = dims[1];
  a.dh = dims[2];
  a.de = dims[3];
  a.n_sub = dims[4];
  a.sub_c = dims[5];
  a.heads = dims[6];
  a.out_ch = dims[7];
  a.n_extra = dims[8];
  a.rn = dims[9];
  a.re = dims[10];
  a.set_inf = dims[11];
  a.eps = eps;
  a.sqrt_c = sqrtf((float)a.out_ch);
  if (a.n > dmt::kMaxN || 1 + a.n_extra > dmt::kMaxGate || a.dh % 32 != 0 || a.dh > 1024 ||
      a.heads * a.out_ch != a.dh || a.n_sub * a.sub_c > a.dh) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem_a = sizeof(float) * (size_t)rows_smem(a);
  const size_t smem_b = sizeof(float) * (size_t)pairs_smem(a);
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<batch * a.n, a.dh, smem_a, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pairs_kernel<<<batch * a.n, a.dh, smem_b, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
