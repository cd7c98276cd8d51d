// Device code shared by the port's per-op DMT kernels (mix_attention.cu,
// equi_update.cu), for Hopper (sm_90a), f32.
//
// Every kernel runs one thread block per row (b, i) of the pair grid, and
// these functions work on that row's N pairs once their inputs are in
// shared memory. Each leaves its result in place and ends without a
// barrier: the caller synchronises before reading it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dmt {

constexpr int kMaxN = 32;
constexpr int kMaxGate = 4;  // 1 + A adjacency gates of the equi chain
constexpr float kMaskInf = -1e30f;  // padding and the diagonal
constexpr float kNegAdj = -1e10f;   // an adjacency head's zero entry

// x[r] = LayerNorm(x[r]) * (1 + scale) + shift for each of `rows` rows of
// `width` floats in shared memory: no affine, two passes as in the JAX
// reference, one warp per row.
__device__ inline void ln_modulate_rows(float* x, int rows, int width,
                                        const float* __restrict__ shift,
                                        const float* __restrict__ scale,
                                        float eps) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x / 32;
  for (int j = threadIdx.x >> 5; j < rows; j += n_warps) {
    float* p = x + j * width;
    float s = 0.f;
    for (int u = lane; u < width; u += 32) s += p[u];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s / width;
    float v = 0.f;
    for (int u = lane; u < width; u += 32) {
      const float t = p[u] - mu;
      v = fmaf(t, t, v);
    }
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const float r = 1.f / sqrtf(v / width + eps);
    for (int u = lane; u < width; u += 32) {
      p[u] = (p[u] - mu) * r * (1.f + scale[u]) + shift[u];
    }
  }
}

// Mixed edge-gated attention of row (b, i), from the row's gate inputs
// edge_s [n, de] in shared memory:
//   e0 = tanh(edge_ij @ W0), e1 = tanh(edge_ij @ W1)
//   logit_h = sum_c q_i k_j e0 / sqrt(C) (learned heads, h >= X), or
//   extra_ij[h] with 0 -> -1e10 when set_inf (X adjacency heads)
//   alpha = softmax_j(mask_ij > 0 ? logit : -1e30)
//   out_i = sum_j alpha_ij v_j e1_ij                       [H*C]
// Thread c owns gate channel c of e0 and e1 for every j, in registers;
// needs blockDim.x >= max(E*sc, H*C). prod_s [n, E*sc] and
// alpha_s [n, H] are scratch; out_row (global or shared) gets H*C floats.
__device__ inline void attention_row(
    const float* edge_s, float* prod_s, float* alpha_s,
    const float* __restrict__ q_row,      // [E*sc]
    const float* __restrict__ k_b,        // [n, E*sc], the molecule's rows
    const float* __restrict__ v_b,        // [n, H*C]
    const float* __restrict__ w0,         // [De, E*sc]
    const float* __restrict__ w1,         // [De, H*C]
    const float* __restrict__ extra_row,  // [n, X]
    const float* __restrict__ mask_row,   // [n]
    float* out_row, int n, int de, int n_sub, int sub_c, int heads,
    int out_ch, int n_extra, int set_inf, float sqrt_c) {
  const int ec = n_sub * sub_c;
  const int hc = heads * out_ch;
  const int c = threadIdx.x;
  const bool has0 = c < ec;
  const bool has1 = c < hc;
  float acc0[kMaxN], acc1[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    acc0[j] = 0.f;
    acc1[j] = 0.f;
  }
  for (int d = 0; d < de; ++d) {
    const float a0 = has0 ? __ldg(w0 + (size_t)d * ec + c) : 0.f;
    const float a1 = has1 ? __ldg(w1 + (size_t)d * hc + c) : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        const float e = edge_s[j * de + d];
        acc0[j] = fmaf(e, a0, acc0[j]);
        acc1[j] = fmaf(e, a1, acc1[j]);
      }
    }
  }

  if (has0) {
    const float qc = q_row[c];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) prod_s[j * ec + c] = qc * k_b[(size_t)j * ec + c] * tanhf(acc0[j]);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * heads; idx += blockDim.x) {
    const int j = idx / heads;
    const int h = idx - j * heads;
    float logit;
    if (h < n_extra) {
      logit = extra_row[j * n_extra + h];
      if (set_inf && logit == 0.f) logit = kNegAdj;
    } else {
      const float* p = prod_s + j * ec + (h - n_extra) * sub_c;
      float s = 0.f;
      for (int u = 0; u < sub_c; ++u) s += p[u];
      logit = s / sqrt_c;
    }
    alpha_s[idx] = mask_row[j] > 0.f ? logit : kMaskInf;
  }
  __syncthreads();

  for (int h = threadIdx.x; h < heads; h += blockDim.x) {
    float m = alpha_s[h];
    for (int j = 1; j < n; ++j) m = fmaxf(m, alpha_s[j * heads + h]);
    float s = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(alpha_s[j * heads + h] - m);
      alpha_s[j * heads + h] = e;
      s += e;
    }
    for (int j = 0; j < n; ++j) alpha_s[j * heads + h] /= s;
  }
  __syncthreads();

  if (has1) {
    const int h = c / out_ch;
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) o = fmaf(alpha_s[j * heads + h] * v_b[(size_t)j * hc + c], tanhf(acc1[j]), o);
    }
    out_row[c] = o;
  }
}

// Equivariant coordinate update of row (b, i), from the row's edge_s
// [n, de] and dist_s [n, dd] in shared memory:
//   pair = node_i + node_j + edge_ij @ We + dist_ij @ Wd + bias    [Dh]
//   pair = LayerNorm(pair, no affine, eps) * (1 + scale_b) + shift_b
//   g    = tanh(silu(pair @ W0 + b0) @ W1)                         [1 + A]
//   gate = mean(g * [1, adj_ij])
//   out_i = sum_j normed_diff_ij * gate * mask_ij                  [3]
// Thread c owns channel c of the row's n pair vectors (blockDim.x == Dh).
// pair_s [n, dh] (16-byte aligned), red_s [Dh/32, n, 1 + A] and
// gate_s [n] are scratch; out_row (global) gets 3 floats.
__device__ inline void equi_chain_row(
    const float* edge_s, const float* dist_s, float* pair_s, float* red_s,
    float* gate_s,
    const float* __restrict__ ni_row,      // [Dh], node_i of row i
    const float* __restrict__ nj_b,        // [n, Dh], node_j of the molecule
    const float* __restrict__ we,          // [De, Dh]
    const float* __restrict__ wd,          // [Dd, Dh]
    const float* __restrict__ bias,        // [Dh]
    const float* __restrict__ shift_b,     // [Dh]
    const float* __restrict__ scale_b,     // [Dh]
    const float* __restrict__ w0,          // [Dh, Dh]
    const float* __restrict__ b0,          // [Dh]
    const float* __restrict__ w1,          // [Dh, 1 + A]
    const float* __restrict__ adj_row,     // [n, A]
    const float* __restrict__ mask_row,    // [n]
    const float* __restrict__ normed_row,  // [n, 3]
    float* __restrict__ out_row,           // [3]
    int n, int de, int dd, int dh, int n_adj, float eps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x / 32;
  const int n_gate = 1 + n_adj;
  const int c = tid;
  float acc[kMaxN];

  // pair = ((node_i + node_j) + edge @ We) + dist @ Wd + bias, column c
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) acc[j] = 0.f;
  for (int d = 0; d < de; ++d) {
    const float w = __ldg(we + (size_t)d * dh + c);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < n) acc[j] = fmaf(edge_s[j * de + d], w, acc[j]);
  }
  const float ni = ni_row[c];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < n) pair_s[j * dh + c] = ni + nj_b[(size_t)j * dh + c] + acc[j];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) acc[j] = 0.f;
  for (int d = 0; d < dd; ++d) {
    const float w = __ldg(wd + (size_t)d * dh + c);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < n) acc[j] = fmaf(dist_s[j * dd + d], w, acc[j]);
  }
  const float bc = bias[c];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < n) pair_s[j * dh + c] = pair_s[j * dh + c] + acc[j] + bc;
  __syncthreads();

  ln_modulate_rows(pair_s, n, dh, shift_b, scale_b, eps);
  __syncthreads();

  // inv = silu(pair @ W0 + b0), column c, four rows of W0 at a time
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) acc[j] = 0.f;
  for (int u = 0; u < dh; u += 4) {
    const float a0 = __ldg(w0 + (size_t)(u + 0) * dh + c);
    const float a1 = __ldg(w0 + (size_t)(u + 1) * dh + c);
    const float a2 = __ldg(w0 + (size_t)(u + 2) * dh + c);
    const float a3 = __ldg(w0 + (size_t)(u + 3) * dh + c);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        const float4 p = *reinterpret_cast<const float4*>(pair_s + j * dh + u);
        acc[j] = fmaf(p.x, a0, acc[j]);
        acc[j] = fmaf(p.y, a1, acc[j]);
        acc[j] = fmaf(p.z, a2, acc[j]);
        acc[j] = fmaf(p.w, a3, acc[j]);
      }
    }
  }
  const float b0c = b0[c];
  float w1c[kMaxGate];
#pragma unroll
  for (int a = 0; a < kMaxGate; ++a) w1c[a] = a < n_gate ? w1[(size_t)c * n_gate + a] : 0.f;

  // g = inv @ W1: per-warp partial sums by shuffle, then across warps
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < n) {
      const float x = acc[j] + b0c;
      const float inv = x / (1.f + expf(-x));
#pragma unroll
      for (int a = 0; a < kMaxGate; ++a) {
        if (a < n_gate) {
          float p = inv * w1c[a];
          for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
          if (lane == 0) red_s[(warp * n + j) * n_gate + a] = p;
        }
      }
    }
  }
  __syncthreads();

  for (int j = tid; j < n; j += blockDim.x) {
    float gsum = 0.f;
    for (int a = 0; a < n_gate; ++a) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += red_s[(w * n + j) * n_gate + a];
      const float g = tanhf(s);
      gsum += a == 0 ? g : g * adj_row[j * n_adj + a - 1];
    }
    gate_s[j] = gsum / n_gate * mask_row[j];
  }
  __syncthreads();

  if (tid < 3) {
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(normed_row[j * 3 + tid], gate_s[j], o);
    out_row[tid] = o;
  }
}

}  // namespace dmt
