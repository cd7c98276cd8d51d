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
// (67 TFLOP/s, 3.35 TB/s) it is bound by operations, not by memory.
//
// What the design does about it. One thread block per row (b, i); thread c
// owns gate channel c of e0 and of e1 for every j of the row, keeping the
// 2 x N pre-activations in registers. The row's edge features [N, De] sit
// in shared memory and are read as broadcasts, and each weight element is
// read once per block (coalesced, from L2), so the inner loop is N fused
// multiply-adds per weight load. The [N, N, 508] gate tensors never reach
// device memory, which is what the TPU kernel kept out of HBM as well.
// The per-head sums over sc=18 channels (not warp aligned) go through
// shared memory; the masked softmax over j runs one thread per head.
// Tensor cores (wgmma, bf16) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;
constexpr float kMaskInf = -1e30f;  // padding and the diagonal
constexpr float kNegAdj = -1e10f;   // an adjacency head's zero entry

__global__ void mix_attention_kernel(
    const float* __restrict__ q,      // [B, N, E*sc]
    const float* __restrict__ k,      // [B, N, E*sc]
    const float* __restrict__ v,      // [B, N, H*C]
    const float* __restrict__ edge,   // [B, N, N, De]
    const float* __restrict__ w0,     // [De, E*sc]
    const float* __restrict__ w1,     // [De, H*C]
    const float* __restrict__ extra,  // [B, N, N, X]
    const float* __restrict__ mask,   // [B, N, N]
    float* __restrict__ out,          // [B, N, H*C]
    int n, int de, int n_sub, int sub_c, int heads, int out_ch, int n_extra,
    int set_inf, float sqrt_c) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;  // b * n + i
  const int b = row / n;
  const int ec = n_sub * sub_c;
  const int hc = heads * out_ch;
  float* edge_s = smem;               // [n, de]
  float* prod_s = edge_s + n * de;    // [n, ec]
  float* alpha_s = prod_s + n * ec;   // [n, heads]
  const int tid = threadIdx.x;

  const float* edge_row = edge + (size_t)row * n * de;
  for (int idx = tid; idx < n * de; idx += blockDim.x) edge_s[idx] = edge_row[idx];
  __syncthreads();

  const int c = tid;
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
    const float qc = q[(size_t)row * ec + c];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < n) {
        prod_s[j * ec + c] = qc * k[((size_t)b * n + j) * ec + c] * tanhf(acc0[j]);
      }
    }
  }
  __syncthreads();

  const float* mask_row = mask + (size_t)row * n;
  const float* extra_row = extra + (size_t)row * n * n_extra;
  for (int idx = tid; idx < n * heads; idx += blockDim.x) {
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

  for (int h = tid; h < heads; h += blockDim.x) {
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
      if (j < n) {
        o = fmaf(alpha_s[j * heads + h] * v[((size_t)b * n + j) * hc + c], tanhf(acc1[j]), o);
      }
    }
    out[(size_t)row * hc + c] = o;
  }
}

}  // namespace

// Launches on `stream`; the caller checked shapes, types and contiguity.
// Returns cudaGetLastError() so that a refused launch is seen at once.
extern "C" int dstt_mix_attention(
    const float* q, const float* k, const float* v, const float* edge,
    const float* w0, const float* w1, const float* extra, const float* mask,
    float* out, int batch, int n, int de, int n_sub, int sub_c, int heads,
    int out_ch, int n_extra, int set_inf, void* stream) {
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  const int width = max(n_sub * sub_c, heads * out_ch);
  const int threads = (width + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n * (de + n_sub * sub_c + heads);
  cudaError_t err = cudaFuncSetAttribute(
      mix_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mix_attention_kernel<<<batch * n, threads, smem, (cudaStream_t)stream>>>(
      q, k, v, edge, w0, w1, extra, mask, out, n, de, n_sub, sub_c, heads,
      out_ch, n_extra, set_inf, sqrtf((float)out_ch));
  return (int)cudaGetLastError();
}
