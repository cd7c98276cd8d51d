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

#include "dmt_rows.cuh"

namespace {

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

  const float* edge_row = edge + (size_t)row * n * de;
  for (int idx = threadIdx.x; idx < n * de; idx += blockDim.x) edge_s[idx] = edge_row[idx];
  __syncthreads();

  dmt::attention_row(edge_s, prod_s, alpha_s, q + (size_t)row * ec, k + (size_t)b * n * ec,
                     v + (size_t)b * n * hc, w0, w1, extra + (size_t)row * n * n_extra,
                     mask + (size_t)row * n, out + (size_t)row * hc, n, de, n_sub, sub_c,
                     heads, out_ch, n_extra, set_inf, sqrt_c);
}

}  // namespace

// Launches on `stream`; the caller checked shapes, types and contiguity.
// Returns cudaGetLastError() so that a refused launch is seen at once.
extern "C" int dstt_mix_attention(
    const float* q, const float* k, const float* v, const float* edge,
    const float* w0, const float* w1, const float* extra, const float* mask,
    float* out, int batch, int n, int de, int n_sub, int sub_c, int heads,
    int out_ch, int n_extra, int set_inf, void* stream) {
  if (n > dmt::kMaxN) return (int)cudaErrorInvalidValue;
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
