// Equivariant coordinate update of one DMT block, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel diffspectra_tpu/ops/pallas_equi_update.py::_kernel
// (entry point equi_update_fused, shared math _chain_math). For every pair
// (b, i, j):
//
//   pair = node_i + node_j + edge_ij @ We + dist_ij @ Wd + bias     [Dh]
//   pair = LayerNorm(pair, no affine, eps) * (1 + scale_b) + shift_b
//   inv  = silu(pair @ W0 + b0)                                     [Dh]
//   g    = tanh(inv @ W1)                                           [1 + A]
//   gate = mean(g * [1, adj_ij])
//   out_i = sum_j normed_diff_ij * gate * mask_ij                   [3]
//
// What bounds it on this card. At the serving shape (B=10, N=29, De=Dd=64,
// Dh=256, A=2) each pair costs 2*128*256 operations for the two gate
// projections and 2*256*256 for the W0 product, about 1.67 GFLOP in all,
// against about 5.5 MB of inputs and outputs: some 300 operations per byte,
// so in f32 on the CUDA cores (67 TFLOP/s, 3.35 TB/s) it is bound by
// operations.
//
// What the design does about it. One thread block of Dh threads per row
// (b, i); thread c owns channel c of the row's N pair vectors, held in
// registers while they are accumulated and in shared memory ([N, Dh]) for
// the LayerNorm (one warp per pair) and as the left operand of the
// [N, Dh] x [Dh, Dh] product. In that product each thread reads its column
// of W0 once, four rows at a time, and the pair rows as float4 broadcasts,
// so the inner loop is 4 N fused multiply-adds per four weight loads. The
// three [B, N, N, Dh] intermediates never reach device memory, as on the
// TPU. The 3-wide W1 product is reduced with warp shuffles and the j sum by
// three threads. Tensor cores (wgmma, bf16) are later work.

#include "dmt_rows.cuh"

namespace {

// float offset of the pair rows in shared memory, rounded up for float4 reads
__host__ __device__ inline int pair_offset(int n, int de, int dd) {
  return (n * (de + dd) + 3) & ~3;
}

__global__ void equi_update_kernel(
    const float* __restrict__ node_i,  // [B, N, Dh]
    const float* __restrict__ node_j,  // [B, N, Dh]
    const float* __restrict__ edge,    // [B, N, N, De]
    const float* __restrict__ dist,    // [B, N, N, Dd]
    const float* __restrict__ normed,  // [B, N, N, 3]
    const float* __restrict__ adj,     // [B, N, N, A]
    const float* __restrict__ mask,    // [B, N, N]
    const float* __restrict__ we,      // [De, Dh]
    const float* __restrict__ wd,      // [Dd, Dh]
    const float* __restrict__ bias,    // [Dh]
    const float* __restrict__ shift,   // [B, Dh]
    const float* __restrict__ scale,   // [B, Dh]
    const float* __restrict__ w0,      // [Dh, Dh]
    const float* __restrict__ b0,      // [Dh]
    const float* __restrict__ w1,      // [Dh, 1 + A]
    float* __restrict__ out,           // [B, N, 3]
    int n, int de, int dd, int dh, int n_adj, float eps) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;  // b * n + i
  const int b = row / n;
  const int n_warps = blockDim.x / 32;
  float* edge_s = smem;                           // [n, de]
  float* dist_s = edge_s + n * de;                // [n, dd]
  float* pair_s = smem + pair_offset(n, de, dd);  // [n, dh], float4-aligned rows
  float* red_s = pair_s + n * dh;                 // [n_warps, n, 1 + n_adj]
  float* gate_s = red_s + n_warps * n * (1 + n_adj);  // [n]

  const float* edge_row = edge + (size_t)row * n * de;
  const float* dist_row = dist + (size_t)row * n * dd;
  for (int idx = threadIdx.x; idx < n * de; idx += blockDim.x) edge_s[idx] = edge_row[idx];
  for (int idx = threadIdx.x; idx < n * dd; idx += blockDim.x) dist_s[idx] = dist_row[idx];
  __syncthreads();

  dmt::equi_chain_row(edge_s, dist_s, pair_s, red_s, gate_s, node_i + (size_t)row * dh,
                      node_j + (size_t)b * n * dh, we, wd, bias, shift + (size_t)b * dh,
                      scale + (size_t)b * dh, w0, b0, w1, adj + (size_t)row * n * n_adj,
                      mask + (size_t)row * n, normed + (size_t)row * n * 3,
                      out + (size_t)row * 3, n, de, dd, dh, n_adj, eps);
}

}  // namespace

// Launches on `stream`; the caller checked shapes, types and contiguity.
// Returns cudaGetLastError() so that a refused launch is seen at once.
extern "C" int dstt_equi_update(
    const float* node_i, const float* node_j, const float* edge,
    const float* dist, const float* normed, const float* adj,
    const float* mask, const float* we, const float* wd, const float* bias,
    const float* shift, const float* scale, const float* w0, const float* b0,
    const float* w1, float* out, int batch, int n, int de, int dd, int dh,
    int n_adj, float eps, void* stream) {
  if (n > dmt::kMaxN || 1 + n_adj > dmt::kMaxGate || dh % 32 != 0 || dh > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_warps = dh / 32;
  const size_t smem =
      sizeof(float) * ((size_t)pair_offset(n, de, dd) + (size_t)n * dh +
                       (size_t)n_warps * n * (1 + n_adj) + n);
  cudaError_t err = cudaFuncSetAttribute(
      equi_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  equi_update_kernel<<<batch * n, dh, smem, (cudaStream_t)stream>>>(
      node_i, node_j, edge, dist, normed, adj, mask, we, wd, bias, shift,
      scale, w0, b0, w1, out, n, de, dd, dh, n_adj, eps);
  return (int)cudaGetLastError();
}
