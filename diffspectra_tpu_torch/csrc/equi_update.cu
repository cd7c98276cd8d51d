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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxGate = 4;  // 1 + A

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
  const int n_gate = 1 + n_adj;
  const int n_warps = blockDim.x / 32;
  float* edge_s = smem;                    // [n, de]
  float* dist_s = edge_s + n * de;         // [n, dd]
  float* pair_s = smem + pair_offset(n, de, dd);  // [n, dh], float4-aligned rows
  float* red_s = pair_s + n * dh;          // [n_warps, n, n_gate]
  float* gate_s = red_s + n_warps * n * n_gate;  // [n]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* edge_row = edge + (size_t)row * n * de;
  const float* dist_row = dist + (size_t)row * n * dd;
  for (int idx = tid; idx < n * de; idx += blockDim.x) edge_s[idx] = edge_row[idx];
  for (int idx = tid; idx < n * dd; idx += blockDim.x) dist_s[idx] = dist_row[idx];
  __syncthreads();

  const int c = tid;  // blockDim.x == dh
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
  const float ni = node_i[(size_t)row * dh + c];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < n) pair_s[j * dh + c] = ni + node_j[((size_t)b * n + j) * dh + c] + acc[j];
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

  // LayerNorm (two-pass, no affine) and the adaLN modulation, one warp per pair
  const float* shift_b = shift + (size_t)b * dh;
  const float* scale_b = scale + (size_t)b * dh;
  for (int j = warp; j < n; j += n_warps) {
    float* p = pair_s + j * dh;
    float s = 0.f;
    for (int u = lane; u < dh; u += 32) s += p[u];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s / dh;
    float v = 0.f;
    for (int u = lane; u < dh; u += 32) {
      const float t = p[u] - mu;
      v = fmaf(t, t, v);
    }
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const float r = 1.f / sqrtf(v / dh + eps);
    for (int u = lane; u < dh; u += 32) {
      p[u] = (p[u] - mu) * r * (1.f + scale_b[u]) + shift_b[u];
    }
  }
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

  const float* adj_row = adj + (size_t)row * n * n_adj;
  const float* mask_row = mask + (size_t)row * n;
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
    const float* nd = normed + (size_t)row * n * 3;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(nd[j * 3 + tid], gate_s[j], o);
    out[(size_t)row * 3 + tid] = o;
  }
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
  if (n > kMaxN || 1 + n_adj > kMaxGate || dh % 32 != 0 || dh > 1024) {
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
