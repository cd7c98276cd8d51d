// Four of the Mosaic probes t1 ... t14 of tools/diag_mosaic_bisect.py, for
// Hopper (sm_90a), f32: t2, t9, t10 and t14. t1, t3, t4, t5, t6, t7, t8,
// t11, t12 and t13, redesigned for this card, are in probe_tiles.cu.
//
// Replaces four of the fourteen TPU kernels of that tool (one
// pl.pallas_call each). The tool bisects which Pallas/Mosaic feature a TPU
// compile refuses, one feature a probe: unaligned shapes, a masked large
// negative, a reshape and segment sum, a 2-D dot. Each kernel here
// computes what its probe computes, at the probe's shapes, and exercises
// the counterpart feature of this card: masked ragged edges (29 and 841
// are no multiples of the warp) and warp shuffles.
//
// What bounds them on this card. Each probe moves 7 KB to 0.9 MB, so the
// bound is 2 ns to 0.3 us: bytes / 3.35 TB/s. A launch costs about a
// microsecond, which sets their time.
//
// What the design does about it: nothing beyond a simple kernel that is
// right, with enough threads to cover the data in one wave. They are not
// on any serving path.
//
//   t2           x * 2, map_kernel<Times2> (841 floats: no multiple of 4)
//   t9           m > 0 ? x : -1e10         mask_kernel
//   t10          [841,252] -> [29,29,14,18].sum(-1), one thread per output
//   t14          q k^T, one warp per output, shuffle sum over the depth

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;     // map kernels loop past this many blocks

struct Times2 {
  __device__ float operator()(float x) const { return x * 2.0f; }
};

int map_blocks(int n) { return max(1, min(kMaxBlocks, (n + kThreads - 1) / kThreads)); }

template <class Op>
__global__ void map_kernel(const float* __restrict__ x, float* __restrict__ out, int n, Op op) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = op(x[i]);
  }
}

__global__ void mask_kernel(const float* __restrict__ x, const float* __restrict__ m,
                            float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = m[i] > 0.0f ? x[i] : -1e10f;
  }
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// t10: the reshape [841, 252] -> [29, 29, 14, 18] keeps memory order, so
// output o sums the contiguous segment x[o * seg : (o + 1) * seg].
__global__ void segment_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   int n_out, int seg) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const float* xs = x + (size_t)o * seg;
  float s = 0.0f;
  for (int c = 0; c < seg; ++c) s += xs[c];
  out[o] = s;
}

// t14: out[i, j] = sum_c q[i, c] k[j, c], one warp per (i, j): lane c takes
// c, c + 32, ..., then a shuffle sum.
__global__ void warp_dot_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                float* __restrict__ out, int m, int n, int depth) {
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= m * n) return;
  const float* qi = q + (size_t)(pair / n) * depth;
  const float* kj = k + (size_t)(pair % n) * depth;
  float s = 0.0f;
  for (int c = lane; c < depth; c += 32) s += qi[c] * kj[c];
  s = warp_sum(s);
  if (lane == 0) out[pair] = s;
}

int finish() { return (int)cudaGetLastError(); }

template <class Op>
int launch_map(const float* x, float* out, int n, Op op, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  map_kernel<<<map_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, op);
  return finish();
}

}  // namespace

// One launcher a probe (the other ten: probe_tiles.cu). Each launches
// on `stream` and returns cudaGetLastError(), so that a refused launch is
// seen at once; the caller checked shapes, types and contiguity. Sizes are
// element counts.
extern "C" {

int dstt_probe_t2(const float* x, float* out, int n, void* stream) {
  return launch_map(x, out, n, Times2{}, stream);
}

int dstt_probe_t9(const float* x, const float* mask, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  mask_kernel<<<map_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(x, mask, out, n);
  return finish();
}

int dstt_probe_t10(const float* x, float* out, int n_out, int seg, void* stream) {
  if (n_out <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n_out, seg);
  return finish();
}

int dstt_probe_t14(const float* q, const float* k, float* out, int m, int n, int depth,
                   void* stream) {
  if (m <= 0 || n <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  const int warps = kThreads / 32;
  warp_dot_kernel<<<(m * n + warps - 1) / warps, kThreads, 0, (cudaStream_t)stream>>>(
      q, k, out, m, n, depth);
  return finish();
}

}  // extern "C"
