// Six of the Mosaic probes t1 ... t14 of tools/diag_mosaic_bisect.py, for
// Hopper (sm_90a), f32: t2, t8, t9, t10, t13 and t14. t1, t3, t4, t5, t6,
// t7, t11 and t12, redesigned for this card, are in probe_tiles.cu.
//
// Replaces six of the fourteen TPU kernels of that tool (one
// pl.pallas_call each). The tool bisects which Pallas/Mosaic feature a TPU
// compile refuses, one feature a probe: unaligned shapes, a 2-D product,
// a softmax, a masked large negative, a reshape and segment sum. Each
// kernel here computes what its probe computes, at the probe's shapes, and
// exercises the counterpart feature of this card: masked ragged edges (29
// and 841 are no multiples of the warp or the tile), shared memory tiles
// and warp shuffles.
//
// What bounds them on this card. Each probe moves 7 KB to 0.9 MB, so the
// bound is 2 ns to 0.3 us: bytes / 3.35 TB/s. A launch costs a few
// microseconds, which sets the time of most of them.
//
// What the design does about it: nothing beyond a simple kernel that is
// right, with enough threads to cover the data in one wave. They are not
// on any serving path.
//
//   t2           x * 2, map_kernel<Times2> (841 floats: no multiple of 4)
//   t9           m > 0 ? x : -1e10         mask_kernel
//   t8           softmax over the last axis, one warp per row
//   t10          [841,252] -> [29,29,14,18].sum(-1), one thread per output
//   t14          q k^T, one warp per output, shuffle sum over the depth
//   t13          q @ k^T, 16 x 16 shared-memory tiles

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;     // map kernels loop past this many blocks
constexpr int kTile = 16;            // f32 product tile

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

__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// t8: one warp per row; lane c holds columns c, c + 32, ... (29 of 32 lanes
// live at the probe's width). Max-subtracted, as jax.nn.softmax.
__global__ void softmax_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                               int cols) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const float* xr = x + (size_t)row * cols;
  float m = -INFINITY;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, xr[c]);
  m = warp_max(m);
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += expf(xr[c] - m);
  s = warp_sum(s);
  for (int c = lane; c < cols; c += 32) out[(size_t)row * cols + c] = expf(xr[c] - m) / s;
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

// t13 only (t5's product is tile_product_kernel in probe_tiles.cu):
// out[M, N] = a[M, K] @ b^T, b [N, K], f32 sums. A 16 x 16 block of threads
// owns a 16 x 16 output tile and walks the depth 16 at a time through
// shared memory; the ragged edges load zeros and store nothing.
__global__ void tiled_product_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     float* __restrict__ out, int M, int N, int K) {
  __shared__ float as[kTile][kTile + 1];  // [row][depth]
  __shared__ float bs[kTile][kTile + 1];  // [depth][column]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty, col = blockIdx.x * kTile + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    as[ty][tx] = (row < M && k0 + tx < K) ? a[(size_t)row * K + k0 + tx] : 0.0f;
    const int n = blockIdx.x * kTile + ty;  // read b's rows along the depth, coalesced
    bs[tx][ty] = (n < N && k0 + tx < K) ? b[(size_t)n * K + k0 + tx] : 0.0f;
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) acc += as[ty][kk] * bs[kk][tx];
    __syncthreads();
  }
  if (row < M && col < N) out[(size_t)row * N + col] = acc;
}

int finish() { return (int)cudaGetLastError(); }

template <class Op>
int launch_map(const float* x, float* out, int n, Op op, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  map_kernel<<<map_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, op);
  return finish();
}

}  // namespace

// One launcher a probe (t1, t3, t4, t5, t6, t7, t11 and t12: probe_tiles.cu). Each launches
// on `stream` and returns cudaGetLastError(), so that a refused launch is
// seen at once; the caller checked shapes, types and contiguity. Sizes are
// element counts.
extern "C" {

int dstt_probe_t2(const float* x, float* out, int n, void* stream) {
  return launch_map(x, out, n, Times2{}, stream);
}

int dstt_probe_t8(const float* x, float* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int warps = kThreads / 32;
  softmax_kernel<<<(rows + warps - 1) / warps, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, rows, cols);
  return finish();
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

int dstt_probe_t13(const float* q, const float* k, float* out, int m, int n, int depth,
                   void* stream) {
  if (m <= 0 || n <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  tiled_product_kernel<<<grid, dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(q, k, out, m, n,
                                                                             depth);
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
