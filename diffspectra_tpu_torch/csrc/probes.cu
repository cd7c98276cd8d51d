// Two of the Mosaic probes t1 ... t14 of tools/diag_mosaic_bisect.py, for
// Hopper (sm_90a), f32: t2 and t9. t1, t3-t8 and t10-t14, redesigned for
// this card, are in probe_tiles.cu.
//
// Replaces two of the fourteen TPU kernels of that tool (one
// pl.pallas_call each). The tool bisects which Pallas/Mosaic feature a TPU
// compile refuses, one feature a probe: here unaligned shapes and a masked
// large negative. Each kernel here computes what its probe computes, at the
// probe's shapes, and exercises the counterpart feature of this card:
// masked ragged edges (841 floats are no multiple of the warp or of 4).
//
// What bounds them on this card. Each probe moves 7 to 10 KB, so the bound
// is 2 to 3 ns: bytes / 3.35 TB/s. A launch costs about a microsecond,
// which sets their time.
//
// What the design does about it: nothing beyond a simple kernel that is
// right, with enough threads to cover the data in one wave. They are not
// on any serving path.
//
//   t2           x * 2, map_kernel<Times2> (841 floats: no multiple of 4)
//   t9           m > 0 ? x : -1e10         mask_kernel

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

int finish() { return (int)cudaGetLastError(); }

template <class Op>
int launch_map(const float* x, float* out, int n, Op op, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  map_kernel<<<map_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, op);
  return finish();
}

}  // namespace

// One launcher a probe (the other twelve: probe_tiles.cu). Each launches
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

}  // extern "C"
