// The row-tile machinery of the per-op DMT kernels (equi_update.cu,
// mix_attention.cu), for Hopper (sm_90a), f32 on the CUDA cores.
//
// A block owns a tile of R consecutive rows i of one molecule b, so
// R N <= TR pairs (i, j), TR = 64 (256 threads) or 32 (128 threads): the
// rows of a [TR, K] left operand, kept transposed ([K, TR], k-major) in
// shared memory. A product of that tile with a weight [K, M] (M <= 256)
// streams the weight through a ring of kStages chunks of kKc rows by
// cp.async, so the weight is read from L2 once a tile. The warps split the
// [TR, 256] output (TR / 32) x 4: warp (wr, wc) owns rows 32 wr .. + 31
// and columns 64 wc .. + 63, and its lane (lr, lc) = (lane / 8, lane % 8)
// an 8 x 8 register tile, rows 32 wr + 8 lr + {0..7} and columns
// 64 wc + 4 lc + {0..3} and 64 wc + 32 + 4 lc + {0..3}. Each k step a
// thread reads two float4 of A (its 8 rows; a warp reads 4 addresses 32
// bytes apart, one wavefront) and two float4 of the weight (a warp reads
// 128 contiguous bytes, one wavefront) for 64 fused multiply-adds: 16 for
// every wavefront of shared memory, where a warp owning whole rows would
// spend 10 wavefronts a step. A row's sum over its 256 columns is a
// shuffle over the 8 lanes of its lr, then a sum over the 4 warps wc
// through shared memory, in a fixed order.
//
// The launch plan (plan_rows, mirrored by ops/_row_tile.py) takes, of the
// two tile heights, the one whose busiest SM does the less work:
// ceil(tiles / 132) tiles of 64 rows, or of 32 rows counted as 40. Its R
// is TR / N, cut to 2 where that would leave SMs idle. TR = 32 wins where
// 64-row tiles overflow one wave by a little, as at B = 10, N = 29 (290
// one-row tiles, at most 3 an SM: 120, where 150 two-row tiles of 64 put
// 128 rows on 18 SMs), and for small batches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "async_copy.cuh"
#include "mma.cuh"

namespace dstt {
namespace rows {

constexpr int kCols = 256;     // output columns: 4 warps x 8 lanes x 8
constexpr int kKc = 8;         // weight rows a chunk
constexpr int kStages = 3;     // chunks in flight
constexpr int kRing = kStages * kKc * kCols;  // floats
constexpr int kMaxN = 32;      // a softmax over j is one lane per j
constexpr int kSms = 132;      // H100 SXM
constexpr int kMaxSmem = 232448;    // shared memory a block may use, bytes
constexpr int kSmemPerSm = 233472;  // the SM's, bytes; 1024 of it reserved a block

// A tile of TR rows: its threads, the row stride of its transposed
// operand, and the blocks an SM that __launch_bounds__ asks for (at most
// 128 registers a thread for TR = 64, 170 for TR = 32).
template <int TR>
struct Tiling {
  static_assert(TR == 32 || TR == 64, "tile rows");
  static constexpr int kThreads = 4 * TR, kLdT = TR + 4;
  static constexpr int kMinBlocks = TR == 64 ? 2 : 3;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// Row stride of a tile of `width` floats: 16-byte rows plus 4 floats.
__host__ __device__ inline int ld_of(int width) { return ((width + 3) & ~3) + 4; }

// What a 32-row tile costs in the plan, in rows of a 64-row tile: it
// streams the weights for half the rows, and measured at B = 80 (where
// both heights fill every SM many times over) it took 1.1-1.4 times as
// long a row.
constexpr int kRowCost32 = 40;

// The plan a wrapper passes and the C entry re-checks, in this order.
struct Plan {
  int tile_rows, rows_per_tile, tiles, grid, threads, smem, blocks_per_sm;
};
constexpr int kPlanInts = 7;

// The launch at these shapes; smem_floats(tile_rows, r) gives a block's
// shared memory in floats.
template <class SmemFloats>
__host__ inline Plan plan_rows(int batch, int n, SmemFloats smem_floats) {
  Plan best{};
  int best_cost = 0;
  for (int tr : {64, 32}) {
    Plan p;
    p.tile_rows = tr;
    int r = imin(n, imax(1, tr / n));
    if (batch * cdiv(n, r) < kSms && r > 2) r = 2;
    p.rows_per_tile = r;
    p.tiles = cdiv(n, r);
    p.grid = batch * p.tiles;
    p.threads = 4 * tr;
    p.smem = 4 * smem_floats(tr, r);
    p.blocks_per_sm = imin(tr == 64 ? Tiling<64>::kMinBlocks : Tiling<32>::kMinBlocks,
                           kSmemPerSm / (p.smem + 1024));
    const int cost = cdiv(p.grid, kSms) * (tr == 64 ? 64 : kRowCost32);
    if (p.smem <= kMaxSmem && p.blocks_per_sm >= 1 && (best.tile_rows == 0 || cost < best_cost)) {
      best = p;
      best_cost = cost;
    }
  }
  return best;
}

__host__ inline bool plan_matches(const Plan& p, const int* ints, int n_ints) {
  const int mine[kPlanInts] = {p.tile_rows, p.rows_per_tile, p.tiles, p.grid, p.threads,
                               p.smem, p.blocks_per_sm};
  if (n_ints != kPlanInts || p.tile_rows == 0) return false;
  for (int i = 0; i < kPlanInts; ++i)
    if (ints[i] != mine[i]) return false;
  return true;
}

// A kernel's shared-memory limit and carveout, set once per device at its
// first launch (not on every launch). Each kernel keeps its own Prepared.
struct Prepared {
  static constexpr int kMaxDevices = 64;
  std::once_flag once[kMaxDevices];
  cudaError_t status[kMaxDevices];
};

__host__ inline cudaError_t prepare_device(Prepared& prepared, const void* kernel) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= Prepared::kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(prepared.once[dev], [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    prepared.status[dev] = e;
  });
  return prepared.status[dev];
}

// Launches `kernel(args)` with the plan's grid, threads and shared memory
// on `stream`; returns the first CUDA error, so that a refused launch is
// seen at once.
template <class Args>
__host__ inline cudaError_t launch(Prepared& prepared, const void* kernel, const Plan& p,
                                   Args& args, void* stream) {
  cudaError_t err = prepare_device(prepared, kernel);
  if (err != cudaSuccess) return err;
  void* params[] = {&args};
  err = cudaLaunchKernel(kernel, dim3(p.grid), dim3(p.threads), params, (size_t)p.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of `kernel` an SM holds at the plan's threads and shared memory,
// as the card reports it.
__host__ inline cudaError_t occupancy(Prepared& prepared, const void* kernel, const Plan& p,
                                      int* blocks) {
  cudaError_t err = prepare_device(prepared, kernel);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, p.threads,
                                                       (size_t)p.smem);
}

// The tile of this block: molecule b, rows i0 .. i0 + rows - 1, whose
// pairs are contiguous from pair row0 * n.
struct Tile {
  int b, i0, rows, pairs, row0;
};
__device__ __forceinline__ Tile tile_of(int n, int r, int tiles) {
  Tile t;
  t.b = blockIdx.x / tiles;
  t.i0 = (blockIdx.x - t.b * tiles) * r;
  t.rows = imin(r, n - t.i0);
  t.pairs = t.rows * n;
  t.row0 = t.b * n + t.i0;
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The sum of v over the 8 lanes that share the thread's rows, in a fixed
// order, on each of them.
__device__ __forceinline__ float lanes_sum(float v) {
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows x width floats from src (stride src_ld) to dst (stride ld) by
// cp.async, 16-byte copies where both sides allow them, by kThreads
// threads; the caller commits and waits.
template <int kThreads>
__device__ inline void copy_rows_async(float* dst, int ld, const float* src, int src_ld,
                                       int rows, int width) {
  if (width % 4 == 0 && src_ld % 4 == 0 && ld % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int w4 = width / 4;
    for (int idx = threadIdx.x; idx < rows * w4; idx += kThreads) {
      const int r = idx / w4;
      const int c = 4 * (idx - r * w4);
      cp_async16(dst + r * ld + c, src + (size_t)r * src_ld + c, 16);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
      const int r = idx / width;
      const int c = idx - r * width;
      cp_async4(dst + r * ld + c, src + (size_t)r * src_ld + c, 4);
    }
  }
}

// count floats from src to dst by 4-byte cp.async, by kThreads threads;
// the caller commits and waits.
template <int kThreads>
__device__ inline void copy_async(float* dst, const float* src, int count) {
  for (int idx = threadIdx.x; idx < count; idx += kThreads) cp_async4(dst + idx, src + idx, 4);
}

// rows x width floats of src (stride src_ld) into the transposed tile
// dst (dst[c * ld + r] = src[r * src_ld + c]) by 4-byte cp.async, by
// kThreads threads; the caller commits and waits.
template <int kThreads>
__device__ inline void copy_rows_transposed_async(float* dst, int ld, const float* src,
                                                  int src_ld, int rows, int width) {
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    cp_async4(dst + c * ld + r, src + (size_t)r * src_ld + c, 4);
  }
}

// A weight [K, M] (row stride M) given as two stacked parts: rows
// [0, k_split) from `top`, rows [k_split, K) from `bottom`.
struct Weight {
  const float* top;
  const float* bottom;
  int k_split, K, M;
};

__device__ __forceinline__ int warp_row() { return threadIdx.x >> 7; }         // wr
__device__ __forceinline__ int warp_col() { return (threadIdx.x >> 5) & 3; }   // wc
__device__ __forceinline__ int lane_col() { return threadIdx.x & 7; }          // lc
// The tile row of the thread's register row m.
__device__ __forceinline__ int row_of(int m) {
  return 32 * warp_row() + 8 * ((threadIdx.x >> 3) & 3) + m;
}
// The output column of the thread's register column q.
__device__ __forceinline__ int col_of(int q) {
  return 64 * warp_col() + 32 * (q >> 2) + 4 * lane_col() + (q & 3);
}

// One k step: the thread's 8 rows of A^T[k] times its 8 columns of W[k].
__device__ __forceinline__ void fma_step(float (&acc)[8][8], const float* at, const float* w) {
  const float4 a0 = *reinterpret_cast<const float4*>(at);
  const float4 a1 = *reinterpret_cast<const float4*>(at + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(w);
  const float4 b1 = *reinterpret_cast<const float4*>(w + 32);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
}

// Copies chunk `chunk` (kKc rows) of W into its slot of `ring` by
// cp.async, as one committed group. Columns at or past M and rows at or
// past K are copied as zeros.
template <int TR>
__device__ __forceinline__ void load_chunk(const Weight& W, float* ring, int chunk) {
  constexpr int kChunk = kKc * kCols;
  const bool wide = W.M % 4 == 0 && (reinterpret_cast<uintptr_t>(W.top) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(W.bottom) & 15) == 0;
  float* dst = ring + (chunk % kStages) * kChunk;
  const int k0 = chunk * kKc;
  for (int idx = threadIdx.x; idx < kChunk / 4; idx += Tiling<TR>::kThreads) {
    const int kk = idx / (kCols / 4);
    const int c = 4 * (idx - kk * (kCols / 4));
    const int k = k0 + kk;
    const float* src = k < W.k_split ? W.top + (size_t)k * W.M
                                     : W.bottom + (size_t)(k - W.k_split) * W.M;
    float* d = dst + kk * kCols + c;
    if (wide) {
      const bool in = k < W.K && c < W.M;
      cp_async16(d, in ? src + c : W.top, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k < W.K && c + e < W.M;
        cp_async4(d + e, in ? src + c + e : W.top, in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// Starts streaming W: its first kStages - 1 chunks into `ring`, which must
// be free. Called as early as the ring is free, so that the chunks' trip
// from L2 hides under other work.
template <int TR>
__device__ __forceinline__ void start_ring(const Weight& W, float* ring) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_chunk<TR>(W, ring, s);
}

// acc[m][q] = A[row_of(m), 0:K] @ W[0:K, col_of(q)], with A^T [K, kLdT] in
// shared memory (16-byte aligned) and W in device memory, streamed through
// `ring` (kRing floats) after start_ring(W, ring). A warp whose rows all lie
// at or past `rows` skips the arithmetic. cp.async groups committed before
// start_ring land by the first chunk's wait. Ends with a barrier, so that
// the caller may overwrite A or reuse the ring.
template <int TR>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const float* at, int rows,
                                             const Weight& W, float* ring) {
  using T = Tiling<TR>;
  constexpr int kChunk = kKc * kCols;
  const int n_chunks = cdiv(W.K, kKc);
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
  const bool active = 32 * warp_row() < rows;
  const int a_off = row_of(0), w_off = col_of(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk has landed for every thread; chunk - 1's slot is free
    if (chunk + kStages - 1 < n_chunks) {
      load_chunk<TR>(W, ring, chunk + kStages - 1);
    } else {
      cp_async_commit();  // an empty group keeps the count of groups in flight
    }
    if (active) {
      const float* w = ring + (chunk % kStages) * kChunk + w_off;
      const float* a = at + (size_t)(chunk * kKc) * T::kLdT + a_off;
      const int kn = imin(kKc, W.K - chunk * kKc);
      if (kn == kKc) {
#pragma unroll
        for (int kk = 0; kk < kKc; ++kk) fma_step(acc, a + kk * T::kLdT, w + kk * kCols);
      } else {
        for (int kk = 0; kk < kn; ++kk) fma_step(acc, a + kk * T::kLdT, w + kk * kCols);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- bf16 operands on the tensor cores --------------------------------
//
// With bf16 operands a tile product runs on the tensor cores (mma.cuh,
// m16n8k16, f32 sums; a bf16 x bf16 product is exact in f32). The left
// operand is the tile's [TR, K] rows in shared memory, row-major (bf16,
// row stride lda = ld16(K)), the weight a whole [K, kCols] bf16 tile
// (row stride kMmaLd, zero columns past M), both read by ldmatrix. The
// warps split the [TR, kCols] output (TR / 16) x 2: warp w owns rows
// 16 (w / 2) .. + 15 and columns 128 (w % 2) .. + 127, 16 n8 tiles, and
// lane l (g = l / 4, t = l % 4) of n8 tile nt holds, in acc[nt], rows
// g and g + 8 at columns 8 nt + 2 t and + 1 (mma.cuh's C layout).

constexpr int kMmaLd = kCols + 8;  // bf16s a row of a weight tile: 528 bytes, 4 banks on

// Row stride of a bf16 tile of `width` values: 16-byte rows plus 8 values,
// so that the 8 rows an ldmatrix reads fall in 8 other groups of banks.
__host__ __device__ inline int ld16(int width) { return ((width + 7) & ~7) + 8; }

__device__ __forceinline__ float bf16_to_float(uint16_t x) {
  return __uint_as_float(uint32_t(x) << 16);
}
// Two adjacent bf16 (4-byte aligned) as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(const uint16_t* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// The thread's fragment row h (0: g, 1: g + 8) and the first of its two
// columns in n8 tile nt, in the tile.
__device__ __forceinline__ int frag_row(int h) {
  return 16 * (threadIdx.x >> 6) + ((threadIdx.x >> 2) & 7) + 8 * h;
}
__device__ __forceinline__ int frag_col(int nt) {
  return 128 * ((threadIdx.x >> 5) & 1) + 8 * nt + 2 * (threadIdx.x & 3);
}

// rows x width bf16 from src (stride src_ld) to dst (stride ld) by
// cp.async: 16-byte copies where both sides allow them, else 4-byte ones
// (width, strides and pointers even); by kThreads threads; the caller
// commits and waits.
template <int kThreads>
__device__ inline void copy_bf16_rows_async(uint16_t* dst, int ld, const uint16_t* src, int src_ld,
                                            int rows, int width) {
  const int step = width % 8 == 0 && src_ld % 8 == 0 && ld % 8 == 0 &&
                           ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
                            15) == 0
                       ? 8
                       : 2;
  const int per_row = width / step;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = step * (idx - r * per_row);
    if (step == 8) {
      cp_async16(dst + r * ld + c, src + (size_t)r * src_ld + c, 16);
    } else {
      cp_async4(dst + r * ld + c, src + (size_t)r * src_ld + c, 4);
    }
  }
}

// The weight W [K, M] (bf16, row stride M, M even and at most kCols) into
// dst [K, kMmaLd] by cp.async, columns M .. kCols - 1 as zeros (a tile of
// E*sc = 252 columns gets 4 zero columns: the products of the last n8 tile
// are 0 there and never read); by kThreads threads; the caller commits.
template <int kThreads>
__device__ inline void load_weight_bf16(uint16_t* dst, const uint16_t* W, int K, int M) {
  if (M % 8 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    for (int idx = threadIdx.x; idx < K * (kCols / 8); idx += kThreads) {
      const int k = idx / (kCols / 8);
      const int c = 8 * (idx - k * (kCols / 8));
      const bool in = c < M;
      cp_async16(dst + k * kMmaLd + c, in ? W + (size_t)k * M + c : W, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < K * (kCols / 2); idx += kThreads) {
      const int k = idx / (kCols / 2);
      const int c = 2 * (idx - k * (kCols / 2));
      const bool in = c < M;
      cp_async4(dst + k * kMmaLd + c, in ? W + (size_t)k * M + c : W, in ? 4 : 0);
    }
  }
}

// acc[nt] += A[warp's rows, k0 : k0 + K] @ W[0 : K, warp's columns] on the
// tensor cores: A [TR, lda] bf16 rows in shared memory (16-byte aligned,
// lda a multiple of 8), W [K, kMmaLd] bf16 in shared memory, K a multiple
// of 16. A warp whose rows all lie at or past `rows` skips it (the whole
// warp together: ldmatrix and mma are warp-wide). No barrier.
__device__ __forceinline__ void mma_product(float (&acc)[16][4], const uint16_t* A, int lda, int k0,
                                            int K, const uint16_t* W, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp >> 1), c0 = 128 * (warp & 1);
  if (r0 >= rows) return;
  // ldmatrix rows: A's 16 x 16 (row lane % 16, k 8 (lane / 16)); W's 16 x 16
  // of n8 tiles 2p, 2p + 1 (k lane % 16, column 8 (lane / 16))
  const uint16_t* pa = A + (r0 + (lane & 15)) * lda + k0 + 8 * (lane >> 4);
  const uint16_t* pb = W + (lane & 15) * kMmaLd + c0 + 8 * (lane >> 4);
  for (int k = 0; k < K; k += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, pa + k);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, pb + k * kMmaLd + 16 * p);
      mma_bf16_16816(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

}  // namespace rows
}  // namespace dstt
