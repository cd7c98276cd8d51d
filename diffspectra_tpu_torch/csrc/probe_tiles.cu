// The fourteen Mosaic probes t1 ... t14 of tools/diag_mosaic_bisect.py,
// for Hopper (sm_90a), f32 unless marked. Each replaces one TPU kernel of
// that tool (one pl.pallas_call each), at the probe's shapes.
//
// t3 (tools/diag_mosaic_bisect.py:63) and t4 (:71): x + 1 on [8, 29, 29,
// 64]; t4 over a grid of 8 steps, each step finding its slice x[b] from its
// grid index, as the BlockSpec (1, 29, 29, 64) cut it on the TPU, t3 on the
// whole array at once. t11 (:136): x * 2 on [2, 29, 29, 14, 18], 423,864
// floats, the whole array at once. t1 (:47): x * 2, and t6 (:94): tanh(x),
// each on [256, 256], 65,536 floats, the whole array at once.
//   What bounds them: t3 and t4 move 1.72 MB in and 1.72 MB out, 1.03 us
//   at 3.35 TB/s, t11 1.70 MB each way; at this size the ramp and tail of
//   one wave of blocks weigh as much, and a launch of about 1.1 us on the
//   card is the real floor (PERF.md). t1 and t6 move 0.26 MB in and 0.26 MB out, 0.157 us at 3.35
//   TB/s, so the launch alone sets their time.
//   What the design does: one kernel for the five, its elementwise
//   operation a template parameter (PlusOne, Times2, Tanh). The grid stays
//   one over the steps (grid.y: 8 for t4, 1 for the others, whose arrays
//   are one step), but each step is cut into chunks of 128 threads x 2
//   float4 (grid.x: 53 blocks a step at t4's 53,824 floats, 424 in all;
//   421 at t3's 430,592; 414 at t11's; 64 at t1's and t6's 65,536), so
//   that the whole grid is one wave over the 132 SMs with every SM's loads
//   in flight at once, 16 bytes a load; each step's last chunk is masked.
//   A block reads its step and chunk from blockIdx without a division (on
//   the card a flat grid that divided blockIdx.x was slower, PERF.md). The
//   launcher sizes the grid itself from the steps and the floats a step. A
//   step's floats must be a multiple of 4 and both pointers 16-byte
//   aligned (no scalar path). Tanh is the precise tanhf (a few ulp), never
//   __tanhf or tanh.approx.f32, whose relative error of about 2^-11 would
//   break t6's 1e-6; the build passes no fast-math flag.
//
// t2 (tools/diag_mosaic_bisect.py:55): x * 2, and t9 (:119): where(m > 0,
// x, -1e10), on [29, 29]: 841 floats, no multiple of the warp or of 4, the
// probes' feature being that unaligned shape (and t9's a masked large
// negative).
//   What bounds them: t2 moves 6.7 KB, t9 10.1 KB, 2 to 3 ns at 3.35 TB/s.
//   Their time is the launch and one round trip of dependent loads: an
//   empty kernel takes 0.83 to 0.89 us of device time on the card, t2
//   0.26 us more (PERF.md, tools/probe_variants.py floor).
//   What the design does: map_kernel<Op>, one float a thread in blocks of
//   256 threads (4 at 841 floats), a grid-stride loop past 4096 blocks, the
//   operation a template parameter that says how many arrays it reads
//   (Times2 one; Where two, t9's mask in Args.w). So every thread starts its
//   one or two loads, then its one store, and no thread straddles a ragged
//   end: a float past the array is a thread that does nothing. Where takes
//   both values as arguments, so x's load goes out beside the mask's; the
//   first port's m[i] > 0 ? x[i] : -1e10f read x only where the mask was
//   above 0, after the mask's load, and took 0.13 us longer. The chunk
//   kernel above as one step (a block of 128 threads, 16-byte loads, the
//   last float4 slot a ragged tail of scalars) was slower on the card for
//   both probes in every round, and so was each of its narrower blocks: at
//   this size a thread's instructions, not its bytes, set the time
//   (tools/probe_variants.py t2, t9; PERF.md). Where is m > 0.0f ? x :
//   -1e10f, so a NaN or -0 mask gives -1e10, as jnp.where and torch.where
//   do; the build passes no flag that flushes denormals, so a denormal mask
//   above 0 keeps x. wgmma, TMA and shared-memory staging have nothing to
//   act on: there is no product, and a few KB do not pay for a TMA
//   descriptor's setup. Any size above 0, pointers 4-byte aligned.
//
// t12 (tools/diag_mosaic_bisect.py:144): scratch = 2x in a VMEM scratch
// buffer, out = scratch + 1, on [256, 256].
//   What bounds it: 0.26 MB in and 0.26 MB out, 0.16 us at 3.35 TB/s; the
//   launch of a few us sets the time.
//   What the design does: the probe's feature is the scratch, so the values
//   go through shared memory and come back to another warp after a
//   barrier: a block of 128 threads takes 2 float4 a thread, both loads in
//   flight before the first shared store (1024 floats, 4 KB of dynamic
//   shared memory; 64 blocks at the probe's 65,536 floats, one wave), writes
//   2x to its slots of the tile, and after the barrier each thread reads
//   the mirrored slots (live - 1 - i, live the block's float4: thread 0
//   reads what warp 3 wrote), adds 1 and stores them there. On the card
//   this ran faster than one float4 a thread in 128 blocks (PERF.md). 2x is
//   exact in f32, so 2x + 1 rounds once. The floats must be a multiple of 4
//   and both pointers 16-byte aligned.
//
// t5 (tools/diag_mosaic_bisect.py:85): out[M, N] = x[M, K] @ w[K, N],
// [841, 64] @ [64, 252].
//   What bounds it: 27.1 MFLOP, 0.41 us at 67 TFLOP/s f32, over its 1.13
//   MB (0.34 us): operations. A grid this small cannot come near it; the
//   yardstick is one cuBLAS call.
//   What the design does: a block owns a 32 x 64 output tile (108 blocks of
//   128 threads at the probe's shape, one wave over the 132 SMs; of five
//   tiles timed on the card this one was the fastest, PERF.md), as the
//   launch plan of ops/probes.py::product_plan says and this source
//   re-checks. Its x rows and w slab go into dynamic shared memory by 16-byte cp.async in two 32-deep
//   chunks, one copy group each, zeros past the ragged edges (841 = 26 x 32
//   + 9 rows, 252 = 3 x 64 + 60 columns) and past K; the second chunk
//   lands while the first is summed. A warp owns 16 x 32 outputs, a lane
//   4 x 4: rows r0 + {0, 4, 8, 12} (so that the 4 rows a warp reads at one
//   k fall in other banks) and 4 neighbouring columns. Each step of 4 along
//   K reads 4 float4 of x and 4 of w, one wavefront each, for 64 FMAs; the
//   stores are float4, rows past M and columns past N stored not at all.
//   On the card the launch, the operands' trip from L2 and the FMAs each
//   took about a third of the time before the two chunks overlapped the
//   last two (PERF.md). The sums run in order along K with f32 FMAs on the
//   CUDA cores: TF32 mma cannot hold the probe's 1e-4 at a 64-deep sum of
//   unit normals. K must be at most 64, N and K multiples of 4 and the
//   three pointers 16-byte aligned.
//
// t7 (tools/diag_mosaic_bisect.py:102): out[M, N] (f32) = x[M, K] (bf16) @
// w[K, N] (bf16), [841, 64] @ [64, 256].
//   What bounds it: 0.11 MB of bf16 in and 0.86 MB of f32 out, 0.30 us at
//   3.35 TB/s; its 27.6 MFLOP take 0.03 us at the bf16 tensor-core rate. So
//   the launch, the operands' trip and the stores set its time, not the
//   tensor cores.
//   What the design does: t5's copy pipeline with the sums on the tensor
//   cores. A block of four warps owns a 64 x 32 output tile (2-D grid of
//   column and row tiles: 8 x 14 = 112 blocks at the probe's shape, one wave
//   over the 132 SMs; the 64 x 64 tiles before left 76 SMs idle; on the
//   card t5's 32 x 64 tile, 108 blocks, was 2% slower, PERF.md), and warp w
//   its rows 16 w ... 16 w + 15, 16 x 32 outputs, as four mma.sync
//   m16n8k16 tiles with f32 sums in registers. The x rows and the
//   w slab go straight into dynamic shared memory by 16-byte cp.async in two
//   32-deep chunks, one copy group each, so that the second lands while the
//   first is multiplied; rows past M, columns past N and depths past K load
//   zeros. Shared rows are padded by 16 bytes, so that the 8 rows an
//   ldmatrix reads fall in 8 different groups of 4 banks. A fragments come
//   by one ldmatrix.x4 a k16 step; B fragments straight from w's [k][n]
//   layout by ldmatrix.x4.trans, two n8 tiles an instruction, with no
//   transpose through registers. After a barrier the f32 tile is staged
//   through the operands' shared memory and stored as float4 rows,
//   neighbouring threads on neighbouring addresses; rows past M are not
//   stored. Why not wgmma with TMA: the tensor work is a tenth of the bound
//   set by bytes and a small part of a launch of about a microsecond, so
//   wgmma's 64-row warpgroup tile buys throughput this probe cannot use,
//   and its swizzled shared-memory descriptors have no CPU stand-in to
//   check them (mma.cuh's instructions do). K must be at most 64, N and K
//   multiples of 8 and the three pointers 16-byte aligned.
//
// t8 (tools/diag_mosaic_bisect.py:111): softmax over the last axis of [29,
// 29], max-subtracted as jax.nn.softmax.
//   What bounds it: 3.4 KB in and 3.4 KB out, 2 ns at 3.35 TB/s; the
//   launch sets the time.
//   What the design does: a warp a row, four rows a block of 128 threads
//   (8 blocks at the probe's 29 rows, one wave). Lane c holds columns c, c
//   + 32, c + 64 and c + 96 in registers, all four loads in flight before
//   the max (lanes past the row hold -inf), so the row is read once and
//   exponentiated once: the warp's max, expf(v - max) kept in registers,
//   the warp's sum, a division, a store. The slots a lane holds are a
//   compile-time count, so that they stay in registers: loops over the
//   columns of unknown trip count read the row again for each pass. The
//   precise expf and the division, never __expf or ex2.approx: the
//   probe's tolerance is 1e-6. 29-float rows are not 16-byte aligned, so
//   the loads stay 4 bytes wide. At most 128 columns.
//
// t13 (tools/diag_mosaic_bisect.py:158): out[i, j] = q_i . k_j, q and k
// [29, 252], out [29, 29]. t14 (:168): the same function written as
// (q[:, None, :] * k[None, :, :]).sum(-1), q and k [29, 64].
//   What bounds them: t13 moves 58 KB in and 3.4 KB out, 18 ns at 3.35
//   TB/s, and does 0.42 MFLOP, 6 ns at 67 TFLOP/s f32; t14 moves 15 KB in
//   and 3.4 KB out, 5 ns. The launch sets their time.
//   What the design does: one kernel for both, its lanes an output a
//   template parameter. t13 gives an output a warp, four a block of 128
//   threads (211 blocks at the probe's 841 outputs; at 16 blocks an SM all
//   are resident at once): lane l takes float4 l and l + 32 of the depth
//   from both rows, all four 16-byte loads in flight before the first FMA,
//   sums its products in order, then a shuffle sum over the warp, and lane
//   0 stores: one round of loads and no barrier, where 16 x 16 shared tiles
//   on 4 blocks walk the depth in 16 dependent trips to L2. Each row is
//   read from L2 by n or m warps, 1.7 MB in all at t13's shape. t14's
//   depth of 64 is 16 float4, so a warp an output left lanes 16-31 with
//   nothing to load; it gives an output half a warp, two a warp, each
//   summed over a 16-lane shuffle, eight a block (106 blocks), which beat
//   a warp an output on the card (tools/probe_variants.py, PERF.md). f32
//   FMAs on the CUDA cores: TF32 mma cannot hold the probes' 1e-4 and 1e-5
//   (t5's note). The depth must be a multiple of 4, at most 256 for t13
//   and 128 for t14, q and k 16-byte aligned.
//
// t10 (tools/diag_mosaic_bisect.py:128): x [841, 252] reshaped to [29, 29,
// 14, 18] and summed over the last axis, out [29, 29, 14].
//   What bounds it: 848 KB in and 47 KB out, 0.27 us at 3.35 TB/s; the
//   launch of about 1.1 us on the card sets nearly all of its time.
//   What the design does: the reshape keeps memory order, so output o sums
//   the contiguous floats x[seg o ... seg o + seg - 1], and a block's 56
//   outputs (four of the probe's 252-float rows) are one contiguous run of
//   56 seg floats from a 16-byte boundary. A block of 128 threads stages
//   that run in shared memory (7 KB at the most, seg = 32), float4 i of it
//   by thread i % 128, neighbouring threads on neighbouring addresses, all
//   of a thread's loads in flight before its first shared store (2 at the
//   probe's seg of 18; a run of 4 k + 2 floats ends on a float2). After
//   the barrier thread t < 56 sums output t in order from shared memory and
//   the block stores its 56 outputs contiguously: 211 blocks at the probe's
//   11,774 outputs, one wave. Two sums a thread straight from registers
//   (9 float4 a thread 144 bytes apart, 92 blocks of 64) was slower on the
//   card (PERF.md). seg must be even and x 16-byte aligned.
//
// Each kernel launches through cudaLaunchKernel with one Args struct and
// uses dynamic shared memory only, so that the host test's stand-in
// (tests/test_torch_probes_host.py) runs this source on the CPU.

#include <cuda_bf16.h>

#include "mma.cuh"
#include "row_tile.cuh"

namespace {

using dstt::cp_async16;
using dstt::cp_async_commit;
using dstt::cp_async_wait;
using dstt::rows::cdiv;
using dstt::rows::warp_max;
using dstt::rows::warp_sum;
using bf16 = __nv_bfloat16;

// t1, t3, t4, t6, t11 and t12: one chunk of a flat array a block, 128 threads x 2 float4
constexpr int kChunkThreads = 128;
constexpr int kChunkVectors = 2;
constexpr int kChunkSlots = kChunkThreads * kChunkVectors;      // float4 a chunk
constexpr int kStageSmem = 16 * kChunkSlots;                    // t12: shared bytes a block
constexpr int kWarpRows = 16, kWarpCols = 32;                   // t5: a warp's outputs
constexpr int kTileRows = 32, kTileCols = 64;                   // t5: a block's outputs
constexpr int kProductThreads = kTileRows * kTileCols / 16;     // t5: 4 x 4 outputs a thread
// t5: the depth in two chunks of 32, each one cp.async group; K <= 64,
// zeros past K. With the depth fixed the loops unroll whole, which the
// card ran faster than a loop over K's chunks (PERF.md).
constexpr int kKc = 32, kChunks = 2, kMaxDepth = kKc * kChunks;
// t5: the stride of x's rows in a chunk, floats: 16-byte rows, and 4 rows
// in other banks
constexpr int kLdx = kKc + 4;
// t5: shared bytes a block, x [kChunks][kTileRows][kLdx] and w [kMaxDepth][kTileCols]
constexpr int kProductSmem = 4 * kChunks * (kTileRows * kLdx + kKc * kTileCols);
// t7: a block's outputs, four warps of 16 x 32 each (tools/probe_variants.py
// times 32 x 64 against it); the depth in t5's two chunks of 32
constexpr int kMmaRows = 64, kMmaCols = 32;
constexpr int kMmaThreads = 128;
constexpr int kMmaWarpsC = kMmaCols / 32;
static_assert(kMmaRows / 16 * kMmaWarpsC * 32 == kMmaThreads, "four warps of 16 x 32");
// t7: the strides of shared rows, 16 bytes of padding each: x [kMmaRows][kLda]
// and w [kMaxDepth][kLdb] bf16, then the output tile [kMmaRows][kLdo] f32 in
// the same memory (8 floats of padding: the float2 stores of a half-warp's
// four rows fall in other banks)
constexpr int kLda = kMaxDepth + 8, kLdb = kMmaCols + 8, kLdo = kMmaCols + 8;
constexpr int kMmaSmem = 2 * (kMmaRows * kLda + kMaxDepth * kLdb);
static_assert(4 * kMmaRows * kLdo <= kMmaSmem, "the output tile fits the operands' memory");
// t8, t13 and t14: four warps a block, a warp a row (t8) or an output
// (t13), half a warp an output (t14)
constexpr int kRowThreads = 128;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kSoftmaxSlots = 4;                              // t8: columns a lane
constexpr int kMaxSoftmaxCols = 32 * kSoftmaxSlots;
constexpr int kDotVectors = 2;                                // t13, t14: float4 of the depth a lane
constexpr int kT13Lanes = 32;                                 // t13: lanes an output, depth <= 256
// t14: lanes an output, depth <= 128; 16 beat 32 on the card (PERF.md)
constexpr int kT14Lanes = 16;
// t10: sums of at most kMaxSeg floats, kStageSums a block staged through
// shared memory
constexpr int kMaxSeg = 32;
constexpr int kStageThreads = 128;
constexpr int kStageSums = 56;                                // four of the probe's [252] rows
constexpr int kStageSlots = (kStageSums * kMaxSeg / 4 + kStageThreads - 1) / kStageThreads;
constexpr int kSegStageSmem = 4 * kStageSums * kMaxSeg;
// t2, t9: a float a thread, blocks of kMapThreads, a grid-stride loop past
// kMaxMapBlocks blocks
constexpr int kMapThreads = 256;
constexpr int kMaxMapBlocks = 4096;

// Every kernel's arguments.
struct Args {
  const float* x;  // the flat probes: [steps, per_step]; t5: [m, k]; t8: [m, n]; t13: q [m, k]
  const float* w;  // t5: [k, n]; t13: k [n, k]; t9: the mask, as x
  float* out;
  int per_step;                   // the flat probes (all but t4: one step, the whole array);
                                  // t2, t9: the floats
  int m, n, k, col_tiles;         // t5; t7, t13, t14: m, n, k (the depth); t8: rows m,
                                  // columns n; t10: m sums of n floats each
  const bf16* xb;                 // t7: [m, k]
  const bf16* wb;                 // t7: [k, n]
};

// The elementwise operations; map_kernel's (t2, t9) say how many arrays
// they read.
struct PlusOne {  // t3, t4
  __device__ float operator()(float v) const { return v + 1.0f; }
};
struct Times2 {  // t1, t2, t11
  static constexpr int kInputs = 1;
  __device__ float operator()(float v) const { return v * 2.0f; }
};
struct Tanh {  // t6: the precise tanhf
  __device__ float operator()(float v) const { return tanhf(v); }
};
struct Where {  // t9: x where the mask is above 0, else -1e10 (NaN and -0 too)
  static constexpr int kInputs = 2;
  __device__ float operator()(float v, float m) const { return m > 0.0f ? v : -1e10f; }
};

// t1, t3, t4, t6, t11: block (chunk, step) = blockIdx (x, y).
template <class Op>
__global__ void __launch_bounds__(kChunkThreads) grid_step_kernel(Args a) {
  const float4* x = reinterpret_cast<const float4*>(a.x + (size_t)blockIdx.y * a.per_step);
  float4* out = reinterpret_cast<float4*>(a.out + (size_t)blockIdx.y * a.per_step);
  const int n4 = a.per_step / 4;
  const int first = blockIdx.x * kChunkSlots + threadIdx.x;
  float4 v[kChunkVectors];
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {  // every load in flight before the first store
    const int i = first + e * kChunkThreads;
    if (i < n4) v[e] = x[i];
  }
  const Op op{};
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {
    const int i = first + e * kChunkThreads;
    if (i < n4) out[i] = make_float4(op(v[e].x), op(v[e].y), op(v[e].z), op(v[e].w));
  }
}

// t2, t9: thread i of the grid takes floats i, i + the grid's threads, ...
// of x (and of t9's mask in w).
template <class Op>
__global__ void __launch_bounds__(kMapThreads) map_kernel(Args a) {
  const float* __restrict__ x = a.x;
  const float* __restrict__ w = a.w;
  float* __restrict__ out = a.out;
  const Op op{};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.per_step; i += gridDim.x * blockDim.x) {
    if constexpr (Op::kInputs == 1) {
      out[i] = op(x[i]);
    } else {
      out[i] = op(x[i], w[i]);
    }
  }
}

// t12: block b stages float4 256 b ... 256 b + 255 (its last block fewer);
// thread t the slots i = t and t + 128.
__global__ void __launch_bounds__(kChunkThreads) stage_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float4* tile = reinterpret_cast<float4*>(smem);  // [kChunkSlots]: 2x
  const int first = blockIdx.x * kChunkSlots;      // the block's first float4
  const int live = min(kChunkSlots, a.per_step / 4 - first);
  float4 v[kChunkVectors];
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {  // every load in flight before the first store
    const int i = threadIdx.x + e * kChunkThreads;
    if (i < live) v[e] = reinterpret_cast<const float4*>(a.x)[first + i];
  }
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {
    const int i = threadIdx.x + e * kChunkThreads;
    if (i < live) tile[i] = make_float4(2.0f * v[e].x, 2.0f * v[e].y, 2.0f * v[e].z, 2.0f * v[e].w);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {  // the mirrored slot, which another warp wrote
    const int i = threadIdx.x + e * kChunkThreads;
    if (i < live) {
      const int j = live - 1 - i;
      const float4 s = tile[j];
      reinterpret_cast<float4*>(a.out)[first + j] =
          make_float4(s.x + 1.0f, s.y + 1.0f, s.z + 1.0f, s.w + 1.0f);
    }
  }
}

// t5's operands for depth chunk `ch` (k = 32 ch ... 32 ch + 31) by cp.async
// into xs [kChunks][kTileRows][kLdx] and ws [kMaxDepth][kTileCols]; rows
// past m, columns past n and depths past k as zeros. The caller commits.
__device__ __forceinline__ void load_chunk(const Args& a, float* xs, float* ws, int ch, int row0,
                                           int col0) {
  constexpr int R = kTileRows, C = kTileCols;
  const int k0 = ch * kKc;
  for (int i = threadIdx.x; i < R * kKc / 4; i += kProductThreads) {
    const int r = i / (kKc / 4), k = k0 + 4 * (i % (kKc / 4));
    const bool in = row0 + r < a.m && k < a.k;
    cp_async16(xs + (ch * R + r) * kLdx + k - k0, in ? a.x + (size_t)(row0 + r) * a.k + k : a.x,
               in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kKc * C / 4; i += kProductThreads) {
    const int k = k0 + i / (C / 4), c = 4 * (i % (C / 4));
    const bool in = k < a.k && col0 + c < a.n;
    cp_async16(ws + k * C + c, in ? a.w + (size_t)k * a.n + col0 + c : a.w, in ? 16 : 0);
  }
}

// One depth chunk of the lane's 4 x 4 outputs: xp at its first row of the
// chunk's x tile, wp at its first column of the chunk's first w row.
__device__ __forceinline__ void chunk_fma(float (&acc)[4][4], const float* xp, const float* wp) {
#pragma unroll
  for (int kk = 0; kk < kKc; kk += 4) {
    float xv[4][4], wv[4][4];  // [row m][k j], [k j][column q]
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(xp + 4 * m * kLdx + kk);
      xv[m][0] = v.x, xv[m][1] = v.y, xv[m][2] = v.z, xv[m][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(wp + (kk + j) * kTileCols);
      wv[j][0] = v.x, wv[j][1] = v.y, wv[j][2] = v.z, wv[j][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(xv[m][j], wv[j][q], acc[m][q]);
  }
}

__global__ void __launch_bounds__(kProductThreads) tile_product_kernel(Args a) {
  constexpr int R = kTileRows, C = kTileCols;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kChunks][R][kLdx]
  float* ws = smem + kChunks * R * kLdx;     // [kMaxDepth][C]
  const int tile_r = blockIdx.x / a.col_tiles;
  const int row0 = tile_r * R, col0 = (blockIdx.x - tile_r * a.col_tiles) * C;
  // one group of copies a chunk, so that the second lands while the first
  // is summed
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    load_chunk(a, xs, ws, ch, row0, col0);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarpsC = C / kWarpCols;
  const int r0 = (warp / kWarpsC) * kWarpRows + lane / 8;       // rows r0 + 4 m
  const int c0 = (warp % kWarpsC) * kWarpCols + 4 * (lane % 8);  // columns c0 + q
  float acc[4][4] = {};
  static_assert(kChunks == 2, "one wait a chunk");
  cp_async_wait<1>();
  __syncthreads();
  chunk_fma(acc, xs + r0 * kLdx, ws + c0);
  cp_async_wait<0>();
  __syncthreads();
  chunk_fma(acc, xs + (R + r0) * kLdx, ws + kKc * C + c0);

  if (col0 + c0 >= a.n) return;  // n % 4 == 0: a lane's 4 columns are all in or all out
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = row0 + r0 + 4 * m;
    if (row < a.m) {
      *reinterpret_cast<float4*>(a.out + (size_t)row * a.n + col0 + c0) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// t7's operands for depth chunk `ch` (k = 32 ch ... 32 ch + 31) by cp.async
// into xs [kMmaRows][kLda] and ws [kMaxDepth][kLdb], 8 bf16 a copy; rows
// past m, columns past n and depths past k as zeros (n and k are multiples
// of 8, so a copy is all in or all out). The caller commits.
__device__ __forceinline__ void load_mma_chunk(const Args& a, bf16* xs, bf16* ws, int ch, int row0,
                                               int col0) {
  const int k0 = ch * kKc;
  for (int i = threadIdx.x; i < kMmaRows * kKc / 8; i += kMmaThreads) {
    const int r = i / (kKc / 8), k = k0 + 8 * (i % (kKc / 8));
    const bool in = row0 + r < a.m && k < a.k;
    cp_async16(xs + r * kLda + k, in ? a.xb + (size_t)(row0 + r) * a.k + k : a.xb, in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kKc * kMmaCols / 8; i += kMmaThreads) {
    const int k = k0 + i / (kMmaCols / 8), c = 8 * (i % (kMmaCols / 8));
    const bool in = k < a.k && col0 + c < a.n;
    cp_async16(ws + k * kLdb + c, in ? a.wb + (size_t)k * a.n + col0 + c : a.wb, in ? 16 : 0);
  }
}

// One depth chunk of a warp's 16 x 32 outputs: pa at the lane's ldmatrix
// row of x (row l % 16, k 8 (l / 16)), pb at its row of w (k l % 16,
// column 8 (l / 16) of the warp's first n8 pair), both at the chunk's
// first k. acc[nt] is n8 tile nt.
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4], const bf16* pa, const bf16* pb) {
#pragma unroll
  for (int ks = 0; ks < kKc; ks += 16) {
    uint32_t af[4], bf[2][4];  // bf[p]: b0, b1 of n8 tile 2p, then of 2p + 1
    dstt::ldmatrix_x4(af, pa + ks);
    dstt::ldmatrix_x4_trans(bf[0], pb + ks * kLdb);
    dstt::ldmatrix_x4_trans(bf[1], pb + ks * kLdb + 16);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      dstt::mma_bf16_16816(acc[nt], af, bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
    }
  }
}

// t7: block (column tile, row tile) = blockIdx (x, y).
__global__ void __launch_bounds__(kMmaThreads) mma_tile_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kMmaRows][kLda]: x[row][k]
  bf16* ws = xs + kMmaRows * kLda;           // [kMaxDepth][kLdb]: w[k][column]
  const int row0 = blockIdx.y * kMmaRows, col0 = blockIdx.x * kMmaCols;
  // one group of copies a chunk, so that the second lands while the first
  // is multiplied
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    load_mma_chunk(a, xs, ws, ch, row0, col0);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kMmaWarpsC * 16, wc = warp % kMmaWarpsC * 32;  // the warp's first output
  const bf16* pa = xs + (wr + lane % 16) * kLda + 8 * (lane / 16);
  const bf16* pb = ws + (lane % 16) * kLdb + wc + 8 * (lane / 16);
  float acc[4][4] = {};
  static_assert(kChunks == 2, "one wait a chunk");
  cp_async_wait<1>();
  __syncthreads();
  mma_chunk(acc, pa, pb);
  cp_async_wait<0>();
  __syncthreads();
  mma_chunk(acc, pa + kKc, pb + kKc * kLdb);

  __syncthreads();  // every warp is done with the operands: their memory takes the output
  float* os = smem;  // [kMmaRows][kLdo]
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // C fragment rows g and g + 8
      *reinterpret_cast<float2*>(os + (wr + g + 8 * h) * kLdo + wc + 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMmaRows * kMmaCols / 4; i += kMmaThreads) {
    const int r = i / (kMmaCols / 4), c = 4 * (i % (kMmaCols / 4));
    if (row0 + r < a.m && col0 + c < a.n) {  // n % 8 == 0: a float4 is all in or all out
      *reinterpret_cast<float4*>(a.out + (size_t)(row0 + r) * a.n + col0 + c) =
          *reinterpret_cast<const float4*>(os + r * kLdo + c);
    }
  }
}

// t8: warp w of block b takes row 4 b + w.
__global__ void __launch_bounds__(kRowThreads) row_softmax_kernel(Args a) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= a.m) return;  // the whole warp leaves together
  const float* x = a.x + (size_t)row * a.n;
  float v[kSoftmaxSlots];
#pragma unroll
  for (int e = 0; e < kSoftmaxSlots; ++e) {  // every load in flight before the max
    const int c = lane + 32 * e;
    v[e] = c < a.n ? x[c] : -INFINITY;
  }
  float mx = v[0];
#pragma unroll
  for (int e = 1; e < kSoftmaxSlots; ++e) mx = fmaxf(mx, v[e]);
  mx = warp_max(mx);
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < kSoftmaxSlots; ++e) {
    v[e] = lane + 32 * e < a.n ? expf(v[e] - mx) : 0.0f;
    s += v[e];
  }
  s = warp_sum(s);
  float* out = a.out + (size_t)row * a.n;
#pragma unroll
  for (int e = 0; e < kSoftmaxSlots; ++e) {
    const int c = lane + 32 * e;
    if (c < a.n) out[c] = v[e] / s;
  }
}

// t13, t14: lanes Lanes g ... Lanes g + Lanes - 1 of block b take output p
// = (kRowThreads / Lanes) b + g, (i, j) = (p / n, p % n). Lanes past the
// outputs load nothing and store nothing but stay for the shuffles.
template <int Lanes>
__global__ void __launch_bounds__(kRowThreads) dot_rows_kernel(Args a) {
  const int p = blockIdx.x * (kRowThreads / Lanes) + threadIdx.x / Lanes, lane = threadIdx.x % Lanes;
  const bool live = p < a.m * a.n;
  const int i = live ? p / a.n : 0, j = live ? p - i * a.n : 0, depth4 = live ? a.k / 4 : 0;
  const float4* q = reinterpret_cast<const float4*>(a.x + (size_t)i * a.k);
  const float4* k = reinterpret_cast<const float4*>(a.w + (size_t)j * a.k);
  float4 qv[kDotVectors], kv[kDotVectors];
#pragma unroll
  for (int e = 0; e < kDotVectors; ++e) {  // every load in flight before the first FMA
    const int c = lane + Lanes * e;
    qv[e] = kv[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < depth4) qv[e] = q[c], kv[e] = k[c];
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < kDotVectors; ++e) {
    s = fmaf(qv[e].x, kv[e].x, s);
    s = fmaf(qv[e].y, kv[e].y, s);
    s = fmaf(qv[e].z, kv[e].z, s);
    s = fmaf(qv[e].w, kv[e].w, s);
  }
#pragma unroll
  for (int off = Lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (live && lane == 0) a.out[p] = s;
}

// t10: block b sums outputs kStageSums b ... kStageSums b + kStageSums - 1
// (its last block fewer). Its floats go into shared memory by coalesced
// float4 loads, kStageSlots a thread, all in flight before the first shared
// store; after the barrier thread t < kStageSums sums output t from there.
__global__ void __launch_bounds__(kStageThreads) segment_stage_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];  // [kStageSums][seg]
  const int first = blockIdx.x * kStageSums, seg = a.n;
  const int sums = min(kStageSums, a.m - first), live = sums * seg;  // floats, even
  const float* x = a.x + (size_t)first * seg;  // 16-byte aligned: kStageSums seg is a multiple of 4
  float4 v[kStageSlots];
#pragma unroll
  for (int e = 0; e < kStageSlots; ++e) {  // every load in flight before the first store
    const int i = threadIdx.x + kStageThreads * e;
    if (4 * i + 4 <= live) {
      v[e] = reinterpret_cast<const float4*>(x)[i];
    } else if (4 * i + 2 == live) {
      const float2 h = reinterpret_cast<const float2*>(x)[2 * i];
      v[e] = make_float4(h.x, h.y, 0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int e = 0; e < kStageSlots; ++e) {
    const int i = threadIdx.x + kStageThreads * e;
    if (4 * i + 4 <= live) {
      reinterpret_cast<float4*>(smem)[i] = v[e];
    } else if (4 * i + 2 == live) {
      reinterpret_cast<float2*>(smem)[2 * i] = make_float2(v[e].x, v[e].y);
    }
  }
  __syncthreads();
  if (threadIdx.x >= sums) return;
  const float* row = smem + threadIdx.x * seg;
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxSeg; ++c) {  // in order along the segment
    if (c < seg) s += row[c];
  }
  a.out[first + threadIdx.x] = s;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

bool plan_matches(const int* mine, int n_mine, const int* plan, int n_plan) {
  if (plan == nullptr || n_plan != n_mine) return false;
  for (int i = 0; i < n_mine; ++i)
    if (plan[i] != mine[i]) return false;
  return true;
}

// t5's launch: tile rows, tile columns, threads, blocks, shared bytes. The
// shared memory is under the 48 KB a block has without asking.
struct ProductPlan {
  int rows, cols, threads, grid, smem;
};

ProductPlan product_plan(int m, int n) {
  return {kTileRows, kTileCols, kProductThreads, cdiv(m, kTileRows) * cdiv(n, kTileCols),
          kProductSmem};
}

cudaError_t launch(const void* kernel, dim3 grid, int threads, int smem, Args& a, void* stream) {
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(threads), params, (size_t)smem,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// grid_step_kernel<Op> over `steps` steps of `per_step` floats.
template <class Op>
int launch_steps(const float* x, float* out, int steps, int per_step, void* stream) {
  if (steps <= 0 || per_step <= 0 || per_step % 4 != 0) return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(out)) return (int)cudaErrorMisalignedAddress;
  Args a{x, nullptr, out, per_step, 0, 0, 0, 0};
  const dim3 grid(cdiv(per_step, 4 * kChunkSlots), steps);
  return (int)launch((const void*)grid_step_kernel<Op>, grid, kChunkThreads, 0, a, stream);
}

// map_kernel<Op> over n floats of x (and of w, t9's mask).
template <class Op>
int launch_map(const float* x, const float* w, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Args a{x, w, out, n, 0, 0, 0, 0};
  const int blocks = min(kMaxMapBlocks, cdiv(n, kMapThreads));
  return (int)launch((const void*)map_kernel<Op>, dim3(blocks), kMapThreads, 0, a, stream);
}

// dot_rows_kernel<Lanes> over q [m, depth] and k [n, depth] (t13, t14).
template <int Lanes>
int launch_dot_rows(const float* q, const float* k, float* out, int m, int n, int depth,
                    void* stream) {
  if (m <= 0 || n <= 0 || depth <= 0 || depth % 4 != 0 || depth > 4 * Lanes * kDotVectors) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned(q) || misaligned(k)) return (int)cudaErrorMisalignedAddress;  // out: 4-byte stores
  Args a{q, k, out, 0, m, n, depth, 0};
  return (int)launch((const void*)dot_rows_kernel<Lanes>, dim3(cdiv(m * n, kRowThreads / Lanes)),
                     kRowThreads, 0, a, stream);
}

}  // namespace

// Each launches on `stream` and returns the first CUDA error, so that a
// refused launch is seen at once: cudaErrorInvalidValue for a size that is
// not positive, an array (but t2's and t9's), a step or a row that is not a
// multiple of 4 floats (t7: N or K not a multiple of 8), a t5 or t7 depth over 64, a t13
// depth over 256 or a t14 depth over 128, t8 rows over 128 columns, a t10
// segment that is odd or over 32 floats, or a t5 plan (`plan`, `n_plan` ints) other than
// this source's own; cudaErrorMisalignedAddress for a pointer read or
// written 16 bytes at a time that is not 16-byte aligned.
// Nothing is launched then. The caller checked shapes, types and
// contiguity.
extern "C" {

int dstt_probe_t1(const float* x, float* out, int n, void* stream) {
  return launch_steps<Times2>(x, out, 1, n, stream);  // the whole array as one step
}

int dstt_probe_t2(const float* x, float* out, int n, void* stream) {
  return launch_map<Times2>(x, nullptr, out, n, stream);
}

int dstt_probe_t9(const float* x, const float* mask, float* out, int n, void* stream) {
  return launch_map<Where>(x, mask, out, n, stream);
}

int dstt_probe_t4(const float* x, float* out, int steps, int per_step, void* stream) {
  return launch_steps<PlusOne>(x, out, steps, per_step, stream);
}

int dstt_probe_t3(const float* x, float* out, int n, void* stream) {
  return launch_steps<PlusOne>(x, out, 1, n, stream);  // the whole array as one step
}

int dstt_probe_t6(const float* x, float* out, int n, void* stream) {
  return launch_steps<Tanh>(x, out, 1, n, stream);  // the whole array as one step
}

int dstt_probe_t11(const float* x, float* out, int n, void* stream) {
  return launch_steps<Times2>(x, out, 1, n, stream);  // the whole array as one step
}

int dstt_probe_t5(const float* x, const float* w, float* out, int m, int n, int k,
                  const int* plan, int n_plan, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > kMaxDepth || n % 4 != 0 || k % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned(x) || misaligned(w) || misaligned(out)) return (int)cudaErrorMisalignedAddress;
  const ProductPlan p = product_plan(m, n);
  const int mine[] = {p.rows, p.cols, p.threads, p.grid, p.smem};
  if (!plan_matches(mine, 5, plan, n_plan)) return (int)cudaErrorInvalidValue;
  Args a{x, w, out, 0, m, n, k, cdiv(n, p.cols)};
  return (int)launch((const void*)tile_product_kernel, dim3(p.grid), p.threads, p.smem, a,
                     stream);
}

int dstt_probe_t12(const float* x, float* out, int n, void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(out)) return (int)cudaErrorMisalignedAddress;
  Args a{x, nullptr, out, n, 0, 0, 0, 0};
  return (int)launch((const void*)stage_kernel, dim3(cdiv(n, 4 * kChunkSlots)), kChunkThreads,
                     kStageSmem, a, stream);
}

int dstt_probe_t7(const bf16* x, const bf16* w, float* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > kMaxDepth || n % 8 != 0 || k % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (misaligned(x) || misaligned(w) || misaligned(out)) return (int)cudaErrorMisalignedAddress;
  Args a{nullptr, nullptr, out, 0, m, n, k, 0, x, w};
  const dim3 grid(cdiv(n, kMmaCols), cdiv(m, kMmaRows));
  return (int)launch((const void*)mma_tile_kernel, grid, kMmaThreads, kMmaSmem, a, stream);
}

int dstt_probe_t8(const float* x, float* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxSoftmaxCols) return (int)cudaErrorInvalidValue;
  Args a{x, nullptr, out, 0, rows, cols, 0, 0};
  return (int)launch((const void*)row_softmax_kernel, dim3(cdiv(rows, kRowWarps)), kRowThreads, 0,
                     a, stream);
}

int dstt_probe_t13(const float* q, const float* k, float* out, int m, int n, int depth,
                   void* stream) {
  return launch_dot_rows<kT13Lanes>(q, k, out, m, n, depth, stream);
}

int dstt_probe_t14(const float* q, const float* k, float* out, int m, int n, int depth,
                   void* stream) {
  return launch_dot_rows<kT14Lanes>(q, k, out, m, n, depth, stream);
}

int dstt_probe_t10(const float* x, float* out, int n_out, int seg, void* stream) {
  if (n_out <= 0 || seg <= 0 || seg % 2 != 0 || seg > kMaxSeg) return (int)cudaErrorInvalidValue;
  if (misaligned(x)) return (int)cudaErrorMisalignedAddress;  // out: 4-byte stores
  Args a{x, nullptr, out, 0, n_out, seg, 0, 0};
  return (int)launch((const void*)segment_stage_kernel, dim3(cdiv(n_out, kStageSums)),
                     kStageThreads, kSegStageSmem, a, stream);
}

}  // extern "C"
