"""``csrc/block_fused.cu`` itself, run on the CPU.

This machine has no nvcc and no GPU, so the CUDA source is compiled with the
host C++ compiler against a small stand-in for the CUDA runtime: each thread
block runs as 256 ``std::thread``s, one block after the other (grid.x, then
grid.y; ``blockDim`` and ``gridDim`` as launched), with
``__syncthreads`` a barrier, warp shuffles an exchange through memory,
shared memory a NaN-filled array (bytes past the launch's dynamic size must
stay untouched), ``cp.async`` a copy made at the latest moment its
``wait_group`` allows, so that a missing wait reads stale data, and the
tensor-core instructions of ``csrc/mma.cuh`` (``ldmatrix`` x4, plain and
transposed, and the m16n8k16 bf16 ``mma``) warp collectives: each lane posts
its row address or its fragment registers, meets the other lanes at the warp
barrier, and takes its result by the PTX ISA's fragment layout, with
``__nv_bfloat16`` 16 raw bits. Its
``dstt_block_fused`` is then called through ``ctypes`` on CPU tensors with
the wrapper's launch plan and held against ``block_fused_reference`` with
the chip's tolerance (1e-4; measured about 1e-6), with q, k and v in float32
and in bfloat16.

This checks the kernel's tiling, indexing, barriers and copy pipeline, not
the card's arithmetic or speed; ``chip_smoke.py`` does that on the H100.
``build_host_lib`` builds any kernel source of ``csrc/`` that launches
through ``cudaLaunchKernel`` with one ``Args`` parameter the same way
(``tests/test_torch_ops_host.py``); ``last_launch`` reads the grid, block
and shared bytes of the last launch the stand-in accepted.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from diffspectra_tpu_torch.ops import _lib
from diffspectra_tpu_torch.ops.block_fused import _DATA, _WEIGHTS, block_fused_reference, launch_plan
from test_torch_block import block_case

CSRC = Path(__file__).resolve().parent.parent / "diffspectra_tpu_torch" / "csrc"

RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorMisalignedAddress = 716 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributePreferredSharedMemoryCarveout };
constexpr int cudaSharedmemCarveoutMaxShared = 100;
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t) {
  *n = 0;  // no card: the chip run asks the card
  return 0;
}
cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t);
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
float __shfl_xor_sync(unsigned, float, int);
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
using std::max;
using std::min;
namespace { alignas(16) float smem[65536]; }
"""

ASYNC_COPY_H = r"""
#pragma once
#include <cstring>
#include <vector>
namespace dstt {
struct Copy { void* dst; const void* src; int size, n; };
extern thread_local std::vector<std::vector<Copy>> committed;
extern thread_local std::vector<Copy> open_group;
inline void cp_async16(void* d, const void* s, int n) { open_group.push_back({d, s, 16, n}); }
inline void cp_async4(void* d, const void* s, int n) { open_group.push_back({d, s, 4, n}); }
inline void cp_async_commit() { committed.push_back(open_group); open_group.clear(); }
template <int Pending> inline void cp_async_wait() {
  while ((int)committed.size() > Pending) {
    for (const Copy& c : committed.front()) {
      std::memset(c.dst, 0, c.size);
      if (c.n) std::memcpy(c.dst, c.src, c.n);
    }
    committed.erase(committed.begin());
  }
}
}  // namespace dstt
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
struct __nv_bfloat16 { uint16_t bits; };
"""

MMA_H = r"""
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
namespace dstt {
namespace emu {
inline const void* rows[32][32];  // [warp][lane]: the row address a lane gives ldmatrix
inline uint32_t frags[32][32][6];  // [warp][lane]: a lane's a0 ... a3, b0, b1 for mma
inline float value(uint32_t reg, int high) {  // one bf16 of a register as a float
  const uint32_t u = (high ? reg >> 16 : reg & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void ldmatrix(uint32_t (&r)[4], const void* smem, bool trans) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  rows[w][l] = smem;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {  // matrix i: the rows lanes 8i ... 8i + 7 gave
    uint16_t e[2];
    for (int j = 0; j < 2; ++j) {
      const int row = trans ? 2 * (l % 4) + j : l / 4, col = trans ? l / 4 : 2 * (l % 4) + j;
      std::memcpy(&e[j], static_cast<const char*>(rows[w][8 * i + row]) + 2 * col, 2);
    }
    r[i] = e[0] | uint32_t(e[1]) << 16;
  }
  __syncwarp();
}
}  // namespace emu
inline void ldmatrix_x4(uint32_t (&r)[4], const void* smem) { emu::ldmatrix(r, smem, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) { emu::ldmatrix(r, smem, true); }
inline void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t* mine = emu::frags[w][l];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  __syncwarp();
  float A[16][16], B[16][8];  // the warp's operands, gathered from every lane's registers
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane / 4, t = lane % 4;
    const uint32_t* f = emu::frags[w][lane];
    for (int j = 0; j < 2; ++j) {
      A[g][2 * t + j] = emu::value(f[0], j);
      A[g + 8][2 * t + j] = emu::value(f[1], j);
      A[g][2 * t + 8 + j] = emu::value(f[2], j);
      A[g + 8][2 * t + 8 + j] = emu::value(f[3], j);
      B[2 * t + j][g] = emu::value(f[4], j);
      B[2 * t + 8 + j][g] = emu::value(f[5], j);
    }
  }
  __syncwarp();
  const int g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {  // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    for (int k = 0; k < 16; ++k) c[i] += A[row][k] * B[k][col];
  }
}
}  // namespace dstt
"""

HARNESS_CPP = r"""
#include "KERNEL_SOURCE"
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;
namespace dstt {
thread_local std::vector<std::vector<Copy>> committed;
thread_local std::vector<Copy> open_group;
}
namespace {
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, n = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); return; }
    if (!cv.wait_for(l, std::chrono::seconds(300), [&] { return gen != g; })) {
      std::fprintf(stderr, "barrier not reached by every thread\n");
      std::abort();
    }
  }
};
Barrier block_barrier, warp_barrier[32];
float warp_values[32][32];
unsigned last_launch[7];  // grid x, y, z, block x, y, z, shared bytes
int launches = 0;
}  // namespace
extern "C" int dstt_host_last_launch(unsigned* out) {
  std::memcpy(out, last_launch, sizeof(last_launch));
  return launches;
}
void __syncthreads() { block_barrier.wait(); }
void __syncwarp(unsigned) { warp_barrier[threadIdx.x / 32].wait(); }
float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_values[w][lane] = v;
  warp_barrier[w].wait();
  const float out = warp_values[w][lane ^ lane_mask];
  warp_barrier[w].wait();
  return out;
}
cudaError_t cudaLaunchKernel(const void* f, dim3 grid, dim3 block, void** args, size_t bytes,
                             cudaStream_t) {
  auto kernel = reinterpret_cast<void (*)(Args)>(const_cast<void*>(f));
  const Args a = *static_cast<Args*>(args[0]);
  if (bytes > sizeof(smem) || block.x > 1024 || block.x % 32) return cudaErrorInvalidValue;
  const unsigned shape[7] = {grid.x, grid.y, grid.z, block.x, block.y, block.z, (unsigned)bytes};
  std::memcpy(last_launch, shape, sizeof(shape));
  ++launches;
  block_barrier.n = block.x;
  for (auto& b : warp_barrier) b.n = 32;
  const uint32_t nan_bits = 0x7fc00001u;
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    const unsigned bx = b % grid.x, by = b / grid.x;
    for (size_t i = 0; i < sizeof(smem) / 4; ++i) std::memcpy(&smem[i], &nan_bits, 4);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {bx, by, 0};
        blockDim = {block.x, block.y, block.z};
        gridDim = {grid.x, grid.y, grid.z};
        dstt::committed.clear();
        dstt::open_group.clear();
        kernel(a);
      });
    }
    for (auto& t : threads) t.join();
    for (size_t i = bytes / 4; i < sizeof(smem) / 4; ++i) {
      uint32_t u;
      std::memcpy(&u, &smem[i], 4);
      if (u != nan_bits) return cudaErrorInvalidValue;  // wrote past its shared memory
    }
  }
  return cudaSuccess;
}
"""


def build_host_lib(directory: Path, source: str, argtypes: dict, text: str = None) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (or, given ``text``, that source under the
    name ``source``), with the headers of ``csrc/`` it includes, with the
    host C++ compiler against the stand-in into ``directory``, and load it
    with each C entry of ``argtypes`` typed. Skips the test where no host
    compiler exists."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip(f"no host C++ compiler to build csrc/{source} for the CPU")
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, directory / header.name)
    if text is None:
        shutil.copy(CSRC / source, directory / source)
    else:
        (directory / source).write_text(text)
    (directory / "async_copy.cuh").write_text(ASYNC_COPY_H)
    (directory / "mma.cuh").write_text(MMA_H)
    (directory / "include").mkdir()
    (directory / "include" / "cuda_runtime.h").write_text(RUNTIME_H)
    (directory / "include" / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (directory / "harness.cpp").write_text(HARNESS_CPP.replace("KERNEL_SOURCE", source))
    cmd = [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-I",
           str(directory / "include"), "-o", str(directory / "libhost.so"),
           str(directory / "harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(directory / "libhost.so"))
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def last_launch(lib: ctypes.CDLL) -> tuple:
    """The stand-in's launches so far, and the last one's grid (x, y, z),
    block (x, y, z) and dynamic shared bytes, as the C entry passed them to
    ``cudaLaunchKernel``."""
    shape = (ctypes.c_uint * 7)()
    count = lib.dstt_host_last_launch(shape)
    return count, tuple(shape[:3]), tuple(shape[3:6]), shape[6]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("block_fused_host"), "block_fused.cu",
                          {"dstt_block_fused": _lib._ARGTYPES["dstt_block_fused"]})


def _run(lib, arrays, kw, set_inf, plan_ints=None, bf16=False):
    """The kernel's call as the wrapper makes it, on CPU tensors (q, k and v
    in bfloat16 when ``bf16``); plan_ints maps the plan's ints to the ones
    passed."""
    args = [torch.from_numpy(a) for a in arrays]
    if bf16:
        for key in ("q", "k", "v"):
            i = _DATA.index(key)
            args[i] = args[i].to(torch.bfloat16)
    named = dict(zip(_DATA + _WEIGHTS, args))
    B, N, dh = named["h"].shape
    de = named["edge_in"].shape[-1]
    heads, n_extra, out_ch = kw["n_heads"], kw["n_extra"], kw["out_ch"]
    n_sub, hc = heads - n_extra, heads * out_ch
    ec = n_sub * (hc // n_sub)
    rn, re = named["fn1_k"].shape[-1], named["fe1_k"].shape[-1]
    plan = launch_plan(B, N, dh, de, ec, hc, heads, rn, re)
    nan = lambda *s: torch.full(s, float("nan"))
    outs = (nan(B, N, dh), nan(B, N, N, de), nan(B, N, 3))
    scratch = (nan(B, N, hc), nan(B, N, dh), nan(B, N, rn), nan(B, N, de), nan(B, N, dh),
               nan(B, N, dh))
    tensors = (*args, *outs, *scratch)
    bufs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 13)(B, N, dh, de, n_sub, ec // n_sub, heads, out_ch, n_extra, rn, re,
                               int(set_inf), int(bf16))
    ints = plan.ints() if plan_ints is None else plan_ints(plan.ints())
    ints = (ctypes.c_int * len(ints))(*ints)
    rc = lib.dstt_block_fused(bufs, len(bufs), dims, len(dims), ints, len(ints), 1e-6, None)
    return rc, outs, args


@pytest.mark.parametrize("n_nodes,N,dh,heads,n_extra,set_inf", [
    ([5, 8, 3], 8, 32, 4, 2, True),      # ragged, R = 2 rows a tile, 4 tiles a molecule
    ([3, 1], 3, 32, 4, 1, False),        # odd N: a 1-row last tile; E*sc = 30 (4-byte copies)
    ([7, 2, 12], 12, 64, 4, 3, True),    # A = 3, two node tiles
])
def test_cuda_source_on_the_host_matches_the_plain_version(host_lib, n_nodes, N, dh, heads,
                                                           n_extra, set_inf):
    arrays, kw = block_case(np.random.default_rng(4), n_nodes, N, dh, heads, n_extra)
    rc, got, args = _run(host_lib, arrays, kw, set_inf)
    assert rc == 0
    want = block_fused_reference(*args, set_inf=set_inf, **kw)
    for name, g, w in zip(("h_out", "edge_out", "agg"), got, want):  # padding included
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n_nodes,N,dh,heads,n_extra", [
    ([5, 8, 3], 8, 32, 4, 2),        # ragged, R = 2 rows a tile
    ([17, 9], 17, 64, 4, 1),         # odd N: a 1-row last tile
])
def test_bf16_qkv_source_on_the_host_matches_the_plain_version(host_lib, n_nodes, N, dh, heads,
                                                               n_extra):
    """attn_stage reads q, k and v as bfloat16 (as the JAX DMT in bfloat16
    passes them), against the plain version on the same bfloat16 q, k, v."""
    arrays, kw = block_case(np.random.default_rng(6), n_nodes, N, dh, heads, n_extra)
    rc, got, args = _run(host_lib, arrays, kw, True, bf16=True)
    assert rc == 0 and args[_DATA.index("q")].dtype == torch.bfloat16
    want = block_fused_reference(*args, set_inf=True, **kw)
    for name, g, w in zip(("h_out", "edge_out", "agg"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("where", [3, 12])  # stage A's blocks, stage B's shared memory
def test_cuda_source_on_the_host_refuses_a_wrong_plan(host_lib, where):
    arrays, kw = block_case(np.random.default_rng(5), [5, 8, 3], 8, 32, 4)
    bump = lambda ints: tuple(v + (i == where) for i, v in enumerate(ints))
    rc, outs, _ = _run(host_lib, arrays, kw, True, plan_ints=bump)
    assert rc != 0
    assert all(torch.isnan(o).all() for o in outs)  # nothing launched
