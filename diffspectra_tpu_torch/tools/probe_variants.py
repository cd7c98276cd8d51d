"""Time the probe kernels of ``csrc/probe_tiles.cu`` with each variant of
their layout, and the launch floor, on the card.

A variant is that source with a few lines replaced, built alone with nvcc
into ``_build/probe_variants/<probe>/<variant>/`` (``tools/row_tiles.py``'s
``build_variant``):

- t2 (``x * 2``) and t9 (``where(m > 0, x, -1e10)``), each on [29, 29]:
  the source's ``map_kernel<Times2>`` and ``<Where>`` (a float a thread,
  4 blocks of 256 threads) against the chunk kernel as one step, a design
  the source does not hold, written out here (``CHUNK_KERNEL``): 16-byte
  loads, all in flight before the first store, the float4 slot that
  straddles the end a ragged tail of scalars, in one block of 128 threads
  of 2 float4 each and in two blocks of 128 threads of 1 float4;
- t7 (bf16 ``x @ w`` on the tensor cores, ``mma_tile_kernel``): the
  source's 64 x 32 output tile (8 x 14 = 112 blocks at the probe's [841,
  64] @ [64, 256]) against 32 x 64 (4 x 27 = 108 blocks);
- t14 (``(q k).sum(-1)``, [29, 64] x 2, ``dot_rows_kernel``): the
  source's 16 lanes an output (two outputs a warp, each summed over a
  16-lane shuffle, 106 blocks of 128 threads at the probe's 841 outputs)
  against t13's 32 (211 blocks; at depth 64 lanes 16-31 load nothing);
- t10 (11,774 sums of 18 floats): the source's ``segment_stage_kernel``,
  56 sums a block of 128 threads staged through shared memory by coalesced
  loads (211 blocks), against a design the source does not hold, written
  out here (``PAIR_KERNEL``): two sums a thread straight from registers,
  in blocks of 64 threads (92 blocks), of 32 (184) and of 128 (46).

One probe a process: on the card the profiler dropped every kernel event
of a second probe timed in the same process.

The probe's wrapper then runs each variant on the probe's seeded inputs,
variants in turn over four rounds (the order reversed every other round),
and for each it prints the device time a call (profiler, 50 calls, warm L2;
"not measured" where the profiler dropped kernel events three windows
running), the blocks and the largest error against the plain version.

``floor`` times, the same way, an empty kernel (``EMPTY_KERNEL``, added to
the tool's copy of the source with its own C entry) launched as
``<<<1, 32>>>``, ``<<<1, 128>>>`` and ``<<<132, 128>>>``: the least device
time a launch takes on the card.

    python -m diffspectra_tpu_torch.tools.probe_variants {t2,t7,t9,t10,t14,floor}
"""

from __future__ import annotations

import argparse
import ctypes
import math

import torch

from ..ops import _lib, probes
from ..ops._row_tile import cdiv
from .diag_probes import probe_inputs
from .row_tiles import build_variant, device_ms

SOURCE_TILE = (64, 32)  # t7: rows x columns of a block's outputs in csrc/probe_tiles.cu
TILES = {"64x32": SOURCE_TILE, "32x64": (32, 64)}
SOURCE_LANES = 16  # t14: lanes an output in csrc/probe_tiles.cu
LANES = {"16_lanes": SOURCE_LANES, "32_lanes": 32}
ROW_THREADS = 128  # dot_rows_kernel's block
STAGE_SUMS = 56  # t10: segment_stage_kernel's sums a block
PAIR_THREADS = (64, 32, 128)  # t10: segment_pair_kernel's blocks
STAGE_LAUNCH = ("(const void*)segment_stage_kernel, dim3(cdiv(n_out, kStageSums)),\n"
                "                     kStageThreads, kSegStageSmem")
KERNELS_END = "bool misaligned(const void* p)"  # t10: the pair kernel goes before this line
# t10 in pairs: thread t sums outputs 2t and 2t + 1, the 2 seg floats from
# x + 2t seg (a 16-byte boundary, seg being even), all its float4 loads in
# flight before the first add; where the outputs are odd in number the last
# thread has one, seg floats
PAIR_KERNEL = """constexpr int kSegThreads = %d;
constexpr int kSegSlots = 2 * kMaxSeg / 4;
__global__ void __launch_bounds__(kSegThreads) segment_pair_kernel(Args a) {
  const int first = 2 * (blockIdx.x * kSegThreads + threadIdx.x);
  if (first >= a.m) return;
  const int seg = a.n, live = min(2, a.m - first) * seg;
  const float* x = a.x + (size_t)first * seg;
  float4 v[kSegSlots];
#pragma unroll
  for (int e = 0; e < kSegSlots; ++e) {
    v[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (4 * e + 4 <= live) {
      v[e] = reinterpret_cast<const float4*>(x)[e];
    } else if (4 * e + 2 == live) {
      const float2 h = reinterpret_cast<const float2*>(x)[2 * e];
      v[e].x = h.x, v[e].y = h.y;
    }
  }
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int e = 0; e < kSegSlots; ++e) {
    const float f[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
    for (int c = 4 * e; c < 4 * e + 4; ++c) {
      if (c < seg) {
        s0 += f[c - 4 * e];
      } else if (c < 2 * seg) {
        s1 += f[c - 4 * e];
      }
    }
  }
  a.out[first] = s0;
  if (first + 1 < a.m) a.out[first + 1] = s1;
}

"""


# t2, t9 as one step of the chunk kernel, the float4 slot that straddles
# the end a ragged tail of scalars (not in the source: map_kernel beat it)
CHUNK_KERNEL = """__device__ __forceinline__ float4 load_slot(const float* p, int i, int n4, int tail) {
  if (i < n4) return reinterpret_cast<const float4*>(p)[i];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i == n4) {
    if (tail > 0) v.x = p[4 * i];
    if (tail > 1) v.y = p[4 * i + 1];
    if (tail > 2) v.z = p[4 * i + 2];
  }
  return v;
}
__device__ __forceinline__ void store_slot(float* p, int i, int n4, int tail, float4 v) {
  if (i < n4) {
    reinterpret_cast<float4*>(p)[i] = v;
  } else if (i == n4) {
    if (tail > 0) p[4 * i] = v.x;
    if (tail > 1) p[4 * i + 1] = v.y;
    if (tail > 2) p[4 * i + 2] = v.z;
  }
}
template <class Op>
__global__ void __launch_bounds__(kChunkThreads) ragged_chunk_kernel(Args a) {
  const int n4 = a.per_step / 4, tail = a.per_step % 4;
  const int first = blockIdx.x * kChunkSlots + threadIdx.x;
  float4 v[kChunkVectors], m[kChunkVectors] = {};
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {  // every load in flight before the first store
    const int i = first + e * kChunkThreads;
    v[e] = load_slot(a.x, i, n4, tail);
    if constexpr (Op::kInputs == 2) m[e] = load_slot(a.w, i, n4, tail);
  }
  const Op op{};
#pragma unroll
  for (int e = 0; e < kChunkVectors; ++e) {
    float4 r;
    if constexpr (Op::kInputs == 1) {
      r = make_float4(op(v[e].x), op(v[e].y), op(v[e].z), op(v[e].w));
    } else {
      r = make_float4(op(v[e].x, m[e].x), op(v[e].y, m[e].y), op(v[e].z, m[e].z),
                      op(v[e].w, m[e].w));
    }
    store_slot(a.out, first + e * kChunkThreads, n4, tail, r);
  }
}

"""
# t2's and t9's C entries in the source, and as they launch CHUNK_KERNEL
MAP_ENTRIES = {"t2": "  return launch_map<Times2>(x, nullptr, out, n, stream);",
               "t9": "  return launch_map<Where>(x, mask, out, n, stream);"}
CHUNK_ENTRIES = {
    "t2": ("  if (n <= 0) return (int)cudaErrorInvalidValue;\n"
           "  if (misaligned(x) || misaligned(out)) return (int)cudaErrorMisalignedAddress;\n"
           "  Args a{x, nullptr, out, n, 0, 0, 0, 0};\n"
           "  return (int)launch((const void*)ragged_chunk_kernel<Times2>, "
           "dim3(cdiv(n, 4 * kChunkSlots)), kChunkThreads, 0, a, stream);"),
    "t9": ("  if (n <= 0) return (int)cudaErrorInvalidValue;\n"
           "  if (misaligned(x) || misaligned(mask) || misaligned(out)) "
           "return (int)cudaErrorMisalignedAddress;\n"
           "  Args a{x, mask, out, n, 0, 0, 0, 0};\n"
           "  return (int)launch((const void*)ragged_chunk_kernel<Where>, "
           "dim3(cdiv(n, 4 * kChunkSlots)), kChunkThreads, 0, a, stream);"),
}
MAP_THREADS = 256  # map_kernel's block in the source
# the chunk kernel's blocks, threads x float4 a thread (the source's own first)
CHUNKS = {"chunk_128x2": (128, 2), "chunk_128x1": (128, 1)}
# floor: an empty kernel and its C entry, after the source's last line
SOURCE_END = '}  // extern "C"\n'
EMPTY_KERNEL = """
namespace {
__global__ void empty_kernel(Args) {}
}  // namespace

extern "C" int dstt_launch_floor(int blocks, int threads, void* stream) {
  Args a{};
  return (int)launch((const void*)empty_kernel, dim3(blocks), threads, 0, a, stream);
}
"""
FLOOR_LAUNCHES = {"<<<1, 32>>>": (1, 32), "<<<1, 128>>>": (1, 128), "<<<132, 128>>>": (132, 128)}


def chunk_edits(*probes: str, threads: int = 128, vectors: int = 2) -> tuple:
    """The edits of ``csrc/probe_tiles.cu`` that add ``CHUNK_KERNEL`` in
    blocks of ``threads`` threads of ``vectors`` float4 and have the C
    entry of each of ``probes`` (t2, t9) launch it."""
    edits = [(KERNELS_END, CHUNK_KERNEL + KERNELS_END)]
    if (threads, vectors) != CHUNKS["chunk_128x2"]:
        edits.append((chunk_lines(*CHUNKS["chunk_128x2"]), chunk_lines(threads, vectors)))
    return (*edits, *((MAP_ENTRIES[probe], CHUNK_ENTRIES[probe]) for probe in probes))


def floor_edits() -> tuple:
    """The edit of ``csrc/probe_tiles.cu`` that adds ``EMPTY_KERNEL``."""
    return ((SOURCE_END, SOURCE_END + EMPTY_KERNEL),)


def chunk_lines(threads: int, vectors: int) -> str:
    """The lines of ``csrc/probe_tiles.cu`` that give the chunk kernel's
    blocks ``threads`` threads of ``vectors`` float4 each."""
    return f"constexpr int kChunkThreads = {threads};\nconstexpr int kChunkVectors = {vectors};"


def tile_line(rows: int, cols: int) -> str:
    """The line of ``csrc/probe_tiles.cu`` that sets t7's tile to rows x cols."""
    return f"constexpr int kMmaRows = {rows}, kMmaCols = {cols};"


def lanes_line(lanes: int) -> str:
    """The line of ``csrc/probe_tiles.cu`` that gives each t14 output
    ``lanes`` lanes."""
    return f"constexpr int kT14Lanes = {lanes};"


def pair_edits(threads: int) -> tuple:
    """The edits of ``csrc/probe_tiles.cu`` that add ``PAIR_KERNEL`` in
    blocks of ``threads`` and have t10 launch it."""
    return ((KERNELS_END, PAIR_KERNEL % threads + KERNELS_END),
            (STAGE_LAUNCH, "(const void*)segment_pair_kernel, dim3(cdiv(cdiv(n_out, 2), "
                           "kSegThreads)),\n                     kSegThreads, 0"))


def variants(probe: str) -> dict:
    """Each variant of ``probe``: its name, its edits of the source, and its
    blocks at the probe's shape (the source itself first)."""
    out = probes.PROBES[probe].out_shape
    if probe in MAP_ENTRIES:  # t2, t9
        n = math.prod(out)
        table = {"map": ((), cdiv(n, MAP_THREADS))}
        table.update({name: (chunk_edits(probe, threads=th, vectors=v), cdiv(n, 4 * th * v))
                      for name, (th, v) in CHUNKS.items()})
        return table
    if probe == "t7":
        m, n = out
        return {name: (((tile_line(*SOURCE_TILE), tile_line(r, c)),), cdiv(m, r) * cdiv(n, c))
                for name, (r, c) in TILES.items()}
    if probe == "t14":
        return {name: (((lanes_line(SOURCE_LANES), lanes_line(lanes)),),
                       cdiv(math.prod(out), ROW_THREADS // lanes)) for name, lanes in LANES.items()}
    sums = math.prod(out)  # t10
    table = {"staged": ((), cdiv(sums, STAGE_SUMS))}
    table.update({f"pairs_{t}": (pair_edits(t), cdiv(cdiv(sums, 2), t)) for t in PAIR_THREADS})
    return table


def time_variants(probe: str, dev: torch.device) -> None:
    """Build each variant of ``probe`` and print its device time a call, its
    blocks and its error, over four rounds."""
    table = variants(probe)
    libs = {name: build_variant(f"probe_variants/{probe}/{name}", "probe_tiles.cu", edits,
                                ("probe_tiles.cu",), (f"dstt_probe_{probe}",))
            for name, (edits, _) in table.items()}
    p = probes.PROBES[probe]
    args = [t.to(dev) for t in probe_inputs(probe, seed=1)]
    want = p.reference(*(a.cpu() for a in args)).to(dev)
    saved = _lib._lib
    try:
        for round_ in range(4):
            order = list(libs) if round_ % 2 == 0 else list(libs)[::-1]
            for name in order:
                _lib._lib = libs[name]
                err = (p.wrapper(*args) - want).abs().max().item()
                ms = device_ms(lambda: p.wrapper(*args))
                print(f"{probe} round {round_} {name}: "
                      f"{'not measured' if ms is None else f'{ms:.5f} ms'} on the device, "
                      f"{table[name][1]} blocks, max |kernel - plain| {err:.2e}", flush=True)
                assert err <= p.atol, (probe, name, err)
    finally:
        _lib._lib = saved


def time_floor(dev: torch.device) -> None:
    """Build ``EMPTY_KERNEL`` and print its device time a call at each of
    ``FLOOR_LAUNCHES``, over four rounds."""
    lib = build_variant("probe_variants/floor", "probe_tiles.cu", floor_edits(),
                        ("probe_tiles.cu",), ())
    lib.dstt_launch_floor.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dstt_launch_floor.restype = ctypes.c_int
    stream = _lib.stream_handle(dev)

    def launch(blocks, threads):
        _lib.check_rc("empty", lib.dstt_launch_floor(blocks, threads, stream))

    for round_ in range(4):
        order = list(FLOOR_LAUNCHES) if round_ % 2 == 0 else list(FLOOR_LAUNCHES)[::-1]
        for name in order:
            ms = device_ms(lambda: launch(*FLOOR_LAUNCHES[name]))
            print(f"floor round {round_} empty {name}: "
                  f"{'not measured' if ms is None else f'{ms:.5f} ms'} on the device", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probe", choices=("t2", "t7", "t9", "t10", "t14", "floor"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_variants: CUDA is not available; this tool runs on the GPU only")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    if args.probe == "floor":
        time_floor(dev)
    else:
        time_variants(args.probe, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
