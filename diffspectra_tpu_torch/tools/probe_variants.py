"""Time the probe kernels of ``csrc/probe_tiles.cu`` with each variant of
their layout, on the card.

A variant is that source with a few lines replaced, built alone with nvcc
into ``_build/probe_variants/<probe>/<variant>/`` (``tools/row_tiles.py``'s
``build_variant``):

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

    python -m diffspectra_tpu_torch.tools.probe_variants {t7,t10,t14}
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probe", choices=("t7", "t10", "t14"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_variants: CUDA is not available; this tool runs on the GPU only")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    time_variants(args.probe, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
