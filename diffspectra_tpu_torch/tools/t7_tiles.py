"""Time the t7 probe kernel (bf16 ``x @ w`` on the tensor cores,
``csrc/probe_tiles.cu``'s ``mma_tile_kernel``) with each output tile it can
take, on the card.

The source gives a block a 64 x 32 output tile (8 x 14 = 112 blocks at the
probe's [841, 64] @ [64, 256]); each variant here is that source with the
tile set to one of ``TILES`` (32 x 64: 4 x 27 = 108 blocks), built alone with
nvcc into ``_build/t7_tiles/``. The ``probes.t7`` wrapper then runs each on
the probe's seeded inputs, variants in turn over four rounds (the order
reversed every other round), and for each it prints the device time a call
(profiler, 50 calls, warm L2; "not measured" where the profiler dropped
kernel events three windows running), the blocks and the largest error
against the plain version.

    python -m diffspectra_tpu_torch.tools.t7_tiles
"""

from __future__ import annotations

import torch

from ..ops import _lib, probes
from ..ops._row_tile import cdiv
from .diag_probes import probe_inputs
from .row_tiles import build_variant, device_ms

SOURCE_TILE = (64, 32)  # rows x columns of a block's outputs in csrc/probe_tiles.cu
TILES = {"64x32": SOURCE_TILE, "32x64": (32, 64)}


def tile_line(rows: int, cols: int) -> str:
    """The line of ``csrc/probe_tiles.cu`` that sets t7's tile to rows x cols."""
    return f"constexpr int kMmaRows = {rows}, kMmaCols = {cols};"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("t7_tiles: CUDA is not available; this tool runs on the GPU only")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    libs = {name: build_variant(f"t7_tiles/{name}", "probe_tiles.cu", tile_line(*SOURCE_TILE),
                                tile_line(*tile), ("probe_tiles.cu",), ("dstt_probe_t7",))
            for name, tile in TILES.items()}
    x, w = (t.to(dev) for t in probe_inputs("t7", seed=1))
    want = probes.t7_reference(x, w)
    (m, k), n = x.shape, w.shape[1]
    saved = _lib._lib
    try:
        for round_ in range(4):
            order = list(libs) if round_ % 2 == 0 else list(libs)[::-1]
            for name in order:
                _lib._lib = libs[name]
                err = (probes.t7(x, w) - want).abs().max().item()
                ms = device_ms(lambda: probes.t7(x, w))
                rows, cols = TILES[name]
                print(f"round {round_} {name}: {'not measured' if ms is None else f'{ms:.5f} ms'} "
                      f"on the device, {cdiv(m, rows) * cdiv(n, cols)} blocks, "
                      f"max |kernel - plain| {err:.2e}", flush=True)
                assert err <= probes.PROBES["t7"].atol, (name, err)
    finally:
        _lib._lib = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
