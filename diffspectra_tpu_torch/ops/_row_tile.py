"""The launch plan of the row-tile kernels ``csrc/equi_update.cu`` and
``csrc/mix_attention.cu`` (``csrc/row_tile.cuh`` keeps the same numbers, and
each kernel's C entry re-checks the plan): one block per tile of R rows i of
one molecule, its R N pairs (i, j) the rows of a tile of 64 pair rows (256
threads) or 32 (128 threads).
"""

from __future__ import annotations

from dataclasses import dataclass

TILE_ROWS = (64, 32)  # pairs a tile; threads are 4 a row
COLS = 256  # output columns of one pass of the tile product
RING = 3 * 8 * COLS  # a weight's ring: 3 chunks of 8 rows, floats
SMS = 132  # H100 SXM
MAX_SMEM = 232448  # shared memory a block may use, bytes
SMEM_PER_SM = 233472  # the SM's, bytes; 1024 of it reserved a block
# blocks an SM that __launch_bounds__ asks for: at most 128 registers a
# thread for 64-row tiles, 170 for 32-row tiles
MIN_BLOCKS = {64: 2, 32: 3}
# what a tile costs the plan, in rows of a 64-row tile: a 32-row tile
# streams the weights for half the rows (measured 1.1-1.4x the time a row
# at B=80, where both heights fill every SM many times over)
ROW_COST = {64: 64, 32: 40}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ld(width: int) -> int:
    """Row stride of a shared-memory tile: 16-byte rows plus 4 floats."""
    return (width + 3) // 4 * 4 + 4


def ld16(width: int) -> int:
    """Row stride of a bfloat16 tile, in bfloat16s: 16-byte rows plus 8, so
    that the 8 rows an ldmatrix reads fall in 8 other groups of banks."""
    return (width + 7) // 8 * 8 + 8


MMA_LD = ld16(COLS)  # a bfloat16 weight tile's row: COLS columns, zeros past M


@dataclass(frozen=True)
class RowTilePlan:
    """One launch: ``grid`` blocks of ``threads``, each a tile of
    ``rows_per_tile`` rows of a molecule (``tiles`` a molecule) in
    ``tile_rows`` pair rows, ``smem`` bytes of dynamic shared memory a
    block, ``blocks_per_sm`` blocks an SM (shared memory and the register
    cap)."""

    batch: int
    n: int
    tile_rows: int
    rows_per_tile: int
    tiles: int
    grid: int
    threads: int
    smem: int
    blocks_per_sm: int

    def ints(self) -> tuple:
        """The plan as the C entry takes it."""
        return (self.tile_rows, self.rows_per_tile, self.tiles, self.grid, self.threads,
                self.smem, self.blocks_per_sm)

    def row_tiles(self) -> list:
        """(molecule, first row, rows) of each block, by block index."""
        out = []
        for x in range(self.grid):
            b, t = divmod(x, self.tiles)
            i0 = t * self.rows_per_tile
            out.append((b, i0, min(self.rows_per_tile, self.n - i0)))
        return out


def row_tile_plan(batch: int, n: int, smem_floats) -> RowTilePlan:
    """Of the tiles of 64 and of 32 pair rows, the one whose busiest SM
    does the less work (ceil(blocks / 132) x ROW_COST; 64 on a tie). Rows of a molecule a tile: R = tile rows // N, or 2 when that
    leaves SMs idle. ``smem_floats(tile_rows, r)`` gives a block's shared
    memory in floats."""
    best, best_cost = None, 0
    for tr in TILE_ROWS:
        r = min(n, max(1, tr // n))
        if batch * cdiv(n, r) < SMS and r > 2:
            r = 2
        tiles = cdiv(n, r)
        smem = 4 * smem_floats(tr, r)
        plan = RowTilePlan(batch=batch, n=n, tile_rows=tr, rows_per_tile=r, tiles=tiles,
                           grid=batch * tiles, threads=4 * tr, smem=smem,
                           blocks_per_sm=min(MIN_BLOCKS[tr], SMEM_PER_SM // (smem + 1024)))
        cost = cdiv(plan.grid, SMS) * ROW_COST[tr]
        if smem <= MAX_SMEM and plan.blocks_per_sm >= 1 and (best is None or cost < best_cost):
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"no tile of {TILE_ROWS} rows fits {MAX_SMEM} bytes of shared memory")
    return best
