"""``csrc/probe_tiles.cu`` (the fourteen probe kernels t1 ... t14) itself,
run on the CPU, and t5's launch plan of ``ops/probes.py`` that its C entry
re-checks.

The source is compiled with the host C++ compiler against the stand-in for
the CUDA runtime of ``tests/test_torch_block_host.py`` (a block's threads
as ``std::thread``s, ``__syncthreads`` a barrier, NaN-filled shared memory
that must not be written past the launch's size, ``cp.async`` copies
landing only at their wait, ``ldmatrix`` and the bf16 ``mma`` as warp
collectives by the PTX ISA's fragment layout, warp shuffles through
memory). Its C entries ``dstt_probe_t1`` ... ``_t14`` are called through
``ctypes`` on CPU tensors as the wrapper calls them (t5 with its launch
plan) and held against the plain versions: t1, t2, t3, t4, t9, t11 and
t12 exactly, t6 and t8 within 1e-6 (the probes' tolerance:
the host's tanhf and expf and ``torch.tanh`` and ``torch.softmax`` may
differ by an ulp, and the softmax sums in another order), t10 and t14
within 1e-5 and t5, t7 and t13 within 1e-4 (the probes' tolerances; their
sums run in another order than the CPU's), at the probe shapes and at
ragged ones (t4: 1 or 8 steps whose
last chunk ends mid-block; t1, t3, t6, t11 and t12: 4, 508, 516, 1020, 1028
and 2052 floats, whose last block ends mid-tile, and t3 at 430,592; t5: M
in {1, 9, 841}, N in {4, 60, 252}, K in {4, 52, 64}; t7: M in {1, 9, 33,
841}, N in {8, 56, 256}, K in {8, 40, 64}; t8: rows in {1, 29, 33}, columns
in {1, 29, 32, 33, 128}; t13: M and N in {1, 29, 33}, depth in {4, 64,
252, 256}; t14: M and N in {1, 29, 33}, depth in {4, 64}; t10: 1, 2, 29
and 11,774 sums of 2, 18 or 32 floats; t2 and t9: 1, 2, 3, 5, 841, 1023,
1025 and 2049 floats, a float a thread, and with each pointer a float off
16 bytes; t9's mask also at 0, -0, NaN, a denormal of either sign and
±inf). The inputs of t2, t7, t8, t9, t10, t13 and t14 are followed by
NaN, so that a read past their end shows in the result. Since the stand-in's
shared memory starts as NaN, a mirrored read of a t12 slot that no thread
wrote, or a t7 operand read where no copy landed, fails the comparison. Each
output is followed by NaN floats that must stay untouched. A wrong plan, a
size that is not positive or not a multiple of 4 floats (t7: 8), a depth
over 64 (t13: 256, t14: 128), a t8 row over 128 columns, a t10 segment odd or
over 32 floats and a misaligned pointer are each refused with their error
code,
nothing launched and nothing written. t1, t3, t4, t6, t11 and t12 run in
place show their grids covering each float once, in one wave (a float
covered twice comes out 4x, x + 2, tanh(tanh(x)) or 2(2x + 1) + 1), and t2 likewise at each of its sizes. The
stand-in records the grid, block and shared bytes each C entry launches
with, and these are held to the design's: 1024 floats a block of 128
threads for t1, t3, t4, t6, t11 and t12 (64 blocks for t1 and t6 at their
probe's 65,536 floats; t12 with 4 KB of shared memory), t5's plan, t7's 64 x 32 tiles (and the
32 x 64 of ``tools/probe_variants.py``'s variant), a warp a row of t8 and an
output of t13 and half a warp an output of t14 in blocks of 128 threads
(8, 211 and 106 blocks at the probes' shapes, one wave), and 56 sums of
t10 a block of 128 threads staged through 7 KB of shared memory (211
blocks at the probe's shape), and t2's and t9's 4 blocks of 256 threads at
841 floats. ``tools/probe_variants.py``'s chunk kernel for t2 and t9 (a
block of 128 threads of 2 float4, the float4 slot that straddles the end a
ragged tail of scalars) is held to the plain versions at ragged sizes, and
its empty kernel to the launch shapes it names. The
emulated ``mma`` itself is held to true 16 x 16 x 16 products of basis
matrices, its fragments loaded by ``ldmatrix`` and, apart from it, by the
PTX ISA's layout written out element by element.

This checks the kernels' tiling, masks and copies, not the card's
arithmetic or speed; ``chip_smoke.py`` does that on the H100.
"""

import ctypes

import numpy as np
import pytest
import torch

from diffspectra_tpu_torch.ops import _lib
from diffspectra_tpu_torch.ops._row_tile import MAX_SMEM, SMS
from diffspectra_tpu_torch.ops._row_tile import cdiv
from diffspectra_tpu_torch.ops.probes import (PRODUCT_CHUNK, PRODUCT_CHUNKS, PROBES, product_plan,
                                              t1_reference, t2_reference, t3_reference,
                                              t4_reference, t5_reference, t6_reference,
                                              t7_reference, t8_reference, t9_reference,
                                              t10_reference, t11_reference, t12_reference,
                                              t13_reference, t14_reference)
from diffspectra_tpu_torch.tools.diag_probes import probe_inputs
from diffspectra_tpu_torch.tools.probe_variants import (FLOOR_LAUNCHES, SOURCE_TILE, TILES,
                                                        chunk_edits, floor_edits, tile_line)
from test_torch_block_host import CSRC, build_host_lib, last_launch

INVALID_VALUE, MISALIGNED = 1, 716  # cudaErrorInvalidValue, cudaErrorMisalignedAddress
GUARD = 64  # NaN floats after each output, which the kernel must not write
THREADS_PER_SM = 2048
# the flat probes' and t4's blocks: 128 threads, each 2 float4, so 1024
# floats a block; t12 stages them in 4 KB of shared memory
CHUNK_THREADS, CHUNK_FLOATS, STAGE_SMEM = 128, 1024, 4096
# t7's blocks: 128 threads a 64 x 32 output tile; x [64][64 + 8] and w
# [64][32 + 8] bf16 in shared memory
MMA_ROWS, MMA_COLS, MMA_THREADS = 64, 32, 128
MMA_SMEM = 2 * (MMA_ROWS * 72 + 64 * (MMA_COLS + 8))
# t8's, t13's and t14's blocks: 128 threads, a warp a row (t8) or an
# output (t13), half a warp an output (t14)
ROW_THREADS, ROW_WARPS = 128, 4
# t10's blocks: 56 sums of at most 32 floats a block of 128 threads, staged
# in 56 x 32 floats
STAGE_SUMS, STAGE_THREADS, SEG_STAGE_SMEM, MAX_SEG = 56, 128, 4 * 56 * 32, 32


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    argtypes = {f"dstt_probe_{n}": _lib._ARGTYPES[f"dstt_probe_{n}"]
                for n in ("t1", "t2", "t3", "t4", "t5", "t6", "t7", "t8", "t9", "t10", "t11", "t12",
                          "t13", "t14")}
    return build_host_lib(tmp_path_factory.mktemp("probe_tiles_host"), "probe_tiles.cu", argtypes)


def _plan_args(ints, bump=None):
    """The plan's ints and their count as the wrapper passes them, one of
    them off by one when ``bump`` names its index."""
    ints = [v + (i == bump) for i, v in enumerate(ints)]
    return (ctypes.c_int * len(ints))(*ints), len(ints)


def _t4(lib, x, shift=(0, 0)):
    """dstt_probe_t4 on x [steps, per_step] into a NaN buffer with a guard
    (and room for an output pointer ``shift`` floats on); returns the code,
    the output and the guard."""
    steps, per_step = x.shape
    buf = torch.full((steps * per_step + GUARD + 4,), float("nan"))
    ptrs = [t.data_ptr() + 4 * s for t, s in zip((x, buf), shift)]
    rc = lib.dstt_probe_t4(*ptrs, steps, per_step, None)
    return rc, buf[:steps * per_step].view(steps, per_step), buf[steps * per_step:]


def _flat(lib, name, x, shift=(0, 0)):
    """dstt_probe_<name> (t1, t3, t6, t11 or t12) on x's n floats, as _t4."""
    n = x.numel()
    buf = torch.full((n + GUARD + 4,), float("nan"))
    ptrs = [t.data_ptr() + 4 * s for t, s in zip((x, buf), shift)]
    rc = getattr(lib, f"dstt_probe_{name}")(*ptrs, n, None)
    return rc, buf[:n], buf[n:]


FLAT_REFERENCES = {"t1": t1_reference, "t3": t3_reference, "t6": t6_reference,
                   "t11": t11_reference, "t12": t12_reference}
FLAT_SMEM = {"t1": 0, "t3": 0, "t6": 0, "t11": 0, "t12": STAGE_SMEM}


def _one_wave(grid, block):
    """Every block of the launch resident at once on the card's SMs, as far
    as its threads go (at most THREADS_PER_SM an SM)."""
    assert block[0] % 32 == 0 and block[1:] == (1, 1)
    return grid[0] * grid[1] * grid[2] <= SMS * (THREADS_PER_SM // block[0])


def _t5(lib, x, w, bump=None, shift=(0, 0, 0)):
    """dstt_probe_t5 on x [m, k] and w [k, n], as _t4."""
    (m, k), n = x.shape, w.shape[1]
    buf = torch.full((m * n + GUARD + 4,), float("nan"))
    ptrs = [t.data_ptr() + 4 * s for t, s in zip((x, w, buf), shift)]
    # past the kernel's depth (K > 64) the plan of K = 64, for the C entry to refuse K
    ints = product_plan(m, n, min(k, PRODUCT_CHUNK * PRODUCT_CHUNKS)).ints()
    rc = lib.dstt_probe_t5(*ptrs, m, n, k, *_plan_args(ints, bump), None)
    return rc, buf[:m * n].view(m, n), buf[m * n:]


def _guarded(t):
    """t's elements, flat, followed by GUARD NaN, so that a read past its
    end makes the result NaN."""
    return torch.cat([t.flatten(), torch.full((GUARD,), float("nan"), dtype=t.dtype)])


def _t7(lib, x, w, shift=(0, 0, 0)):
    """dstt_probe_t7 on bf16 x [m, k] and w [k, n], each _guarded, as _t4
    (shifts in elements)."""
    (m, k), n = x.shape, w.shape[1]
    x, w = _guarded(x), _guarded(w)
    buf = torch.full((m * n + GUARD + 4,), float("nan"))
    ptrs = [t.data_ptr() + t.element_size() * s for t, s in zip((x, w, buf), shift)]
    rc = lib.dstt_probe_t7(*ptrs, m, n, k, None)
    return rc, buf[:m * n].view(m, n), buf[m * n:]


def _normal(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_t4_source_at_the_probe_shape_equals_the_plain_version(lib):
    (x,) = probe_inputs("t4", seed=3)
    rc, got, guard = _t4(lib, x.reshape(x.shape[0], -1))
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got.view(PROBES["t4"].out_shape), t4_reference(x), rtol=0, atol=0)


def test_t5_source_at_the_probe_shape_matches_the_plain_version(lib):
    x, w = probe_inputs("t5", seed=3)
    rc, got, guard = _t5(lib, x, w)
    assert rc == 0 and torch.isnan(guard).all()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t5_reference(x, w).numpy(), rtol=0,
                               atol=PROBES["t5"].atol)


@pytest.mark.parametrize("name", sorted(FLAT_REFERENCES))
def test_flat_source_at_the_probe_shape_equals_the_plain_version(lib, name):
    (x,) = probe_inputs(name, seed=3)
    rc, got, guard = _flat(lib, name, x)
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got.view(PROBES[name].out_shape), FLAT_REFERENCES[name](x),
                               rtol=0, atol=PROBES[name].atol)


# floats (a block of each kernel takes 1024): one float4; under half a
# block, and just over half (the block's second float4 of a thread in part
# or not at all); a block short by one float4 (its 255 of 256 float4, so a
# mirrored read of slot 255 - i, never written, reads NaN); a block and one
# float4; two blocks and one float4; t3 at its probe's size, whose last
# block is half full
FLAT_SIZES = [(name, n) for name in sorted(FLAT_REFERENCES)
              for n in (4, 508, 516, 1020, 1028, 2052)]


@pytest.mark.parametrize("name,n", FLAT_SIZES + [("t3", 8 * 29 * 29 * 64)])
def test_flat_source_on_ragged_sizes_equals_the_plain_version(lib, name, n):
    x = _normal(n, n)
    rc, got, guard = _flat(lib, name, x)
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got, FLAT_REFERENCES[name](x), rtol=0, atol=PROBES[name].atol)


# per-step floats: one float4, a chunk short by one float4, a chunk and one
# float4, three chunks and one float4 (a chunk: 128 threads x 2 float4)
@pytest.mark.parametrize("per_step", [4, 1020, 1028, 3076])
@pytest.mark.parametrize("steps", [1, 8])
def test_t4_source_on_ragged_steps_equals_the_plain_version(lib, steps, per_step):
    x = _normal(steps * per_step, steps, per_step)
    rc, got, guard = _t4(lib, x)
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got, t4_reference(x), rtol=0, atol=0)


# K: a partial first chunk (the second all zeros), a partial second chunk,
# both chunks whole
@pytest.mark.parametrize("k", [4, 52, 64])
@pytest.mark.parametrize("n", [4, 60, 252])
@pytest.mark.parametrize("m", [1, 9, 841])
def test_t5_source_on_ragged_shapes_matches_the_plain_version(lib, m, n, k):
    x, w = _normal(m + n + k, m, k), _normal(m * n * k, k, n)
    rc, got, guard = _t5(lib, x, w)
    assert rc == 0 and torch.isnan(guard).all()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t5_reference(x, w).numpy(), rtol=0,
                               atol=PROBES["t5"].atol)


T4_REFUSALS = {  # name: (steps, per_step, pointer shifts, code)
    "no_steps": (0, 1028, (0, 0), INVALID_VALUE),
    "empty_steps": (8, 0, (0, 0), INVALID_VALUE),
    "per_step_not_a_multiple_of_4": (8, 1030, (0, 0), INVALID_VALUE),
    "x_misaligned": (8, 1028, (1, 0), MISALIGNED),
    "out_misaligned": (8, 1028, (0, 1), MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(T4_REFUSALS))
def test_t4_source_refuses_with_nothing_written(lib, case):
    steps, per_step, shift, code = T4_REFUSALS[case]
    x = _normal(0, steps * per_step + 4)  # room for a shifted pointer
    launches = last_launch(lib)[0]
    rc, got, guard = _t4(lib, x[:steps * per_step].view(steps, per_step), shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


FLAT_REFUSALS = {  # name: (n, pointer shifts, code)
    "empty": (0, (0, 0), INVALID_VALUE),
    "n_not_a_multiple_of_4": (1030, (0, 0), INVALID_VALUE),
    "x_misaligned": (1028, (1, 0), MISALIGNED),
    "out_misaligned": (1028, (0, 1), MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(FLAT_REFUSALS))
@pytest.mark.parametrize("name", sorted(FLAT_REFERENCES))
def test_flat_source_refuses_with_nothing_written(lib, name, case):
    n, shift, code = FLAT_REFUSALS[case]
    x = _normal(0, n + 4)  # room for a shifted pointer
    launches = last_launch(lib)[0]
    rc, got, guard = _flat(lib, name, x[:n], shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


T5_REFUSALS = {  # name: (m, n, k, plan index bumped, pointer shifts, code)
    "plan_rows": (841, 252, 64, 0, (0, 0, 0), INVALID_VALUE),
    "plan_cols": (841, 252, 64, 1, (0, 0, 0), INVALID_VALUE),
    "plan_threads": (841, 252, 64, 2, (0, 0, 0), INVALID_VALUE),
    "plan_grid": (841, 252, 64, 3, (0, 0, 0), INVALID_VALUE),
    "plan_smem": (841, 252, 64, 4, (0, 0, 0), INVALID_VALUE),
    "no_rows": (0, 60, 64, None, (0, 0, 0), INVALID_VALUE),
    "n_not_a_multiple_of_4": (9, 6, 64, None, (0, 0, 0), INVALID_VALUE),
    "k_not_a_multiple_of_4": (9, 60, 6, None, (0, 0, 0), INVALID_VALUE),
    "k_over_64": (9, 60, 68, None, (0, 0, 0), INVALID_VALUE),
    "x_misaligned": (9, 60, 64, None, (1, 0, 0), MISALIGNED),
    "w_misaligned": (9, 60, 64, None, (0, 1, 0), MISALIGNED),
    "out_misaligned": (9, 60, 64, None, (0, 0, 1), MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(T5_REFUSALS))
def test_t5_source_refuses_with_nothing_written(lib, case):
    m, n, k, bump, shift, code = T5_REFUSALS[case]
    x, w = _normal(1, m * k + 4), _normal(2, k * n + 4)  # room for shifted pointers
    launches = last_launch(lib)[0]
    rc, got, guard = _t5(lib, x[:m * k].view(m, k), w[:k * n].view(k, n), bump, shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


@pytest.mark.parametrize("steps,per_step", [(8, 29 * 29 * 64), (1, 4), (8, 1020), (3, 3076),
                                            (16, 1024)])
def test_step_plan_covers_each_float_once_in_one_wave(lib, steps, per_step):
    # in place, one block after another: a float that two blocks cover comes
    # out x + 2, one that none covers x
    x = _normal(steps + per_step, steps, per_step)
    want = t4_reference(x)
    assert lib.dstt_probe_t4(x.data_ptr(), x.data_ptr(), steps, per_step, None) == 0
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    _, grid, block, smem = last_launch(lib)
    assert grid == (cdiv(per_step, CHUNK_FLOATS), steps, 1)
    assert block == (CHUNK_THREADS, 1, 1) and smem == 0
    assert _one_wave(grid, block)


@pytest.mark.parametrize("name,n", [("t1", 256 * 256), ("t3", 8 * 29 * 29 * 64),
                                    ("t6", 256 * 256), ("t11", 2 * 29 * 29 * 14 * 18),
                                    ("t12", 256 * 256)] + FLAT_SIZES)
def test_flat_grids_cover_each_float_once_in_one_wave(lib, name, n):
    # in place, one block after another: a float that two blocks cover comes
    # out 4x (t1, t11), x + 2 (t3), tanh(tanh(x)) (t6) or 2(2x + 1) + 1
    # (t12), one that none covers x
    x = _normal(n + 1, n)
    want = FLAT_REFERENCES[name](x)
    assert getattr(lib, f"dstt_probe_{name}")(x.data_ptr(), x.data_ptr(), n, None) == 0
    torch.testing.assert_close(x, want, rtol=0, atol=PROBES[name].atol)
    _, grid, block, smem = last_launch(lib)
    assert grid == (cdiv(n, CHUNK_FLOATS), 1, 1)
    assert block == (CHUNK_THREADS, 1, 1) and smem == FLAT_SMEM[name]
    assert _one_wave(grid, block)


def test_flat_grids_at_the_probe_shapes(lib):
    # as the C entries launch them: t3 421, t11 414, t1 and t6 64 blocks of
    # 128 threads; t12 64 blocks of 128 with 4 KB of shared memory, at most
    # one an SM
    for name, blocks, smem in (("t1", 64, 0), ("t3", 421, 0), ("t6", 64, 0), ("t11", 414, 0),
                               ("t12", 64, STAGE_SMEM)):
        (x,) = probe_inputs(name, seed=4)
        assert _flat(lib, name, x)[0] == 0
        assert last_launch(lib)[1:] == ((blocks, 1, 1), (CHUNK_THREADS, 1, 1), smem)
    assert 64 <= SMS


def test_t4_and_t5_launch_at_the_probe_shapes(lib):
    # t4: 53 chunks of each of 8 steps; t5: its plan, 108 tiles of 32 x 64
    (x,) = probe_inputs("t4", seed=4)
    assert _t4(lib, x.reshape(x.shape[0], -1))[0] == 0
    assert last_launch(lib)[1:] == ((53, 8, 1), (CHUNK_THREADS, 1, 1), 0)
    assert _one_wave(*last_launch(lib)[1:3])
    plan = product_plan(841, 252, 64)
    assert _t5(lib, *probe_inputs("t5", seed=4))[0] == 0
    assert last_launch(lib)[1:] == ((plan.grid, 1, 1), (plan.threads, 1, 1), plan.smem)


@pytest.mark.parametrize("m,n,k", [(841, 252, 64), (1, 4, 4), (9, 60, 64), (841, 4, 4),
                                   (100, 1000, 64), (4096, 4096, 64), (33, 36, 52)])
def test_product_plan_covers_each_output_once_and_fits(m, n, k):
    plan = product_plan(m, n, k)
    seen = np.zeros((m, n), np.int64)
    for r0, rows, c0, cols in plan.tiles():
        assert 0 < rows <= plan.rows and 0 < cols <= plan.cols
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert (seen == 1).all()
    depth = PRODUCT_CHUNK * PRODUCT_CHUNKS  # zeros past k
    assert plan.smem == 4 * depth * (plan.rows + plan.cols) + 16 * PRODUCT_CHUNKS * plan.rows
    assert plan.smem <= 48 * 1024 <= MAX_SMEM  # no opt-in to more shared memory needed
    assert plan.threads == plan.rows * plan.cols // 16 and plan.threads % 32 == 0


def test_product_plan_at_the_probe_shape_is_one_wave():
    plan = product_plan(841, 252, 64)
    assert (plan.rows, plan.cols, plan.threads, plan.grid) == (32, 64, 128, 108)
    assert plan.grid <= SMS and plan.smem == 25600


def test_product_plan_refuses_a_depth_over_64():
    with pytest.raises(ValueError, match="depth up to 64"):
        product_plan(841, 252, 68)


def test_t7_source_at_the_probe_shape_matches_the_plain_version(lib):
    x, w = probe_inputs("t7", seed=3)
    rc, got, guard = _t7(lib, x, w)
    assert rc == 0 and torch.isnan(guard).all()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t7_reference(x, w).numpy(), rtol=0,
                               atol=PROBES["t7"].atol)
    # 14 row tiles of 64 (the last of 9 rows) by 8 column tiles of 32, one wave
    assert last_launch(lib)[1:] == ((8, 14, 1), (MMA_THREADS, 1, 1), MMA_SMEM)
    assert _one_wave(*last_launch(lib)[1:3]) and 8 * 14 <= SMS
    assert MMA_SMEM <= 48 * 1024  # no opt-in to more shared memory needed


# M: one row, a partial tile, a half tile and one row, the probe's 841 (13
# tiles and 9 rows); N: one n8 tile, a whole column tile and a partial one of
# 3 n8 tiles, eight whole; K:
# one k8 of the first chunk, a partial second chunk, both whole
@pytest.mark.parametrize("k", [8, 40, 64])
@pytest.mark.parametrize("n", [8, 56, 256])
@pytest.mark.parametrize("m", [1, 9, 33, 841])
def test_t7_source_on_ragged_shapes_matches_the_plain_version(lib, m, n, k):
    x = _normal(m + n + k, m, k).to(torch.bfloat16)
    w = _normal(m * n * k, k, n).to(torch.bfloat16)
    rc, got, guard = _t7(lib, x, w)
    assert rc == 0 and torch.isnan(guard).all()
    assert torch.isfinite(got).all()  # no NaN shared memory read as an operand
    np.testing.assert_allclose(got.numpy(), t7_reference(x, w).numpy(), rtol=0,
                               atol=PROBES["t7"].atol)
    assert last_launch(lib)[1:] == ((cdiv(n, MMA_COLS), cdiv(m, MMA_ROWS), 1),
                                    (MMA_THREADS, 1, 1), MMA_SMEM)


T7_REFUSALS = {  # name: (m, n, k, pointer shifts in elements, code)
    "no_rows": (0, 56, 64, (0, 0, 0), INVALID_VALUE),
    "no_columns": (9, 0, 64, (0, 0, 0), INVALID_VALUE),
    "no_depth": (9, 56, 0, (0, 0, 0), INVALID_VALUE),
    "n_not_a_multiple_of_8": (9, 60, 64, (0, 0, 0), INVALID_VALUE),
    "k_not_a_multiple_of_8": (9, 56, 60, (0, 0, 0), INVALID_VALUE),
    "k_over_64": (9, 56, 72, (0, 0, 0), INVALID_VALUE),
    "x_misaligned": (9, 56, 64, (4, 0, 0), MISALIGNED),
    "w_misaligned": (9, 56, 64, (0, 4, 0), MISALIGNED),
    "out_misaligned": (9, 56, 64, (0, 0, 2), MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(T7_REFUSALS))
def test_t7_source_refuses_with_nothing_written(lib, case):
    m, n, k, shift, code = T7_REFUSALS[case]
    x = _normal(1, m * k + 8).to(torch.bfloat16)  # room for shifted pointers
    w = _normal(2, k * n + 8).to(torch.bfloat16)
    launches = last_launch(lib)[0]
    rc, got, guard = _t7(lib, x[:m * k].view(m, k), w[:k * n].view(k, n), shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


# One warp a block multiplies a[p] [16][16] by b[p] [16][16] (bf16,
# row-major, b as [k][n]) into c[p] [16][16] with two m16n8k16 mma, n8 tiles
# 0 and 1. The fragments come by ldmatrix from shared memory as
# probe_tiles.cu loads them, or, apart from it, from the PTX ISA's fragment
# layout written out element by element; C is stored by that layout.
MMA_PRODUCT_CU = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include "async_copy.cuh"  // the harness's copy queues
#include "mma.cuh"
namespace {
struct Args { const uint16_t* a; const uint16_t* b; float* c; int by_ldmatrix; };
uint32_t pair(const uint16_t* m, int r0, int c0, int r1, int c1) {
  return m[16 * r0 + c0] | uint32_t(m[16 * r1 + c1]) << 16;
}
__global__ void product_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.x, l = threadIdx.x, g = l / 4, t = l % 4;
  const uint16_t* a = args.a + 256 * p;
  const uint16_t* b = args.b + 256 * p;
  float* c = args.c + 256 * p;
  uint32_t af[4], bf[4];  // bf: b0, b1 of n8 tile 0, then of tile 1
  if (args.by_ldmatrix) {
    uint16_t* as = reinterpret_cast<uint16_t*>(smem);
    uint16_t* bs = as + 256;
    for (int i = l; i < 256; i += 32) as[i] = a[i], bs[i] = b[i];
    __syncthreads();
    dstt::ldmatrix_x4(af, as + 16 * (l % 16) + 8 * (l / 16));
    dstt::ldmatrix_x4_trans(bf, bs + 16 * (l % 16) + 8 * (l / 16));
  } else {
    af[0] = pair(a, g, 2 * t, g, 2 * t + 1);
    af[1] = pair(a, g + 8, 2 * t, g + 8, 2 * t + 1);
    af[2] = pair(a, g, 2 * t + 8, g, 2 * t + 9);
    af[3] = pair(a, g + 8, 2 * t + 8, g + 8, 2 * t + 9);
    for (int nt = 0; nt < 2; ++nt) {
      bf[2 * nt] = pair(b, 2 * t, 8 * nt + g, 2 * t + 1, 8 * nt + g);
      bf[2 * nt + 1] = pair(b, 2 * t + 8, 8 * nt + g, 2 * t + 9, 8 * nt + g);
    }
  }
  for (int nt = 0; nt < 2; ++nt) {
    float acc[4] = {};
    dstt::mma_bf16_16816(acc, af, bf[2 * nt], bf[2 * nt + 1]);
    const int col = 8 * nt + 2 * t;
    c[16 * g + col] = acc[0];
    c[16 * g + col + 1] = acc[1];
    c[16 * (g + 8) + col] = acc[2];
    c[16 * (g + 8) + col + 1] = acc[3];
  }
}
}  // namespace
extern "C" int mma_product(const void* a, const void* b, float* c, int pairs, int by_ldmatrix) {
  Args args{static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), c, by_ldmatrix};
  void* params[] = {&args};
  return cudaLaunchKernel((const void*)product_kernel, dim3(pairs), dim3(32), params, 1024, nullptr);
}
"""


@pytest.fixture(scope="module")
def mma_lib(tmp_path_factory):
    P, I = ctypes.c_void_p, ctypes.c_int
    return build_host_lib(tmp_path_factory.mktemp("mma_host"), "mma_product.cu",
                          {"mma_product": [P, P, P, I, I]}, text=MMA_PRODUCT_CU)


def _basis_pairs(which):
    """256 products a @ b: a each basis matrix E_ij with b the integers 1 ...
    256 (all exact in bf16, and every sum exact in f32), or b each E_kn with
    a those integers."""
    basis = np.eye(256, dtype=np.float32).reshape(256, 16, 16)
    ints = np.arange(1, 257, dtype=np.float32).reshape(1, 16, 16).repeat(256, 0)
    return (basis, ints) if which == "a_basis" else (ints, basis)


@pytest.mark.parametrize("which", ["a_basis", "b_basis"])
@pytest.mark.parametrize("by_ldmatrix", [0, 1])
def test_emulated_mma_gives_the_true_product_of_basis_matrices(mma_lib, which, by_ldmatrix):
    a, b = _basis_pairs(which)
    ta, tb = (torch.from_numpy(v).to(torch.bfloat16) for v in (a, b))
    assert torch.equal(ta.float(), torch.from_numpy(a)) and torch.equal(tb.float(), torch.from_numpy(b))
    c = torch.full((256, 16, 16), float("nan"))
    assert mma_lib.mma_product(ta.data_ptr(), tb.data_ptr(), c.data_ptr(), 256, by_ldmatrix) == 0
    np.testing.assert_array_equal(c.numpy(), a @ b)


@pytest.fixture(scope="module")
def wide_lib(tmp_path_factory):
    """probe_tiles.cu with t7's 32 x 64 tile, as ``tools/probe_variants.py``
    builds it for the card."""
    text = (CSRC / "probe_tiles.cu").read_text()
    assert tile_line(*SOURCE_TILE) in text and SOURCE_TILE == (MMA_ROWS, MMA_COLS)
    return build_host_lib(tmp_path_factory.mktemp("t7_wide_host"), "probe_tiles.cu",
                          {"dstt_probe_t7": _lib._ARGTYPES["dstt_probe_t7"]},
                          text=text.replace(tile_line(*SOURCE_TILE), tile_line(*TILES["32x64"])))


@pytest.mark.parametrize("m,n,k", [(841, 256, 64), (33, 56, 40)])
def test_t7_tool_variant_with_32_x_64_tiles_matches_the_plain_version(wide_lib, m, n, k):
    x = _normal(m + n + k, m, k).to(torch.bfloat16)
    w = _normal(m * n * k, k, n).to(torch.bfloat16)
    rc, got, guard = _t7(wide_lib, x, w)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t7_reference(x, w).numpy(), rtol=0,
                               atol=PROBES["t7"].atol)
    # 32 x 64 tiles, a 2 x 2 of warps: x [32][72] and w [64][64 + 8] bf16
    assert last_launch(wide_lib)[1:] == ((cdiv(n, 64), cdiv(m, 32), 1), (MMA_THREADS, 1, 1),
                                         2 * (32 * 72 + 64 * 72))


def _t8(lib, x):
    """dstt_probe_t8 on x [rows, cols], _guarded, as _t4."""
    rows, cols = x.shape
    x = _guarded(x)
    buf = torch.full((rows * cols + GUARD,), float("nan"))
    rc = lib.dstt_probe_t8(x.data_ptr(), buf.data_ptr(), rows, cols, None)
    return rc, buf[:rows * cols].view(rows, cols), buf[rows * cols:]


def _t13(lib, q, k, shift=(0, 0), name="t13"):
    """dstt_probe_t13 (or ``name``: t14) on q [m, depth] and k [n, depth],
    each _guarded (and shifted by ``shift`` floats), as _t4."""
    (m, depth), n = q.shape, k.shape[0]
    q, k = _guarded(q), _guarded(k)
    buf = torch.full((m * n + GUARD,), float("nan"))
    ptrs = [t.data_ptr() + 4 * s for t, s in zip((q, k), shift)]
    rc = getattr(lib, f"dstt_probe_{name}")(*ptrs, buf.data_ptr(), m, n, depth, None)
    return rc, buf[:m * n].view(m, n), buf[m * n:]


def _t14(lib, q, k, shift=(0, 0)):
    return _t13(lib, q, k, shift, name="t14")


ROW_PROBES = {"t8": (_t8, t8_reference), "t13": (_t13, t13_reference),
              "t14": (_t14, t14_reference)}


@pytest.mark.parametrize("name,blocks", [("t8", 8), ("t13", 211), ("t14", 106)])
def test_row_probe_source_at_the_probe_shape_matches_the_plain_version(lib, name, blocks):
    # t8: 29 rows, four a block; t13: 841 outputs, four a block; t14: 841
    # outputs, eight a block; one wave
    run, reference = ROW_PROBES[name]
    inputs = probe_inputs(name, seed=3)
    rc, got, guard = run(lib, *inputs)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), reference(*inputs).numpy(), rtol=0,
                               atol=PROBES[name].atol)
    assert last_launch(lib)[1:] == ((blocks, 1, 1), (ROW_THREADS, 1, 1), 0)
    assert _one_wave(*last_launch(lib)[1:3])


# rows: one warp, the probe's 29 (a block's last warp idle), 33 (a block
# and one row); columns: one lane, the probe's 29, a whole first slot of
# 32, one into the second slot, all four slots of a lane
@pytest.mark.parametrize("cols", [1, 29, 32, 33, 128])
@pytest.mark.parametrize("rows", [1, 29, 33])
def test_t8_source_on_ragged_shapes_matches_the_plain_version(lib, rows, cols):
    x = 4.0 * _normal(rows * cols, rows, cols)  # logits past exp's range of 1
    rc, got, guard = _t8(lib, x)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t8_reference(x).numpy(), rtol=0,
                               atol=PROBES["t8"].atol)
    assert last_launch(lib)[1:] == ((cdiv(rows, ROW_WARPS), 1, 1), (ROW_THREADS, 1, 1), 0)


# depth: one float4 (one lane), t14's 64, the probe's 252 (63 float4: the
# second round one lane short), 256 (both rounds whole)
@pytest.mark.parametrize("depth", [4, 64, 252, 256])
@pytest.mark.parametrize("n", [1, 29, 33])
@pytest.mark.parametrize("m", [1, 29, 33])
def test_t13_source_on_ragged_shapes_matches_the_plain_version(lib, m, n, depth):
    q, k = _normal(m + n + depth, m, depth), _normal(m * n * depth, n, depth)
    rc, got, guard = _t13(lib, q, k)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t13_reference(q, k).numpy(), rtol=0,
                               atol=PROBES["t13"].atol)
    assert last_launch(lib)[1:] == ((cdiv(m * n, ROW_WARPS), 1, 1), (ROW_THREADS, 1, 1), 0)


ROW_REFUSALS = {  # name: (probe, sizes, pointer shifts, code)
    "t8_no_rows": ("t8", (0, 29), (), INVALID_VALUE),
    "t8_no_columns": ("t8", (29, 0), (), INVALID_VALUE),
    "t8_columns_over_128": ("t8", (29, 129), (), INVALID_VALUE),
    "t13_no_rows": ("t13", (0, 29, 252), (0, 0), INVALID_VALUE),
    "t13_no_columns": ("t13", (29, 0, 252), (0, 0), INVALID_VALUE),
    "t13_no_depth": ("t13", (29, 29, 0), (0, 0), INVALID_VALUE),
    "t13_depth_not_a_multiple_of_4": ("t13", (29, 29, 250), (0, 0), INVALID_VALUE),
    "t13_depth_over_256": ("t13", (29, 29, 260), (0, 0), INVALID_VALUE),
    "t13_q_misaligned": ("t13", (29, 29, 252), (1, 0), MISALIGNED),
    "t13_k_misaligned": ("t13", (29, 29, 252), (0, 1), MISALIGNED),
    "t14_no_rows": ("t14", (0, 29, 64), (0, 0), INVALID_VALUE),
    "t14_no_columns": ("t14", (29, 0, 64), (0, 0), INVALID_VALUE),
    "t14_no_depth": ("t14", (29, 29, 0), (0, 0), INVALID_VALUE),
    "t14_depth_not_a_multiple_of_4": ("t14", (29, 29, 62), (0, 0), INVALID_VALUE),
    "t14_depth_over_128": ("t14", (29, 29, 132), (0, 0), INVALID_VALUE),
    "t14_q_misaligned": ("t14", (29, 29, 64), (1, 0), MISALIGNED),
    "t14_k_misaligned": ("t14", (29, 29, 64), (0, 1), MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(ROW_REFUSALS))
def test_row_probe_source_refuses_with_nothing_written(lib, case):
    name, sizes, shift, code = ROW_REFUSALS[case]
    launches = last_launch(lib)[0]
    if name == "t8":
        rc, got, guard = _t8(lib, _normal(1, *sizes))
    else:
        m, n, depth = sizes
        rc, got, guard = ROW_PROBES[name][0](lib, _normal(1, m, depth), _normal(2, n, depth), shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


# m, n: one output (a warp's second half past the outputs), the probe's
# 29 (841 outputs, odd), 33; depth: one float4 (one lane), the probe's 64
# (all 16 lanes)
@pytest.mark.parametrize("depth", [4, 64])
@pytest.mark.parametrize("n", [1, 29, 33])
@pytest.mark.parametrize("m", [1, 29, 33])
def test_t14_source_on_ragged_shapes_matches_the_plain_version(lib, m, n, depth):
    q, k = _normal(m + n + depth, m, depth), _normal(m * n * depth, n, depth)
    rc, got, guard = _t14(lib, q, k)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), t14_reference(q, k).numpy(), rtol=0,
                               atol=PROBES["t14"].atol)
    # two outputs a warp, eight a block
    assert last_launch(lib)[1:] == ((cdiv(m * n, 2 * ROW_WARPS), 1, 1), (ROW_THREADS, 1, 1), 0)


def _t10(lib, x, n_out, seg, shift=0):
    """dstt_probe_t10 on x's first n_out seg floats, _guarded (and shifted
    by ``shift`` floats), as _t4."""
    x = _guarded(x)
    buf = torch.full((n_out + GUARD,), float("nan"))
    rc = lib.dstt_probe_t10(x.data_ptr() + 4 * shift, buf.data_ptr(), n_out, seg, None)
    return rc, buf[:n_out], buf[n_out:]


def _segment_sums(x, n_out, seg):
    return x.flatten()[:n_out * seg].view(n_out, seg).sum(-1)


def test_t10_source_at_the_probe_shape_matches_the_plain_version(lib):
    # 11,774 sums of 18: 211 blocks of 56 (the last 14), one wave
    (x,) = probe_inputs("t10", seed=3)
    rc, got, guard = _t10(lib, x, 29 * 29 * 14, 18)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.view(PROBES["t10"].out_shape).numpy(),
                               t10_reference(x).numpy(), rtol=0, atol=PROBES["t10"].atol)
    assert last_launch(lib)[1:] == ((211, 1, 1), (STAGE_THREADS, 1, 1), SEG_STAGE_SMEM)
    assert _one_wave(*last_launch(lib)[1:3])


# sums: one, two, an odd 29, a block short by one (its thread 55 idle), a
# block and one, the probe's 29 x 29 x 14 (the last block 14 sums); floats
# a sum: 2, the probe's 18 (a block's run ends on a float2 where its sums
# are odd), the most, 32 (3.5 float4 a thread). Shared memory starts NaN:
# a term read where no load landed shows.
@pytest.mark.parametrize("seg", [2, 18, MAX_SEG])
@pytest.mark.parametrize("n_out", [1, 2, 29, STAGE_SUMS - 1, STAGE_SUMS + 1, 29 * 29 * 14])
def test_t10_source_on_ragged_shapes_matches_the_plain_version(lib, n_out, seg):
    x = _normal(n_out + seg, n_out * seg)
    rc, got, guard = _t10(lib, x, n_out, seg)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _segment_sums(x, n_out, seg).numpy(), rtol=0,
                               atol=PROBES["t10"].atol)
    assert last_launch(lib)[1:] == ((cdiv(n_out, STAGE_SUMS), 1, 1), (STAGE_THREADS, 1, 1),
                                    SEG_STAGE_SMEM)


T10_REFUSALS = {  # name: (sums, floats a sum, x's shift in floats, code)
    "no_sums": (0, 18, 0, INVALID_VALUE),
    "empty_sums": (29, 0, 0, INVALID_VALUE),
    "odd_segment": (29, 17, 0, INVALID_VALUE),
    "segment_over_32": (29, MAX_SEG + 2, 0, INVALID_VALUE),
    "x_misaligned": (29, 18, 1, MISALIGNED),
}


@pytest.mark.parametrize("case", sorted(T10_REFUSALS))
def test_t10_source_refuses_with_nothing_written(lib, case):
    n_out, seg, shift, code = T10_REFUSALS[case]
    launches = last_launch(lib)[0]
    rc, got, guard = _t10(lib, _normal(1, n_out * seg + 4), n_out, seg, shift)
    assert rc == code and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


def _map(lib, name, inputs, shift=None, n=None):
    """dstt_probe_<name> (t2: x; t9: x and its mask) on the inputs' floats
    (or ``n``), each _guarded, into a NaN buffer with a guard (and room for
    an output pointer a float on); ``shift`` gives each pointer's shift in
    floats, inputs then output. Returns the code, the output and the
    guard."""
    n = inputs[0].numel() if n is None else n
    ins = [_guarded(x) for x in inputs]
    size = max(n, 0)
    buf = torch.full((size + GUARD + 4,), float("nan"))
    shift = shift or (0,) * (len(ins) + 1)
    ptrs = [t.data_ptr() + 4 * s for t, s in zip(ins + [buf], shift)]
    rc = getattr(lib, f"dstt_probe_{name}")(*ptrs, n, None)
    return rc, buf[shift[-1]:shift[-1] + size], torch.cat([buf[:shift[-1]], buf[shift[-1] + size:]])


# t2 and t9: map_kernel, a float a thread in blocks of 256 threads, any size
MAP_REFERENCES = {"t2": t2_reference, "t9": t9_reference}
MAP_THREADS = 256
# floats: 1, 2, 3 and 5 (no whole float4, or one and a float); the probes'
# 841; 1023, 1025 and 2049 (a block short by one, four blocks and one
# float, eight and one)
MAP_SIZES = [(name, n) for name in sorted(MAP_REFERENCES)
             for n in (1, 2, 3, 5, 841, 1023, 1025, 2049)]


def _map_inputs(name, n, seed):
    return [_normal(seed + i, n) for i in range(len(PROBES[name].inputs))]


@pytest.mark.parametrize("name", sorted(MAP_REFERENCES))
def test_map_source_at_the_probe_shape_equals_the_plain_version(lib, name):
    # as the C entries launch them: 4 blocks of 256 threads for 841 floats
    inputs = probe_inputs(name, seed=3)
    rc, got, guard = _map(lib, name, inputs)
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got.view(PROBES[name].out_shape), MAP_REFERENCES[name](*inputs),
                               rtol=0, atol=0)
    assert last_launch(lib)[1:] == ((4, 1, 1), (MAP_THREADS, 1, 1), 0)
    assert _one_wave(*last_launch(lib)[1:3])


@pytest.mark.parametrize("name,n", MAP_SIZES)
def test_map_source_on_ragged_sizes_equals_the_plain_version(lib, name, n):
    inputs = _map_inputs(name, n, n)
    rc, got, guard = _map(lib, name, inputs)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got, MAP_REFERENCES[name](*inputs), rtol=0, atol=0)
    assert last_launch(lib)[1:] == ((cdiv(n, MAP_THREADS), 1, 1), (MAP_THREADS, 1, 1), 0)


# t9's mask values that a comparison may take another way: zeros of both
# signs and NaN give -1e10, a denormal above 0 keeps x (nothing flushes it),
# one below gives -1e10, and the infinities; each at the first float, one
# in the middle and the last
@pytest.mark.parametrize("value", [0.0, -0.0, float("nan"), 1e-40, -1e-40, float("inf"),
                                   float("-inf")])
def test_t9_source_takes_special_mask_values_as_where_does(lib, value):
    x, m = probe_inputs("t9", seed=5)
    at = [0, 420, 840]
    m.view(-1)[at] = value
    rc, got, guard = _map(lib, "t9", [x, m])
    assert rc == 0 and torch.isnan(guard).all()
    torch.testing.assert_close(got, t9_reference(x, m).view(-1), rtol=0, atol=0)
    kept = x.view(-1)[at] if value > 0 else torch.full((3,), -1e10)  # NaN > 0 is False
    assert torch.equal(got[at], kept)


@pytest.mark.parametrize("n", sorted({n for _, n in MAP_SIZES}))
def test_t2_grid_covers_each_float_once_in_one_wave(lib, n):
    # in place, one block after another: a float that two threads cover
    # comes out 4x, one that none covers x
    x = _guarded(_normal(n + 2, n))
    want = t2_reference(x[:n])
    assert lib.dstt_probe_t2(x.data_ptr(), x.data_ptr(), n, None) == 0
    torch.testing.assert_close(x[:n], want, rtol=0, atol=0)
    assert torch.isnan(x[n:]).all()
    _, grid, block, smem = last_launch(lib)
    assert grid == (cdiv(n, MAP_THREADS), 1, 1)
    assert block == (MAP_THREADS, 1, 1) and smem == 0
    assert _one_wave(grid, block)


# a float a thread: any 4-byte aligned pointer is taken
MAP_SHIFTS = {("t2", "x"): (1, 0), ("t2", "out"): (0, 1), ("t9", "x"): (1, 0, 0),
              ("t9", "mask"): (0, 1, 0), ("t9", "out"): (0, 0, 1)}


@pytest.mark.parametrize("name,pointer", sorted(MAP_SHIFTS))
def test_map_source_takes_pointers_a_float_off_16_bytes(lib, name, pointer):
    inputs = _map_inputs(name, 841, 7)
    rc, got, guard = _map(lib, name, inputs, MAP_SHIFTS[name, pointer])
    assert rc == 0 and torch.isnan(guard).all()
    shifted = [x[1:] if s else x for x, s in zip(inputs, MAP_SHIFTS[name, pointer])]
    shifted = [torch.cat([x, torch.full((1,), float("nan"))]) if len(x) < 841 else x
               for x in shifted]  # the read past a shifted input's end is its guard's NaN
    want = MAP_REFERENCES[name](*shifted)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n", [0, -1])
@pytest.mark.parametrize("name", sorted(MAP_REFERENCES))
def test_map_source_refuses_a_size_not_positive_with_nothing_written(lib, name, n):
    launches = last_launch(lib)[0]
    rc, got, guard = _map(lib, name, _map_inputs(name, 841, 1), n=n)
    assert rc == INVALID_VALUE and last_launch(lib)[0] == launches
    assert torch.isnan(got).all() and torch.isnan(guard).all()


@pytest.fixture(scope="module")
def tool_lib(tmp_path_factory):
    """probe_tiles.cu with t2's and t9's C entries on the chunk kernel of
    ``tools/probe_variants.py`` (a block of 128 threads of 2 float4, the
    last slot a ragged tail) and with its empty kernel of the launch floor,
    as that tool builds each for the card."""
    text = (CSRC / "probe_tiles.cu").read_text()
    for old, new in chunk_edits("t2", "t9") + floor_edits():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    argtypes = {f"dstt_probe_{n}": _lib._ARGTYPES[f"dstt_probe_{n}"] for n in MAP_REFERENCES}
    argtypes["dstt_launch_floor"] = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return build_host_lib(tmp_path_factory.mktemp("probe_tool_host"), "probe_tiles.cu", argtypes,
                          text=text)


# floats: tails of 1 and 3 floats with no whole float4, the probes' 841
# (210 float4 and a float), a block (1024 floats) and one, two and one
@pytest.mark.parametrize("n", [1, 3, 841, 1025, 2049])
@pytest.mark.parametrize("name", sorted(MAP_REFERENCES))
def test_tool_chunk_variant_with_a_ragged_tail_equals_the_plain_version(tool_lib, name, n):
    inputs = _map_inputs(name, n, n)
    rc, got, guard = _map(tool_lib, name, inputs)
    assert rc == 0 and torch.isnan(guard).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got, MAP_REFERENCES[name](*inputs), rtol=0, atol=0)
    assert last_launch(tool_lib)[1:] == ((cdiv(n, CHUNK_FLOATS), 1, 1), (CHUNK_THREADS, 1, 1), 0)


@pytest.mark.parametrize("launch", sorted(FLOOR_LAUNCHES))
def test_tool_floor_launches_the_empty_kernel_as_named(tool_lib, launch):
    blocks, threads = FLOOR_LAUNCHES[launch]
    assert tool_lib.dstt_launch_floor(blocks, threads, None) == 0
    assert last_launch(tool_lib)[1:] == ((blocks, 1, 1), (threads, 1, 1), 0)
