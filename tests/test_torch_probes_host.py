"""``csrc/probe_tiles.cu`` (the probe kernels t3, t4, t5 and t12) itself, run
on the CPU, and t5's launch plan of ``ops/probes.py`` that its C entry
re-checks.

The source is compiled with the host C++ compiler against the stand-in for
the CUDA runtime of ``tests/test_torch_block_host.py`` (a block's threads
as ``std::thread``s, ``__syncthreads`` a barrier, NaN-filled shared memory
that must not be written past the launch's size, ``cp.async`` copies
landing only at their wait). Its C entries ``dstt_probe_t3``, ``_t4``,
``_t5`` and ``_t12`` are called through ``ctypes`` on CPU tensors as the
wrapper calls them (t5 with its launch plan) and held against the plain
versions: t3, t4 and t12 exactly, t5 within 1e-4 (the probe's tolerance;
its sums run along K in another order than the CPU's), at the probe shapes
and at ragged ones (t4: 1 or 8 steps whose last chunk ends mid-block; t3
and t12: 4, 508, 516, 1020, 1028 and 2052 floats, whose last block ends
mid-tile, and t3 at 430,592; t5: M in {1, 9, 841}, N in {4, 60, 252}, K in {4, 52, 64}).
Since the stand-in's shared memory starts as NaN, a mirrored read of a t12
slot that no thread wrote fails the exact comparison. Each output is
followed by NaN floats that must stay untouched. A wrong plan, a size that
is not positive or not a multiple of 4 floats and a misaligned pointer are
each refused with their error code, nothing launched and nothing written.
t3, t4 and t12 run in place show their grids covering each float once, in
one wave. The stand-in records the grid, block and shared bytes each C
entry launches with, and these are held to the design's: 1024 floats a
block of 128 threads for t3, t4 and t12 (t12 with 4 KB of shared memory),
t5's plan.

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
                                              t3_reference, t4_reference, t5_reference,
                                              t12_reference)
from diffspectra_tpu_torch.tools.diag_probes import probe_inputs
from test_torch_block_host import build_host_lib, last_launch

INVALID_VALUE, MISALIGNED = 1, 716  # cudaErrorInvalidValue, cudaErrorMisalignedAddress
GUARD = 64  # NaN floats after each output, which the kernel must not write
THREADS_PER_SM = 2048
# t3's, t4's and t12's blocks: 128 threads, each 2 float4, so 1024 floats a
# block; t12 stages them in 4 KB of shared memory
CHUNK_THREADS, CHUNK_FLOATS, STAGE_SMEM = 128, 1024, 4096


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    argtypes = {f"dstt_probe_{n}": _lib._ARGTYPES[f"dstt_probe_{n}"]
                for n in ("t3", "t4", "t5", "t12")}
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
    """dstt_probe_<name> (t3 or t12) on x's n floats, as _t4."""
    n = x.numel()
    buf = torch.full((n + GUARD + 4,), float("nan"))
    ptrs = [t.data_ptr() + 4 * s for t, s in zip((x, buf), shift)]
    rc = getattr(lib, f"dstt_probe_{name}")(*ptrs, n, None)
    return rc, buf[:n], buf[n:]


FLAT_REFERENCES = {"t3": t3_reference, "t12": t12_reference}
FLAT_SMEM = {"t3": 0, "t12": STAGE_SMEM}


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
                               rtol=0, atol=0)


# floats (a block of either kernel takes 1024): one float4; under half a
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
    torch.testing.assert_close(got, FLAT_REFERENCES[name](x), rtol=0, atol=0)


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


@pytest.mark.parametrize("name,n", [("t3", 8 * 29 * 29 * 64), ("t12", 256 * 256)] + FLAT_SIZES)
def test_flat_grids_cover_each_float_once_in_one_wave(lib, name, n):
    # in place, one block after another: a float that two blocks cover comes
    # out x + 2 (t3) or 2(2x + 1) + 1 (t12), one that none covers x
    x = _normal(n + 1, n)
    want = FLAT_REFERENCES[name](x)
    assert getattr(lib, f"dstt_probe_{name}")(x.data_ptr(), x.data_ptr(), n, None) == 0
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    _, grid, block, smem = last_launch(lib)
    assert grid == (cdiv(n, CHUNK_FLOATS), 1, 1)
    assert block == (CHUNK_THREADS, 1, 1) and smem == FLAT_SMEM[name]
    assert _one_wave(grid, block)


def test_flat_grids_at_the_probe_shapes(lib):
    # as the C entries launch them: t3 421 blocks of 128 threads; t12 64
    # blocks of 128 with 4 KB of shared memory, at most one an SM
    for name, blocks, smem in (("t3", 421, 0), ("t12", 64, STAGE_SMEM)):
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
