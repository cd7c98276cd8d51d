"""``csrc/probe_tiles.cu`` (the probe kernels t4 and t5) itself, run on the
CPU, and t5's launch plan of ``ops/probes.py`` that its C entry re-checks.

The source is compiled with the host C++ compiler against the stand-in for
the CUDA runtime of ``tests/test_torch_block_host.py`` (a block's threads
as ``std::thread``s, ``__syncthreads`` a barrier, NaN-filled shared memory
that must not be written past the launch's size, ``cp.async`` copies
landing only at their wait). Its ``dstt_probe_t4`` and ``dstt_probe_t5``
are called through ``ctypes`` on CPU tensors as the wrapper calls them (t5
with its launch plan) and held against the plain versions: t4 exactly, t5 within 1e-4 (the
probe's tolerance; its sums run along K in another order than the CPU's),
at the probe shapes and at ragged ones (t4: 1 or 8 steps whose last chunk
ends mid-block; t5: M in {1, 9, 841}, N in {4, 60, 252}, K in {4, 52, 64}).
Each output is followed by NaN floats that must stay untouched. A wrong
plan, a size that is not positive or not a multiple of 4 floats and a
misaligned pointer are each refused with their error code and nothing
written. t4 run in place shows its grid covering each float once.

This checks the kernels' tiling, masks and copies, not the card's
arithmetic or speed; ``chip_smoke.py`` does that on the H100.
"""

import ctypes

import numpy as np
import pytest
import torch

from diffspectra_tpu_torch.ops import _lib
from diffspectra_tpu_torch.ops._row_tile import MAX_SMEM, SMS
from diffspectra_tpu_torch.ops.probes import (PRODUCT_CHUNK, PRODUCT_CHUNKS, PROBES, STEP_THREADS,
                                              product_plan, step_grid, t4_reference, t5_reference)
from diffspectra_tpu_torch.tools.diag_probes import probe_inputs
from test_torch_block_host import build_host_lib

INVALID_VALUE, MISALIGNED = 1, 716  # cudaErrorInvalidValue, cudaErrorMisalignedAddress
GUARD = 64  # NaN floats after each output, which the kernel must not write
THREADS_PER_SM = 2048


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    argtypes = {f"dstt_probe_{n}": _lib._ARGTYPES[f"dstt_probe_{n}"] for n in ("t4", "t5")}
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
    rc, got, guard = _t4(lib, x[:steps * per_step].view(steps, per_step), shift)
    assert rc == code
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
    rc, got, guard = _t5(lib, x[:m * k].view(m, k), w[:k * n].view(k, n), bump, shift)
    assert rc == code
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
    assert STEP_THREADS % 32 == 0
    assert step_grid(steps, per_step) <= SMS * (THREADS_PER_SM // STEP_THREADS)


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
