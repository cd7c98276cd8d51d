"""``csrc/equi_update.cu`` and ``csrc/mix_attention.cu`` themselves, run on
the CPU.

Each source is compiled with the host C++ compiler against the stand-in for
the CUDA runtime of ``tests/test_torch_block_host.py`` (a block's threads
as ``std::thread``s, ``__syncthreads`` a barrier, shuffles through memory,
NaN-filled shared memory that must not be written past the launch's size,
``cp.async`` copies landing only at their wait). Its ``dstt_equi_update``
and ``dstt_mix_attention`` are called through ``ctypes`` on CPU tensors
with the wrapper's launch plan and held against the plain versions at the
chip's tolerance (1e-5, every output, padding included) on ragged batches:
N in {8, 17, 29}, B in {1, 3} (tiles of 32 rows: one row of a molecule, or
two at N = 8) and 10 (tiles of 64 rows: two rows, the last tile of an odd N
partial), ``set_inf`` both ways, A in {1, 2}, flagship and narrow widths, and widths
whose rows take 4-byte copies. A wrong plan is refused with nothing
launched. The ``bf16_`` cases give each kernel its bfloat16 operands (as the
JAX DMT in bfloat16 passes them): the tensor-core tiles of the gate
products (``ldmatrix`` and the m16n8k16 ``mma`` emulated as warp
collectives by the stand-in) at N in {8, 17, 29}, ragged, in tiles of 32
and 64 rows, with mix_attention's 252-wide W0 tile zero-padded to 256
columns in shared memory, held to the plain version on the same bfloat16
operands; a plan reckoned for float32 slabs is refused with nothing
launched. The ``dd1`` cases give equi_update a 1-wide dist (the DMT's
``dist_gbf=False``), in float32 and in bfloat16 (where the kernel folds
``dist @ Wd`` into its epilogue), at N in {8, 17, 29} in tiles of 32 and
64 rows; the ``zero_mod`` cases a zero shift and scale (``cond_time=False``);
a plan reckoned for a 16-wide dist is refused with nothing launched.

This checks the kernels' tiling, indexing, barriers and copy pipeline, not
the card's arithmetic or speed; ``chip_smoke.py`` does that on the H100.
"""

import ctypes

import numpy as np
import pytest
import torch

from diffspectra_tpu_torch.ops import _lib
from diffspectra_tpu_torch.ops.equi_update import equi_update_reference
from diffspectra_tpu_torch.ops.equi_update import launch_plan as equi_plan
from diffspectra_tpu_torch.ops.mix_attention import launch_plan as attn_plan
from diffspectra_tpu_torch.ops.mix_attention import mix_attention_reference
from test_torch_block_host import build_host_lib
from test_torch_ops import _attn_inputs, _equi_inputs

ATOL = 1e-5
BF16 = torch.bfloat16
# the operands the JAX DMT in bfloat16 passes as bfloat16, by argument index
BF16_ARGS = {"equi_update": (0, 1, 2, 3, 7, 8, 9), "mix_attention": (0, 1, 2, 3, 4, 5)}


def _tensors(kernel, arrays, bf16):
    """The inputs as CPU tensors, those of BF16_ARGS in bfloat16 when asked."""
    args = [torch.from_numpy(a) for a in arrays]
    if bf16:
        for i in BF16_ARGS[kernel]:
            args[i] = args[i].to(BF16)
    return args


@pytest.fixture(scope="module")
def equi_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("equi_update_host"), "equi_update.cu",
                          {"dstt_equi_update": _lib._ARGTYPES["dstt_equi_update"]})


@pytest.fixture(scope="module")
def attn_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("mix_attention_host"), "mix_attention.cu",
                          {"dstt_mix_attention": _lib._ARGTYPES["dstt_mix_attention"]})


def _ints(plan, bump=None):
    """The plan's ints as the wrapper passes them, one of them off by one
    when ``bump`` names its index."""
    ints = [v + (i == bump) for i, v in enumerate(plan.ints())]
    return (ctypes.c_int * len(ints))(*ints)


def _equi_call(lib, args, bump=None, plan_bf16=None):
    """The wrapper's call on CPU tensors; ``plan_bf16`` overrides the
    operand dtype the plan is reckoned for."""
    B, N, dh = args[0].shape
    de, dd, n_adj = args[2].shape[-1], args[3].shape[-1], args[5].shape[-1]
    bf16 = args[2].dtype == BF16
    out = torch.full((B, N, 3), float("nan"))
    ints = _ints(equi_plan(B, N, de, dd, dh, bf16 if plan_bf16 is None else plan_bf16), bump)
    rc = lib.dstt_equi_update(*(a.data_ptr() for a in args), out.data_ptr(), B, N, de, dd, dh,
                              n_adj, int(bf16), 1e-6, ints, len(ints), None)
    return rc, out


def _attn_call(lib, args, set_inf, bump=None, plan_bf16=None):
    q, v, edge, extra = args[0], args[2], args[3], args[6]
    B, N, n_sub, sub_c = q.shape
    heads, out_ch = v.shape[2], v.shape[3]
    de, n_extra = edge.shape[-1], extra.shape[-1]
    bf16 = edge.dtype == BF16
    out = torch.full((B, N, heads * out_ch), float("nan"))
    plan = attn_plan(B, N, de, n_sub * sub_c, heads * out_ch, heads,
                     bf16 if plan_bf16 is None else plan_bf16)
    ints = _ints(plan, bump)
    rc = lib.dstt_mix_attention(*(a.data_ptr() for a in args), out.data_ptr(), B, N, de, n_sub,
                                sub_c, heads, out_ch, n_extra, int(set_inf), int(bf16), ints,
                                len(ints), None)
    return rc, out


EQUI_CASES = {  # B, N, De, Dd, Dh, A; tiles of 32 rows unless named
    "flagship_N29": (3, 29, 64, 64, 256, 2),
    "tile64_N17": (10, 17, 16, 16, 64, 2),  # 64-row tiles of two rows, the last partial
    "N17_ragged_K": (1, 17, 16, 12, 64, 2),  # K = 28: a short last weight chunk
    "N8_narrow": (1, 8, 8, 8, 32, 1),
    "N29_4byte_copies": (1, 29, 6, 10, 40, 1),  # edge and dist rows not 16-byte aligned
    # bfloat16 operands: the [edge | dist] product on the tensor cores
    "bf16_flagship_N29": (2, 29, 64, 64, 256, 2),
    "bf16_tile64_N17": (10, 17, 16, 32, 64, 2),  # 64-row tiles of two rows, the last partial
    "bf16_N8_narrow": (3, 8, 16, 16, 40, 1),  # Dh = 40: the last n8 tile half past Dh
    # a 1-wide dist (dist_gbf=False): K = De + 1 in float32; in bfloat16
    # dist @ Wd folded into the epilogue
    "dd1_N29": (3, 29, 64, 1, 256, 2),
    "dd1_tile64_N17": (10, 17, 16, 1, 64, 2),
    "dd1_N8_narrow": (1, 8, 8, 1, 32, 1),
    "bf16_dd1_N29": (2, 29, 64, 1, 256, 2),
    "bf16_dd1_tile64_N17": (10, 17, 16, 1, 64, 2),
    "bf16_dd1_N8_narrow": (3, 8, 16, 1, 40, 1),
    # a zero shift and scale (cond_time=False)
    "zero_mod_dd1_N17": (3, 17, 16, 1, 64, 2),
    "bf16_zero_mod_N29": (2, 29, 64, 64, 256, 2),
    "bf16_zero_mod_dd1_tile64_N17": (10, 17, 16, 1, 64, 2),
}


@pytest.mark.parametrize("case", sorted(EQUI_CASES))
def test_equi_update_source_on_the_host_matches_the_plain_version(equi_lib, case):
    args = _tensors("equi_update", _equi_inputs(11, *EQUI_CASES[case]), case.startswith("bf16_"))
    if "zero_mod" in case:
        args[10], args[11] = torch.zeros_like(args[10]), torch.zeros_like(args[11])
    rc, got = _equi_call(equi_lib, args)
    assert rc == 0
    want = equi_update_reference(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


ATTN_CASES = {  # B, N, De, E, sc, H, C, X, set_inf; tiles of 32 rows unless named
    "flagship_N29": (3, 29, 64, 14, 18, 16, 16, 2, True),
    "tile64_N17": (10, 17, 16, 4, 8, 6, 8, 2, True),  # 64-row tiles of two rows, the last partial
    "flagship_N29_no_set_inf": (1, 29, 64, 14, 18, 16, 16, 2, False),
    "N17_4byte_copies": (3, 17, 10, 6, 6, 8, 8, 2, False),  # edge rows not 16-byte aligned
    "N8_narrow": (1, 8, 16, 3, 8, 4, 8, 1, True),
    # bfloat16 operands: the gate products on the tensor cores; E*sc = 252
    # pads W0's tile with 4 zero columns
    "bf16_flagship_N29": (2, 29, 64, 14, 18, 16, 16, 2, True),
    "bf16_flagship_N17_no_set_inf": (3, 17, 64, 14, 18, 16, 16, 2, False),
    "bf16_tile64_N17": (10, 17, 16, 4, 8, 6, 8, 2, True),  # 64-row tiles of two rows
    "bf16_N8_narrow": (1, 8, 32, 3, 4, 4, 3, 1, True),  # E*sc = H*C = 12: an n8 tile half-used
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_mix_attention_source_on_the_host_matches_the_plain_version(attn_lib, case):
    *shape, set_inf = ATTN_CASES[case]
    args = _tensors("mix_attention", _attn_inputs(12, *shape), case.startswith("bf16_"))
    rc, got = _attn_call(attn_lib, args, set_inf)
    assert rc == 0
    want = mix_attention_reference(*args, set_inf=set_inf)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("where", [1, 5])  # rows of a molecule a tile, shared-memory bytes
def test_equi_update_source_refuses_a_wrong_plan(equi_lib, where):
    args = [torch.from_numpy(a) for a in _equi_inputs(13, *EQUI_CASES["N8_narrow"])]
    rc, out = _equi_call(equi_lib, args, bump=where)
    assert rc != 0
    assert torch.isnan(out).all()  # nothing launched


@pytest.mark.parametrize("bf16", [False, True])
def test_equi_update_source_refuses_a_plan_reckoned_for_a_16_wide_dist(equi_lib, bf16):
    """A plan reckoned for Dd = 16 (another shared-memory size: the bf16
    slab holds no dist column at Dd = 1) is refused at Dd = 1 with nothing
    launched."""
    B, N, de, dd, dh, n_adj = 3, 8, 64, 1, 16, 1
    assert equi_plan(B, N, de, 16, dh, bf16) != equi_plan(B, N, de, dd, dh, bf16)
    args = _tensors("equi_update", _equi_inputs(17, B, N, de, dd, dh, n_adj), bf16)
    out = torch.full((B, N, 3), float("nan"))
    ints = _ints(equi_plan(B, N, de, 16, dh, bf16))
    rc = equi_lib.dstt_equi_update(*(a.data_ptr() for a in args), out.data_ptr(), B, N, de, dd,
                                   dh, n_adj, int(bf16), 1e-6, ints, len(ints), None)
    assert rc != 0
    assert torch.isnan(out).all()


@pytest.mark.parametrize("where", [0, 3])  # rows a tile, blocks
def test_mix_attention_source_refuses_a_wrong_plan(attn_lib, where):
    args = [torch.from_numpy(a) for a in _attn_inputs(14, *ATTN_CASES["N8_narrow"][:-1])]
    rc, out = _attn_call(attn_lib, args, True, bump=where)
    assert rc != 0
    assert torch.isnan(out).all()


@pytest.mark.parametrize("kernel", ["equi_update", "mix_attention"])
def test_bf16_source_refuses_a_plan_reckoned_for_float32_slabs(equi_lib, attn_lib, kernel):
    """The C entry reckons the shared memory of the bfloat16 slabs itself:
    the float32 plan (another size) is refused with nothing launched."""
    if kernel == "equi_update":
        args = _tensors(kernel, _equi_inputs(15, *EQUI_CASES["bf16_N8_narrow"]), True)
        rc, out = _equi_call(equi_lib, args, plan_bf16=False)
    else:
        args = _tensors(kernel, _attn_inputs(16, *ATTN_CASES["bf16_N8_narrow"][:-1]), True)
        rc, out = _attn_call(attn_lib, args, True, plan_bf16=False)
    assert rc != 0
    assert torch.isnan(out).all()
