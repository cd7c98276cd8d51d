"""The plain PyTorch versions of the two kernels against their JAX references
(``mix_attention_reference``, ``equi_update_reference``), at small shapes and
at the flagship shape (B=2, N=29), float32, on a ragged masked batch.
Tolerance atol 2e-5, as ``tests/test_pallas_attention.py`` holds the JAX
kernel to its reference. Also: the wrappers' checks, and the masking traps
(-1e30 padding, -1e10 zero adjacency, finite rows). And the kernels' launch
plans (``launch_plan``, which ``csrc/equi_update.cu`` and
``csrc/mix_attention.cu`` recompute and check) at N in {8, 17, 21, 25, 29,
32} and B in {1, 3, 10, 80}, flagship widths: the tiles cover each row
(b, i) once, never mix molecules, hold at most 64 pairs, fit the card's
shared memory, and two blocks fit an SM.

The kernels themselves run on the card only; ``chip_smoke.py`` holds them
against these plain versions there (``tests/test_torch_ops_host.py`` runs
their CUDA source on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffspectra_tpu.ops.pallas_attention import mix_attention_reference as jax_attn
from diffspectra_tpu.ops.pallas_equi_update import equi_update_reference as jax_equi
from diffspectra_tpu_torch.api import resolve_device
from diffspectra_tpu_torch.ops import LAUNCHES
from diffspectra_tpu_torch.ops._row_tile import (MAX_SMEM, MIN_BLOCKS, ROW_COST, SMEM_PER_SM,
                                                  SMS, cdiv)
from diffspectra_tpu_torch.ops.equi_update import equi_update
from diffspectra_tpu_torch.ops.equi_update import launch_plan as equi_plan
from diffspectra_tpu_torch.ops.mix_attention import launch_plan as attn_plan
from diffspectra_tpu_torch.ops.mix_attention import mix_attention, mix_attention_reference

torch.set_num_threads(2)

ATOL = 2e-5


def _masks(rng, B, N):
    n_nodes = rng.integers(1, N + 1, size=B)
    n_nodes[0] = N
    nm = (np.arange(N)[None] < n_nodes[:, None]).astype(np.float32)
    em = nm[:, :, None] * nm[:, None, :] * (1.0 - np.eye(N, dtype=np.float32))
    return em


def _attn_inputs(seed, B, N, de, n_sub, sub_c, heads, out_ch, n_extra):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    extra = (rng.random((B, N, N, n_extra)) > 0.5).astype(np.float32)
    return (f(B, N, n_sub, sub_c), f(B, N, n_sub, sub_c), f(B, N, heads, out_ch),
            f(B, N, N, de), f(de, n_sub * sub_c, scale=de**-0.5),
            f(de, heads * out_ch, scale=de**-0.5), extra, _masks(rng, B, N))


def _equi_inputs(seed, B, N, de, dd, dh, n_adj):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    adj = (rng.random((B, N, N, n_adj)) > 0.5).astype(np.float32)
    return (f(B, N, dh), f(B, N, dh), f(B, N, N, de), f(B, N, N, dd), f(B, N, N, 3),
            adj, _masks(rng, B, N), f(de, dh, scale=de**-0.5), f(dd, dh, scale=dd**-0.5),
            f(dh, scale=0.1), f(B, dh, scale=0.1), f(B, dh, scale=0.1),
            f(dh, dh, scale=dh**-0.5), f(dh, scale=0.1), f(dh, 1 + n_adj, scale=dh**-0.5))


ATTN_SHAPES = {
    "small": (3, 6, 16, 3, 8, 4, 6, 1),
    "flagship": (2, 29, 64, 14, 18, 16, 16, 2),  # B, N, De, E, sc, H, C, X
}
EQUI_SHAPES = {
    "small": (3, 6, 8, 8, 32, 2),
    "flagship": (2, 29, 64, 64, 256, 2),  # B, N, De, Dd, Dh, A
}


@pytest.mark.parametrize("set_inf", [True, False])
@pytest.mark.parametrize("shape", sorted(ATTN_SHAPES))
def test_mix_attention_plain_matches_jax_reference(shape, set_inf):
    args = _attn_inputs(0, *ATTN_SHAPES[shape])
    want = np.asarray(jax_attn(*map(jnp.asarray, args), set_inf=set_inf))
    before = LAUNCHES["mix_attention"]
    got = mix_attention(*map(torch.from_numpy, args), set_inf=set_inf).numpy()
    assert LAUNCHES["mix_attention"] == before  # CPU tensors: no kernel launch
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(EQUI_SHAPES))
def test_equi_update_plain_matches_jax_reference(shape):
    args = _equi_inputs(1, *EQUI_SHAPES[shape])
    want = np.asarray(jax_equi(*map(jnp.asarray, args)))
    before = LAUNCHES["equi_update"]
    got = equi_update(*map(torch.from_numpy, args)).numpy()
    assert LAUNCHES["equi_update"] == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_masks_stay_finite():
    """Padding is -1e30 and a zero adjacency entry -1e10, both finite: a
    fully padded row and a row whose adjacency heads are all zero give
    finite outputs, equal to the JAX reference."""
    args = list(_attn_inputs(2, *ATTN_SHAPES["small"]))
    args[6] = np.zeros_like(args[6])  # every adjacency entry 0 -> -1e10
    args[7][1] = 0.0  # graph 1 entirely padding -> -1e30 everywhere
    want = np.asarray(jax_attn(*map(jnp.asarray, args), set_inf=True))
    got = mix_attention_reference(*map(torch.from_numpy, args), set_inf=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_logit_scale_is_sqrt_out_channels():
    """The learned logits are divided by sqrt(out_channels), not
    sqrt(sub_channels): a learned-head-only softmax over two neighbours
    follows sigmoid(delta / sqrt(C))."""
    B, N, de, n_sub, sub_c, heads, out_ch = 1, 3, 1, 1, 2, 1, 4
    q = torch.zeros(B, N, n_sub, sub_c)
    q[0, 0, 0] = 1.0
    k = torch.zeros(B, N, n_sub, sub_c)
    k[0, 1, 0, 0], k[0, 2, 0, 0] = 3.0, 1.0
    edge = torch.full((B, N, N, de), 50.0)  # tanh -> 1
    w0 = torch.ones(de, n_sub * sub_c)
    w1 = torch.ones(de, heads * out_ch)
    v = torch.zeros(B, N, heads, out_ch)
    v[0, 1], v[0, 2] = 1.0, 0.0
    em = torch.ones(B, N, N) - torch.eye(N)
    out = mix_attention_reference(q, k, v, edge, w0, w1, torch.zeros(B, N, N, 0), em)
    want = torch.sigmoid(torch.tensor((3.0 - 1.0) / out_ch**0.5))
    torch.testing.assert_close(out[0, 0, 0], want, rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs():
    args = [torch.from_numpy(a) for a in _attn_inputs(3, *ATTN_SHAPES["small"])]
    with pytest.raises(TypeError):
        mix_attention(*[a.double() for a in args])
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        mix_attention(*[a.to("meta") for a in args])
    with pytest.raises(ValueError):  # wrong shape
        mix_attention(*args[:3], args[3][:, :, :-1], *args[4:])
    eargs = [torch.from_numpy(a) for a in _equi_inputs(3, *EQUI_SHAPES["small"])]
    with pytest.raises(TypeError):
        equi_update(*eargs[:-1], eargs[-1].double())
    with pytest.raises(ValueError):
        equi_update(*eargs[:-1], eargs[-1][:, :2])


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


PLAN_N = (8, 17, 21, 25, 29, 32)
PLAN_B = (1, 3, 10, 80)
PLANS = {  # flagship widths: De = Dd = 64, Dh = H*C = 256, E*sc = 252, 16 heads
    "equi_update": lambda B, N: equi_plan(B, N, 64, 64, 256),
    "mix_attention": lambda B, N: attn_plan(B, N, 64, 252, 256, 16),
}


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("N", PLAN_N)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_row_tile_plan_covers_each_row_once(kernel, N, B):
    plan = PLANS[kernel](B, N)
    assert plan.tile_rows in (64, 32) and plan.threads == 4 * plan.tile_rows
    assert plan.grid == B * plan.tiles
    assert 1 <= plan.rows_per_tile and plan.rows_per_tile * N <= plan.tile_rows
    seen = []
    for x, (b, i0, rows) in enumerate(plan.row_tiles()):
        assert b == x // plan.tiles  # one molecule a block
        assert 1 <= rows <= plan.rows_per_tile and i0 + rows <= N  # cut to the molecule
        seen += [(b, i) for i in range(i0, i0 + rows)]
    assert seen == [(b, i) for b in range(B) for i in range(N)]
    if B == 10 and 17 <= N <= 25:  # 64-row tiles of R = 2: one wave of at most 130 blocks
        assert (plan.tile_rows, plan.rows_per_tile, plan.grid) == (64, 2, 10 * -(-N // 2))
    if B == 10 and N == 29:  # 290 one-row tiles of 32, where 150 of 64 put 2 on 18 SMs
        assert (plan.tile_rows, plan.rows_per_tile, plan.grid) == (32, 1, 290)
    if B == 80 and N >= 21:  # many waves either way: the 64-row tiles
        assert plan.tile_rows == 64


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("N", PLAN_N)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_row_tile_plan_fits_its_blocks_an_sm(kernel, N, B):
    plan = PLANS[kernel](B, N)
    assert plan.smem <= MAX_SMEM
    assert 2 <= plan.blocks_per_sm <= MIN_BLOCKS[plan.tile_rows]
    assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_PER_SM
    assert (plan.blocks_per_sm + 1) * (plan.smem + 1024) > SMEM_PER_SM or \
        plan.blocks_per_sm == MIN_BLOCKS[plan.tile_rows]
    # the other tile height would not give the busiest SM less work
    other = 96 - plan.tile_rows
    r = min(N, max(1, other // N))
    if B * cdiv(N, r) < SMS and r > 2:
        r = 2
    cost = cdiv(plan.grid, SMS) * ROW_COST[plan.tile_rows]
    assert cost <= cdiv(B * cdiv(N, r), SMS) * ROW_COST[other]
