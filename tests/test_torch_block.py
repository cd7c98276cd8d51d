"""The port's whole-block path against the JAX package's.

1. ``block_fused_reference`` (the plain version of ``csrc/block_fused.cu``)
   against JAX ``block_fused(..., interpret=True)`` on the same seeded
   arrays, all three outputs including padded pairs, at a small size
   (nf=32, 4 heads, N=8, ragged B=3) and at flagship widths (B=2, N=29).
   Tolerance atol 1e-5: four LayerNorms and 512-deep sums in another order
   (measured 1e-6).
2. The port's DMT with ``pallas_ops=('block',)`` against JAX ``DMT`` with
   ``use_pallas=True, pallas_ops=('block',)`` in interpret mode, on the same
   weights, with and without self-conditioning, rtol = atol = 2e-4 (as
   ``tests/test_pallas_block.py`` holds the JAX block path to its XLA path).
3. ``warm_qm9s_as.npz`` loads into the block-path model with the same
   ``state_dict`` keys, and its full-width CPU forward equals the port's
   ``('attn','equi')`` forward within 1e-4 x max|value|, both in float32
   (in bfloat16 the two paths round at other places, as JAX's do).
4. The wrapper's checks.
5. The kernel's launch plan (``launch_plan``, which ``csrc/block_fused.cu``
   recomputes and checks) at N in {8, 17, 21, 25, 29, 32} and B in {1, 3,
   10, 80}, flagship widths: stage A / B tiles cover each row (b, i) once
   and never mix molecules, node tiles cover the B N rows with 16-31 rows
   each, and every launch fits the card's shared memory.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import smoke
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.ops.pallas_block import block_fused as jax_block_fused
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import load_model
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.ops.block_fused import (MAX_SMEM, NODE_ROWS, _DATA, _WEIGHTS,
                                                   block_fused, launch_plan)
from diffspectra_tpu_torch.warm_state import load_model_state, random_variables
from test_torch_dmt import _inputs, _jax_forward, _torch_forward

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")


def block_case(rng, n_nodes, N, dh, heads, n_extra=2):
    """Seeded inputs of ``block_fused`` in argument order, and its options."""
    B, de, out_ch = len(n_nodes), dh // 4, dh // heads
    n_sub = heads - n_extra
    ec = n_sub * (heads * out_ch // n_sub)
    r = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    node = (np.arange(N)[None] < np.array(n_nodes)[:, None]).astype(np.float32)
    edge_mask = node[:, :, None] * node[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    data = dict(
        h=r(B, N, dh), q=r(B, N, ec), k=r(B, N, ec), v=r(B, N, dh), edge_in=r(B, N, N, de),
        d2=np.abs(r(B, N, N, 1, scale=2.0)), normed_diff=r(B, N, N, 3, scale=0.1),
        adj=(rng.uniform(size=(B, N, N, n_extra)) > 0.5).astype(np.float32),
        edge_mask=edge_mask, node_mask=node[..., None], node_mods4=r(B, 4, dh, scale=0.2),
        edge_mods6=r(B, 6, de, scale=0.2), eq_ss=r(B, 2, dh, scale=0.2),
        gbf_ss=r(B, 1, 2, scale=0.2),
    )
    shapes = dict(
        emb_kd=(de, de), emb_ke=(de, de), emb_b=(de,), w0a=(de, ec), w1a=(de, dh),
        n2e_k=(dh, de), n2e_b=(de,), fn1_k=(dh, 2 * dh), fn1_b=(2 * dh,), fn2_k=(2 * dh, dh),
        fn2_b=(dh,), fe1_k=(de, 2 * de), fe1_b=(2 * de,), fe2_k=(2 * de, de), fe2_b=(de,),
        w_hi=(dh, dh), w_hj=(dh, dh), w_e=(de, dh), w_d=(de, dh), eq_bias=(dh,),
        eq_k0=(dh, dh), eq_b0=(dh,), eq_k1=(dh, 1 + n_extra),
    )
    weights = {k: r(*s, scale=s[0] ** -0.5 if len(s) == 2 else 0.1) for k, s in shapes.items()}
    weights["gbf_means"] = rng.uniform(0, 3, de - 1).astype(np.float32)
    weights["gbf_stds"] = rng.uniform(0.5, 3, de - 1).astype(np.float32)
    arrays = [data[k] for k in _DATA] + [weights[k] for k in _WEIGHTS]
    return arrays, dict(n_heads=heads, n_extra=n_extra, out_ch=out_ch)


@pytest.mark.parametrize("n_nodes,N,dh,heads", [
    ([5, 8, 3], 8, 32, 4),  # small, ragged
    ([29, 17], 29, 256, 16),  # flagship widths
])
def test_block_reference_matches_jax_kernel(n_nodes, N, dh, heads):
    arrays, kw = block_case(np.random.default_rng(0), n_nodes, N, dh, heads)
    want = jax_block_fused(*map(jnp.asarray, arrays), interpret=True, **kw)
    got = block_fused(*map(torch.from_numpy, arrays), **kw)
    for name, g, w in zip(("h_out", "edge_out", "agg"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)
    # edge_out is not masked: padded pairs carry values, as in the TPU kernel
    b = int(np.argmin(n_nodes))
    assert np.abs(got[1].numpy()[b, n_nodes[b]:, n_nodes[b]:]).max() > 0.1


def _small_config(pallas_ops):
    return configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
        "model.pallas_ops": pallas_ops})


@pytest.mark.parametrize("has_cond", [True, False])
def test_small_block_dmt_matches_jax_block_path(monkeypatch, has_cond):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    cfg = smoke.get_config()
    cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 4
    cfg.data.max_node = 8
    cfg.model.use_pallas = True
    cfg.model.pallas_ops = ("block",)
    model = JaxDMT.from_config(cfg)
    assert model.use_pallas and model.pallas_ops == ("block",)

    port = DMT.from_config(_small_config(("block",)))
    assert all(b.e_block.block_kernel for b in port.blocks)
    flat = random_variables(port, seed=1)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )

    inp = _inputs(np.random.default_rng(2), [5, 7, 6, 8], 8, 9, [3501], has_cond)
    want_pred, want_edge = _jax_forward(model, variables, inp, has_cond)
    got_pred, got_edge = _torch_forward(port, inp, has_cond)

    np.testing.assert_allclose(got_pred, want_pred, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_edge, want_edge, rtol=2e-4, atol=2e-4)


def test_warm_weights_serve_both_paths():
    f32 = {"training.matmul_precision": "float32"}  # the paths agree to float32 sums
    base = load_model(WARM, configs.apply_overrides(configs.get_config(), f32), "cpu")
    block = load_model(WARM, configs.apply_overrides(configs.get_config(),
                                                   {"model.pallas_ops": ("block",), **f32}), "cpu")
    assert block.blocks[0].e_block.block_kernel and not base.blocks[0].e_block.block_kernel
    assert block.state_dict().keys() == base.state_dict().keys()

    rng = np.random.default_rng(1)
    inp = _inputs(rng, [12, 9], 12, 9, [701, 3501, 3501], True)
    nm, em = inp["node_mask"], inp["edge_mask"]
    inp["cond_x"] = np.concatenate(
        [rng.normal(size=(2, 12, 3)) * 1.5, rng.uniform(-0.25, 0.25, size=(2, 12, 6))], -1
    ).astype(np.float32) * nm
    c = rng.uniform(-1, 1, size=(2, 12, 12, 2)).astype(np.float32)
    inp["cond_edge_x"] = 0.5 * (c + c.transpose(0, 2, 1, 3)) * em[..., None]
    data = generate(seed=3, size=2, max_n=12, fidelity=4)
    inp["specs"] = [np.log10(data[k] + 1.0).astype(np.float32) for k in ("uv", "ir", "raman")]
    inp["noise_level"] = np.asarray([-6.0, 4.0], np.float32)
    want = _torch_forward(base, inp, True)
    got = _torch_forward(block, inp, True)
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert np.isfinite(g).all() and 0.1 < scale < 10
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale)


def test_block_wrapper_checks_its_inputs():
    arrays, kw = block_case(np.random.default_rng(3), [5, 8, 3], 8, 32, 4)
    tensors = list(map(torch.from_numpy, arrays))
    with pytest.raises(TypeError, match="tensors"):
        block_fused(*tensors[:-1], **kw)
    bad = list(tensors)
    bad[_DATA.index("d2")] = bad[_DATA.index("d2")][..., 0]  # [B, N, N] not [B, N, N, 1]
    with pytest.raises(ValueError, match="d2"):
        block_fused(*bad, **kw)
    bad = list(tensors)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError, match="float32"):
        block_fused(*bad, **kw)
    bad = list(tensors)
    bad[len(_DATA) + _WEIGHTS.index("eq_k1")] = torch.zeros(32, 4)  # 1 + A = 3 columns
    with pytest.raises(ValueError, match="eq_k1"):
        block_fused(*bad, **kw)
    bad = list(tensors)
    bad[1] = bad[1].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        block_fused(*bad, **kw)


PLAN_N = (8, 17, 21, 25, 29, 32)
PLAN_B = (1, 3, 10, 80)


def _flagship_plan(B, N):
    # Dh=256, De=64, 16 heads of which 2 adjacency heads (E*sc = 14 * 18)
    return launch_plan(B, N, dh=256, de=64, ec=252, hc=256, heads=16, rn=512, re=128)


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("N", PLAN_N)
def test_launch_plan_pair_tiles_cover_each_row_once(N, B):
    plan = _flagship_plan(B, N)
    tiles = plan.pair_tiles()
    assert plan.grid_a == plan.grid_b == len(tiles) == B * plan.tiles
    covered = [(b, i) for b, i0, rows in tiles for i in range(i0, i0 + rows)]
    assert sorted(covered) == [(b, i) for b in range(B) for i in range(N)]
    for b, i0, rows in tiles:  # one molecule a tile, at most 64 pairs
        assert 0 <= b < B and 1 <= rows and i0 + rows <= N and rows * N <= 64
    # two rows a tile at least, so that each pair weight read serves two rows
    assert plan.rows_per_tile >= 2


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("N", PLAN_N)
def test_launch_plan_node_tiles_cover_all_rows(N, B):
    plan = _flagship_plan(B, N)
    spans = plan.node_rows()
    assert len(spans) == plan.node_tiles
    assert spans[0][0] == 0 and spans[-1][1] == B * N
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for r0, r1 in spans:  # 16 rows a node weight at least, unless the batch has fewer
        assert min(16, B * N) <= r1 - r0 <= NODE_ROWS
    # column tiles: fn1 and n2e by 128, fn2 by 64, W_hi and W_hj by 128
    assert plan.grid_n1 == plan.node_tiles * (4 + 1)
    assert plan.grid_n2 == plan.node_tiles * 4
    assert plan.grid_n3 == plan.node_tiles * 4


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("N", PLAN_N)
def test_launch_plan_fits_shared_memory(N, B):
    plan = _flagship_plan(B, N)
    for name, (blocks, smem) in plan.launches().items():
        assert blocks >= 1 and 0 < smem <= MAX_SMEM, name
    # the pair stages fit two blocks an SM (228 KB an SM, 1 KB reserved a block)
    assert 2 * (max(plan.smem_a, plan.smem_b) + 1024) <= 228 * 1024
