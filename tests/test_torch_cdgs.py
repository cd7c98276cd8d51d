"""CDGS, the 2-D model, against the JAX package on the CPU: its layers and
masks, the model, and the weights carried across. Inputs come from numpy
seeds; JAX runs on XLA (the model has no Pallas kernel).

- ``DenseEdgeGateTransLayer``, ``DenseGINE`` (``eps`` moved off 0),
  ``GroupNormChannels`` (the padding's values counted in the statistics)
  and ``HybridMPBlock`` (with and without ``temb``) against the flax
  modules on the same inputs and weights (their zero biases and unit
  scales moved, so that they count): float32 within 1e-5 of the largest
  value; bfloat16 within half of the module's own bfloat16-against-float32
  gap (measured: each bit for bit, a block at most 5e-5 of the gap).
- ``sinusoidal_timestep_embedding`` at even and odd widths, within two
  float32 ulps of each frequency times the time (XLA's exp and PyTorch's
  differ by an ulp);
  ``get_rw_feat_dense`` and the random-walk landing of a disconnected
  graph and of padded rows, exact.
- The narrow model (nf 32, 2 blocks, 4 heads, rw_depth 4, ragged N 4-10),
  through ``context`` (SpecFormer inside the JAX model) and through
  ``context_emb`` (``encode_context``): float32 within 1e-5 of the largest
  value. In bfloat16 the model is held to JAX's bfloat16 precision, as
  ``tests/test_torch_dmt_wo_eq.py`` holds DMT_WO_EQ: max |port bf16 - JAX
  f32| between 0.5 and 1.5 times max |JAX bf16 - JAX f32|; and, as CDGS
  keeps JAX's roundings, within half of that gap of JAX's bf16 (measured
  at most 2e-4 of it).
- The parameter trees (``cond_time`` on and off): equal to JAX's
  ``model.init`` (names and shapes), loaded strictly and given back
  unchanged; ``init_variables`` has the same leaves, GINE's ``eps`` 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import smoke_2d
from diffspectra_tpu.models import cdgs as jc
from diffspectra_tpu.models import layers as jl
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.models import cdgs as pc
from diffspectra_tpu_torch.models import layers as pl
from diffspectra_tpu_torch.utils import masks as M
from diffspectra_tpu_torch.utils.registry import create_model
from diffspectra_tpu_torch.warm_state import (
    flax_variables,
    init_variables,
    load_model_state,
    random_variables,
)

torch.set_num_threads(2)

NARROW = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 10}
N_NODES = (4, 7, 10, 6)


def cdgs_configs(overrides):
    """JAX's ``smoke_2d`` config and the port's ``get_smoke_2d_config()``,
    each with the same ``{"section.key": value}`` overrides."""
    jcfg, pcfg = smoke_2d.get_config(), configs.get_smoke_2d_config()
    for key, value in overrides.items():
        section, leaf = key.split(".")
        node = getattr(jcfg, section)
        if leaf in node and type(node[leaf]) is not type(value):  # ml_collections keeps types
            del node[leaf]
        setattr(node, leaf, value)
        configs.apply_overrides(pcfg, {key: value})
    return jcfg, pcfg


def masks(n_nodes=N_NODES, n=10):
    node_mask = (np.arange(n)[None] < np.asarray(n_nodes)[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None] * (1 - np.eye(n, dtype=np.float32))
    return node_mask[..., None], edge_mask


def model_inputs(seed=0, n_nodes=N_NODES, n=10, feat=5):
    """One noisy step of the 2-D path: atoms, symmetric bonds, times and
    spectra."""
    rng = np.random.default_rng(seed)
    node_mask, edge_mask = masks(n_nodes, n)
    bs = len(n_nodes)
    e = rng.normal(size=(bs, n, n, 2)).astype(np.float32)
    return dict(
        t=rng.uniform(0.01, 1.0, bs).astype(np.float32),
        xh=(rng.normal(size=(bs, n, feat)) * node_mask).astype(np.float32),
        edge_x=((e + e.transpose(0, 2, 1, 3)) * edge_mask[..., None]).astype(np.float32),
        node_mask=node_mask, edge_mask=edge_mask,
        spec=np.log10(np.abs(rng.normal(size=(bs, 3501))) * 10 + 1).astype(np.float32),
    )


def jax_variables(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def jax_init(model, inp):
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(inp["t"]), jnp.asarray(inp["xh"]),
        jnp.asarray(inp["node_mask"]), jnp.asarray(inp["edge_mask"]), jnp.asarray(inp["spec"]),
        edge_x=jnp.asarray(inp["edge_x"]))
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(variables), sep="/").items()}


def jax_forward(model, flat, inp, through_emb=False):
    variables = jax_variables(flat)
    args = [jnp.asarray(inp[k]) for k in ("t", "xh", "node_mask", "edge_mask")]
    spec = jnp.asarray(inp["spec"])

    def apply(v):
        if through_emb:
            emb = jax_encode_context(model, v, spec)
            return model.apply(v, *args, None, edge_x=jnp.asarray(inp["edge_x"]),
                               context_emb=emb)
        return model.apply(v, *args, spec, edge_x=jnp.asarray(inp["edge_x"]))

    return [np.asarray(o, np.float32) for o in jax.jit(apply)(variables)]


def port_forward(model, inp):
    T = torch.from_numpy
    with torch.no_grad():
        emb = model.encode_context([T(inp["spec"])])
        out = model(T(inp["t"]), T(inp["xh"]), T(inp["node_mask"]), T(inp["edge_mask"]),
                    T(inp["edge_x"]), None, None, None, False, emb)
    return [o.float().numpy() for o in out]


# ---- layers and masks ---------------------------------------------------------------

def _module_inputs(seed=0, B=4, N=8, D=32):
    rng = np.random.default_rng(seed)
    node_mask = np.ones((B, N, 1), np.float32)
    node_mask[0, 6:] = 0
    node_mask[2, 5:] = 0
    edge_mask = node_mask * node_mask.transpose(0, 2, 1) * (1 - np.eye(N, dtype=np.float32))
    return dict(h=rng.normal(size=(B, N, D)).astype(np.float32),
                e=rng.normal(size=(B, N, N, D)).astype(np.float32),
                adj=(rng.uniform(size=(B, N, N)) > 0.5).astype(np.float32) * edge_mask,
                node_mask=node_mask, edge_mask=edge_mask,
                temb=rng.normal(size=(B, D)).astype(np.float32))


def _module_pair(kind, dtype, D=32, H=4):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    if kind == "attention":
        return (jl.DenseEdgeGateTransLayer(D, D // H, heads=H, dtype=jdt),
                pl.DenseEdgeGateTransLayer(D, D // H, H, dtype=tdt))
    if kind == "gine":
        return jc.DenseGINE(D, dtype=jdt), pc.DenseGINE(D, tdt)
    if kind == "group_norm_nodes" or kind == "group_norm_pairs":
        return jc.GroupNormChannels(D), pc.GroupNormChannels(D)
    return jc.HybridMPBlock(D, H, dtype=jdt), pc.HybridMPBlock(D, H, dtype=tdt,
                                                             cond_time=kind == "block_temb")


def _module_args(kind, inp):
    h, e, adj, nm, em, temb = (inp[k] for k in ("h", "e", "adj", "node_mask", "edge_mask",
                                                "temb"))
    return {"attention": (h, e, em), "gine": (h, e, adj), "group_norm_nodes": (h,),
            "group_norm_pairs": (e,), "block_temb": (h, e, adj, nm, em, temb),
            "block": (h, e, adj, nm, em)}[kind]


def _run_module(kind, dtype, inp):
    jmod, port = _module_pair(kind, dtype)
    args = _module_args(kind, inp)
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(1)
    flat = {k: np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(variables["params"], sep=".").items()}
    # flax's zero biases, unit scales and zero eps moved, so that they count
    flat = {k: np.asarray(v + rng.normal(size=v.shape).astype(np.float32) * 0.3)
            if v.ndim <= 1 else v for k, v in flat.items()}
    want = jax.jit(lambda v: jmod.apply(v, *args))({"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})})
    port.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()}, strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    as_list = lambda x: list(x) if isinstance(x, (tuple, list)) else [x]
    return ([np.asarray(w, np.float32) for w in as_list(want)],
            [g.float().numpy() for g in as_list(got)])


MODULES = ("attention", "gine", "group_norm_nodes", "group_norm_pairs", "block_temb", "block")


@pytest.mark.parametrize("kind", MODULES)
def test_layer_matches_flax_in_f32_and_bf16(kind):
    inp = _module_inputs()
    if kind.startswith("group_norm"):
        # the padding's values count in flax's statistics: leave them nonzero
        assert inp["node_mask"].min() == 0
    want32, got32 = _run_module(kind, "f32", inp)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    if kind.startswith("group_norm"):
        return  # flax's GroupNorm has no dtype here: float32 in both models
    want16, got16 = _run_module(kind, "bf16", inp)
    for g16, w16, w32 in zip(got16, want16, want32):
        err, gap = np.abs(g16 - w16).max(), np.abs(w16 - w32).max()
        assert np.isfinite(g16).all() and gap > 0 and err <= 0.5 * gap, (kind, err, gap)


def test_gine_eps_counts_the_self_term():
    """GINE with eps = 0.7: the self term is 1.7 x, against flax."""
    jmod, port = jc.DenseGINE(16), pc.DenseGINE(16)
    inp = _module_inputs(D=16)
    args = (inp["h"], inp["e"], inp["adj"])
    variables = jmod.init(jax.random.PRNGKey(3), *args)
    flat = {k: np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(variables["params"], sep=".").items()}
    assert flat["eps"].shape == () and flat["eps"] == 0
    flat["eps"] = np.float32(0.7)
    want = jmod.apply({"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})}, *args)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()})
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dim", [32, 33, 7, 256])
def test_sinusoidal_timestep_embedding_matches_jax(dim):
    """Within what a frequency one float32 ulp off moves: XLA's exp and
    PyTorch's differ by an ulp on some frequencies, and a time of 999
    multiplies it (at most 6e-5 at dim 256)."""
    t = np.linspace(0.0, 999.0, 9).astype(np.float32)
    want = np.asarray(jl.sinusoidal_timestep_embedding(jnp.asarray(t), dim))
    got = pl.sinusoidal_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == (9, dim) and got.dtype == np.float32
    if dim % 2:
        assert (got[:, -1] == 0).all()
    half = dim // 2
    freqs = np.exp(-np.arange(half) * np.log(10000.0) / (half - 1))
    ulp = t[:, None] * np.concatenate([freqs, freqs]) * 2.0**-23
    np.testing.assert_array_less(np.abs(got[:, :2 * half] - want[:, :2 * half]), 2e-7 + 2 * ulp)


def _graphs():
    """Adjacencies [3, 9, 9]: a path, two disconnected parts, and a graph of
    5 atoms padded to 9 (its padded rows and columns zero)."""
    adj = np.zeros((3, 9, 9), np.float32)
    for i in range(8):
        adj[0, i, i + 1] = adj[0, i + 1, i] = 1
    for i, j in ((0, 1), (1, 2), (2, 0), (4, 5), (5, 6), (6, 7), (7, 8)):
        adj[1, i, j] = adj[1, j, i] = 1
    for i, j in ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (1, 3)):
        adj[2, i, j] = adj[2, j, i] = 1
    return adj


@pytest.mark.parametrize("k_step", [4, 8])
def test_random_walk_features_match_jax(k_step):
    adj = _graphs()
    want = np.asarray(JM.get_rw_feat_dense(k_step, jnp.asarray(adj)))
    got = M.get_rw_feat_dense(k_step, torch.from_numpy(adj)).numpy()
    assert got.shape == (3, 9, 9, k_step + 1)
    np.testing.assert_array_equal(got, want)
    # the parts of graph 1 never reach each other; a padded row reaches nothing
    assert (got[1, 0, 5:].argmax(-1) == k_step).all() and (got[2, 6:].argmax(-1) == k_step).all()
    # the landing probabilities, as the JAX model stacks the walks
    ad = adj / (adj.sum(-1, keepdims=True) + 1e-8)
    walks, landing = ad, []
    for _ in range(k_step):
        walks = np.einsum("bij,bjk->bik", walks, ad)
        landing.append(np.diagonal(walks, axis1=1, axis2=2))
    rw = M.random_walk_maps(k_step, torch.from_numpy(adj))
    np.testing.assert_allclose(torch.diagonal(rw, dim1=2, dim2=3).transpose(1, 2).numpy(),
                               np.stack(landing, -1), rtol=1e-6, atol=1e-7)
    assert (torch.diagonal(rw, dim1=2, dim2=3)[2, :, 5:] == 0).all()


# ---- the model ---------------------------------------------------------------------

def _narrow(precision, flat=None):
    jcfg, pcfg = cdgs_configs({**NARROW, "training.matmul_precision": precision})
    port = create_model(pcfg)
    flat = random_variables(port, seed=0) if flat is None else flat
    load_model_state(port, flat)
    return jc.CDGS.from_config(jcfg), port, flat


@pytest.mark.parametrize("through_emb", [False, True])
def test_narrow_model_matches_jax(through_emb):
    inp = model_inputs()
    jmodel, port, flat = _narrow("float32")
    assert type(port) is pc.CDGS and port.rw_depth == 4
    want32 = jax_forward(jmodel, flat, inp, through_emb)
    got32 = port_forward(port, inp)
    for g, w in zip(got32, want32):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    jmodel16, port16, _ = _narrow("bfloat16", flat)
    want16 = jax_forward(jmodel16, flat, inp, through_emb)
    for g16, w16, w32 in zip(port_forward(port16, inp), want16, want32):
        gap = np.abs(w16 - w32).max()
        own = np.abs(g16 - w32).max() / gap
        assert np.isfinite(g16).all() and 0.5 <= own <= 1.5, own
        assert np.abs(g16 - w16).max() <= 0.5 * gap, np.abs(g16 - w16).max() / gap


def test_scores_are_masked_and_symmetric():
    inp = model_inputs(1)
    _, port, _ = _narrow("float32")
    atom, bond = port_forward(port, inp)
    assert atom.shape == (4, 10, 5) and bond.shape == (4, 10, 10, 2)
    np.testing.assert_array_equal(atom * (1 - inp["node_mask"]), 0)
    np.testing.assert_array_equal(bond * (1 - inp["edge_mask"][..., None]), 0)
    np.testing.assert_allclose(bond, bond.transpose(0, 2, 1, 3), rtol=0, atol=1e-7)


def test_channel_splits_at_full_width():
    """nf=256, 8 blocks: bond_se 102, bond_type 77, atom_se 51, the skip
    concat 64 a block; proj_atom reads the atom types and the charge."""
    config = configs.apply_overrides(configs.get_config(), {
        "only_2D": True, "model.name": "CDGS", "model.include_fc_charge": True})
    shapes = {k: tuple(v.shape) for k, v in create_model(config).state_dict().items()}
    assert shapes["proj_spd.kernel"] == (9, 102)
    assert shapes["proj_cate.kernel"] == shapes["proj_exist.kernel"] == (1, 77)
    assert shapes["proj_degree.kernel"] == (2, 51) and shapes["proj_rwl.kernel"] == (8, 51)
    assert shapes["proj_atom.kernel"] == (6, 256 - 2 * 51)
    assert shapes["node_0.kernel"] == shapes["edge_7.kernel"] == (256, 64)
    assert shapes["block_0.norm1_local.GroupNorm_0.scale"] == (256,)


# ---- the weights carried across ------------------------------------------------------

@pytest.mark.parametrize("cond_time", [True, False])
def test_parameter_tree_matches_jax_init_and_carries_across(cond_time):
    jcfg, pcfg = cdgs_configs({**NARROW, "model.cond_time": cond_time})
    inp = model_inputs()
    want = jax_init(jc.CDGS.from_config(jcfg), inp)
    port = create_model(pcfg)
    assert {k: v.shape for k, v in flax_variables(port).items()} == {
        k: v.shape for k, v in want.items()}
    load_model_state(port, want)
    got = flax_variables(port)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "params/block_1/local_model/eps" in want
    assert "params/block_0/norm2_edge/GroupNorm_0/bias" in want
    assert ("params/block_0/t_edge/kernel" in want) == cond_time
    assert ("params/temb_0/kernel" in want) == cond_time
    fresh = init_variables(create_model(pcfg), seed=0)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in want.items()}
    assert fresh["params/block_0/local_model/eps"] == 0
    assert (fresh["params/block_0/norm1_attn/GroupNorm_0/scale"] == 1).all()
    # a fresh init serves: finite scores from the model it loads into
    load_model_state(port, fresh)
    assert all(np.isfinite(o).all() for o in port_forward(port, inp))
