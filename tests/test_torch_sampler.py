"""The slice as a whole against JAX: a small DMT, 10 ancestral steps at
``sampling_temperature=0`` from the same ``z_T``/``edge_z_T``, then
``post_process`` + ``mol_process`` and consensus ranking. Noise is scaled by
the temperature, so both loops are deterministic: atom types and bond
matrices must be identical, positions within atol 2e-3, and the WL
consensus ranking
must equal ``compute_metrics.consensus_rank``. Plus the leaves the loop is
made of: schedule, scalers, masks and edge quantisation, the latter also
with the third, aromatic edge channel (order 4), on a tensor and through
a narrow DMT with ``model.edge_ch=3``.

The position tolerance: one step of the two float32 forwards differs by
about 7e-6 (sums in another order), and the random-weight model amplifies
that about twofold per step, to about 7e-4 after 10 steps (measured on this
test's inputs: 6.9e-6, 1.3e-5, 3.1e-5 after 1, 2, 3 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import smoke
from diffspectra_tpu.diffusion.schedule import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.evaluation import compute_metrics as cm
from diffspectra_tpu.evaluation.molgraph import from_decoded as jax_from_decoded
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.sampling import decode as jdec
from diffspectra_tpu.sampling.ancestral import AncestralSampler as JaxSampler
from diffspectra_tpu.sampling.ancestral import make_time_steps as jax_time_steps
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu.utils import scalers as jsc
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.evaluation.molgraph import consensus_rank, from_decoded
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.sampling import decode as tdec
from diffspectra_tpu_torch.sampling.ancestral import AncestralSampler, make_time_steps
from diffspectra_tpu_torch.utils import masks as M
from diffspectra_tpu_torch.utils import scalers as tsc
from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

torch.set_num_threads(2)

OVERRIDES = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8}


def test_temperature_zero_sampling_decode_and_consensus_match_jax():
    steps, n, n_nodes = 10, 8, [8, 6, 8, 7, 8, 5]
    bs = len(n_nodes)
    pcfg = configs.apply_overrides(configs.get_smoke_config(), OVERRIDES)
    port = DMT.from_config(pcfg)
    flat = random_variables(port, seed=3)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )
    cfg = smoke.get_config()
    cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 4
    cfg.data.max_node = n
    model = JaxDMT.from_config(cfg)

    rng = np.random.default_rng(0)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    z = rng.normal(size=(bs, n, 9)).astype(np.float32) * node_mask
    z[..., :3] -= z[..., :3].sum(1, keepdims=True) / node_mask.sum(1, keepdims=True) * node_mask
    e = np.tril(rng.normal(size=(bs, n, n, 2)).astype(np.float32).transpose(0, 3, 1, 2), -1)
    edge_z = (e + e.transpose(0, 1, 3, 2)).transpose(0, 2, 3, 1) * edge_mask[..., None]
    spec = np.log10(np.abs(rng.normal(size=(bs, 3501))).astype(np.float32) * 10 + 1)

    # JAX: the scan sampler, XLA path
    jsch = JaxSchedule(cfg.sde.schedule)
    jsampler = JaxSampler(
        jsch, jax_time_steps(jsch, steps), cfg.model.pred_data, pred_edge=True,
        self_cond=cfg.model.self_cond, cond_process_fn=jsc.get_self_cond_fn(cfg),
        sampling_temperature=0.0,
    )

    def model_apply(t, x, nm, em, edge_x, nl, cond_x, cond_edge_x, has_cond, c_emb):
        return model.apply(variables, t, x, nm, em, None, edge_x=edge_x, noise_level=nl,
                           cond_x=cond_x, cond_edge_x=cond_edge_x, has_cond=has_cond,
                           context_emb=c_emb)

    ctx = jax_encode_context(model, variables, jnp.asarray(spec))
    jx, je = jax.jit(lambda z_, e_: jsampler.sampling(
        model_apply, jax.random.PRNGKey(0), z_, jnp.asarray(node_mask),
        jnp.asarray(edge_mask), e_, ctx))(jnp.asarray(z), jnp.asarray(edge_z))
    jout = jdec.post_process(jx, 5, True, jnp.asarray(node_mask),
                             jsc.get_data_inverse_scaler(cfg), je, jnp.asarray(edge_mask),
                             compress_edge=True)
    jmols = jdec.mol_process(jout[1], jout[0], jout[2], np.asarray(n_nodes), jout[3])

    # the port
    sch = NoiseScheduleVP(pcfg.sde.schedule)
    sampler = AncestralSampler(
        sch, make_time_steps(sch, steps), pcfg.model.pred_data,
        self_cond=pcfg.model.self_cond, cond_process_fn=tsc.get_self_cond_fn(pcfg),
        sampling_temperature=0.0,
    )
    T = lambda a: torch.from_numpy(np.array(a))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        tctx = port.encode_context([T(spec)])
        tx, te = sampler.sampling(port, gen, T(z), T(node_mask), T(edge_mask), T(edge_z), tctx)
    tout = tdec.post_process(tx, 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg),
                             te, T(edge_mask))
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2e-3)
    assert len(tmols) == len(jmols) == bs
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)

    decoder = get_dataset_info("qm9_second_half")["atom_decoder"]
    want = cm.consensus_rank([jax_from_decoded(m, decoder) for m in jmols])
    got = consensus_rank([from_decoded(m, decoder) for m in tmols])
    assert got == want


def test_consensus_rank_counts_repeats_like_jax():
    """Repeated draws of one molecule group together, ties keep the first."""
    decoder = get_dataset_info("qm9_second_half")["atom_decoder"]
    bonds = np.array([[0, 1, 0], [1, 0, 2], [0, 2, 0]])
    a = (None, np.array([1, 1, 3]), bonds, np.zeros(3, np.int64))
    b = (None, np.array([1, 3, 1]), bonds, np.zeros(3, np.int64))
    relabelled = np.array([[0, 0, 2], [0, 0, 1], [2, 1, 0]])
    c = (None, np.array([3, 1, 1]), relabelled, np.zeros(3, np.int64))  # a, atoms permuted
    mols = [b, a, c, b, a]
    want = cm.consensus_rank([jax_from_decoded(m, decoder) for m in mols])
    got = consensus_rank([from_decoded(m, decoder) for m in mols])
    assert got == want
    assert [count for _, count, _ in got] == [3, 2]


def test_cosine_schedule_matches_jax():
    t = np.linspace(1e-3, 0.9946, 57).astype(np.float32)
    js, ts = JaxSchedule("cosine"), NoiseScheduleVP("cosine")
    assert ts.T == js.T
    for got, want in zip(ts.marginal_prob(torch.from_numpy(t)), js.marginal_prob(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    lamb = np.linspace(-8, 8, 33).astype(np.float32)
    np.testing.assert_allclose(
        ts.inverse_lambda(torch.from_numpy(lamb)).numpy(),
        np.asarray(js.inverse_lambda(jnp.asarray(lamb))), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(make_time_steps(ts, 10).numpy(),
                               np.asarray(jax_time_steps(js, 10)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("self_cond_type", ["ori", "clamp"])
def test_scalers_match_jax(self_cond_type):
    cfg, pcfg = smoke.get_config(), configs.get_smoke_config()
    cfg.model.self_cond_type = pcfg.model.self_cond_type = self_cond_type
    rng = np.random.default_rng(4)
    nm, em = (np.array(a) for a in JM.build_masks(jnp.asarray([5, 3]), 5))
    x = rng.normal(size=(2, 5, 9)).astype(np.float32)
    e = rng.normal(size=(2, 5, 5, 2)).astype(np.float32)
    want = jsc.get_self_cond_fn(cfg)(jnp.asarray(x), jnp.asarray(e))
    got = tsc.get_self_cond_fn(pcfg)(torch.from_numpy(x), torch.from_numpy(e))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    args = (x[..., :3], x[..., 3:8], x[..., 8:], nm, e, em)
    want = jsc.get_data_inverse_scaler(cfg)(*map(jnp.asarray, args))
    got = tsc.get_data_inverse_scaler(pcfg)(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_masks_and_edge_quantisation_match_jax():
    n_nodes = np.array([4, 6, 1])
    for got, want in zip(M.build_masks(torch.from_numpy(n_nodes), 6),
                         JM.build_masks(jnp.asarray(n_nodes), 6)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(3, 6, 3)).astype(np.float32)
    nm, em = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), 6))
    for got, want in zip(M.coord2diff_adj_dense(torch.from_numpy(pos), torch.from_numpy(em)),
                         JM.coord2diff_adj_dense(jnp.asarray(pos), jnp.asarray(em))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        M.remove_mean_with_mask(torch.from_numpy(pos), torch.from_numpy(nm)).numpy(),
        np.asarray(JM.remove_mean_with_mask(jnp.asarray(pos), jnp.asarray(nm))),
        rtol=1e-6, atol=1e-6,
    )
    gen = torch.Generator().manual_seed(0)
    noise = M.sample_symmetric_edge_feature_noise(gen, 3, 6, 2, torch.from_numpy(em))
    torch.testing.assert_close(noise, noise.transpose(1, 2))
    assert (noise[torch.from_numpy(em) == 0] == 0).all()
    xn = M.sample_combined_position_feature_noise(gen, 3, 6, 6, torch.from_numpy(nm))
    assert xn[..., :3].sum(1).abs().max() < 1e-5 and (xn[torch.from_numpy(nm[..., 0]) == 0] == 0).all()
    h = rng.uniform(-0.2, 1.2, size=(2, 5, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tdec.quantize_edges(torch.from_numpy(h)).numpy(),
        np.asarray(jdec.quantize_edges(jnp.asarray(h), compress_edge=True)),
    )


def test_three_channel_edge_quantisation_matches_jax():
    """With the aromatic channel (``data.include_aromatic``, ``model.edge_ch
    = 3``) an existing pair whose aromatic channel reaches 0.5 and which has
    no other order decodes as 4, as JAX's decode gives it."""
    h = np.random.default_rng(5).uniform(0, 1, size=(2, 5, 5, 3)).astype(np.float32)
    got = tdec.quantize_edges(torch.from_numpy(h)).numpy()
    want = np.asarray(jdec.quantize_edges(jnp.asarray(h), compress_edge=True))
    np.testing.assert_array_equal(got, want)
    assert (want == 4).sum() > 0


def test_aromatic_model_samples_and_decodes_like_jax():
    """A narrow DMT with the third edge channel: 10 ancestral steps at
    temperature 0 from a shared ``z_T``, decoded, against JAX."""
    steps, n, n_nodes = 10, 8, [8, 6, 8, 7]
    bs = len(n_nodes)
    pcfg = configs.apply_overrides(configs.get_smoke_config(), {
        **OVERRIDES, "data.include_aromatic": True, "model.edge_ch": 3})
    port = DMT.from_config(pcfg)
    flat = random_variables(port, seed=4)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    cfg = smoke.get_config()
    cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads, cfg.model.edge_ch = 32, 2, 4, 3
    cfg.data.max_node, cfg.data.include_aromatic = n, True
    model = JaxDMT.from_config(cfg)

    rng = np.random.default_rng(1)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    z = rng.normal(size=(bs, n, 9)).astype(np.float32) * node_mask
    z[..., :3] -= z[..., :3].sum(1, keepdims=True) / node_mask.sum(1, keepdims=True) * node_mask
    e = np.tril(rng.normal(size=(bs, n, n, 3)).astype(np.float32).transpose(0, 3, 1, 2), -1)
    edge_z = (e + e.transpose(0, 1, 3, 2)).transpose(0, 2, 3, 1) * edge_mask[..., None]
    spec = np.log10(np.abs(rng.normal(size=(bs, 3501))).astype(np.float32) * 10 + 1)

    jsch = JaxSchedule(cfg.sde.schedule)
    jsampler = JaxSampler(jsch, jax_time_steps(jsch, steps), cfg.model.pred_data,
                          pred_edge=True, self_cond=True,
                          cond_process_fn=jsc.get_self_cond_fn(cfg), sampling_temperature=0.0)

    def model_apply(t, x, nm, em, edge_x, nl, cond_x, cond_edge_x, has_cond, c_emb):
        return model.apply(variables, t, x, nm, em, None, edge_x=edge_x, noise_level=nl,
                           cond_x=cond_x, cond_edge_x=cond_edge_x, has_cond=has_cond,
                           context_emb=c_emb)

    ctx = jax_encode_context(model, variables, jnp.asarray(spec))
    jx, je = jax.jit(lambda z_, e_: jsampler.sampling(
        model_apply, jax.random.PRNGKey(0), z_, jnp.asarray(node_mask),
        jnp.asarray(edge_mask), e_, ctx))(jnp.asarray(z), jnp.asarray(edge_z))
    jout = jdec.post_process(jx, 5, True, jnp.asarray(node_mask),
                             jsc.get_data_inverse_scaler(cfg), je, jnp.asarray(edge_mask),
                             compress_edge=True)
    jmols = jdec.mol_process(jout[1], jout[0], jout[2], np.asarray(n_nodes), jout[3])

    sch = NoiseScheduleVP(pcfg.sde.schedule)
    sampler = AncestralSampler(sch, make_time_steps(sch, steps), pcfg.model.pred_data,
                               self_cond=True, cond_process_fn=tsc.get_self_cond_fn(pcfg),
                               sampling_temperature=0.0)
    T = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        tctx = port.encode_context([T(spec)])
        tx, te = sampler.sampling(port, torch.Generator().manual_seed(0), T(z), T(node_mask),
                                  T(edge_mask), T(edge_z), tctx)
    tout = tdec.post_process(tx, 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg), te,
                             T(edge_mask))
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])

    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2e-3)
    assert len(tmols) == len(jmols) == bs
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)
