"""DMT_WO_EQ, the non-equivariant ablation, against the JAX package on the
CPU: the model registry, the parameter trees, the forward of each
``trans_ver`` in float32 and bfloat16, the graph loss and its gradients,
the remat policies, both samplers with the decode, and training then
serving from the workdir. Inputs come from numpy seeds; JAX runs on XLA
(the model has no Pallas kernel).

- The registry: ``create_model`` builds the model ``model.name`` names
  (``CDGS`` too: no registered model is left unported); an unknown name
  raises and lists the registered ones; the config keys take the JAX
  config's defaults.
- The parameter trees of ``'v1'``, ``'v2'``, ``'optim'``,
  ``cond_time=False`` and ``dist_gbf=False`` + ``GaussianLayer``: equal to
  JAX's ``model.init`` (names and shapes); JAX's init loads strictly and
  comes back unchanged; the port's fresh init has the same leaves.
- The narrow model (nf=64, 4 blocks, 8 heads, N <= 8) of each
  ``trans_ver``, with and without self-conditioning, against JAX's jitted
  forward in float32: rtol = atol = 2e-4 (measured at most 3.4e-6 of the
  largest value).
- bfloat16. Each attention form (``DenseTransLayer``) and each block
  (``DMTWoEqBlock``, with and without ``cond_time``) against flax's jitted
  module on the same inputs: within half of the module's own
  bfloat16-against-float32 gap (measured: each attention form bit for bit,
  a block at most 6e-4: a value next to a bfloat16 rounding falls the
  other way now and then, where a float32 sum ahead of it runs in another
  order than XLA's). The whole narrow model cannot be held to half of that
  gap, as ``tests/test_torch_bf16.py`` holds the DMT: its embeddings, time
  MLPs and residuals are float32 (the DMT's are bfloat16 products), so
  float32 sums in another order than XLA's move values ahead of each
  rounding to bfloat16 by a float32 step, and 4 blocks carry the flipped
  roundings on. Measured max |port - JAX bf16| / max |JAX bf16 - JAX f32|:
  0.11-1.13 on this test's six forwards, 0.13-1.06 over three of JAX's
  inits of each ``trans_ver``; JAX's own eager forward against its jitted
  one reads 0.10-0.71 on those models. The whole model is held instead to
  JAX's bfloat16 precision: max |port bf16 - JAX f32| between 0.5 and 1.5
  times max |JAX bf16 - JAX f32| (measured 0.99-1.20), each output finite,
  which a missing or an extra rounding to bfloat16 moves out of the band.
- Training, float32, nf=32, 2 blocks, ``noise_align`` on: the graph loss
  and every gradient of each ``trans_ver`` against JAX's jitted loss on
  JAX's draws (the translation kept, the clean positions aligned through
  ``get_align_position_v2`` on both centred sets): the loss within 2e-5
  relative, each gradient within 1e-4 of the largest, as
  ``tests/test_torch_train.py`` holds the DMT. ``'full'``, ``'dots'`` and
  ``'none'`` give the same loss and gradients (1e-6 relative), dropout on.
- Sampling, float32: 10 ancestral and 10 DPM-Solver++ steps at
  ``sampling_temperature=0`` from a shared ``z_T``, decoded: states within
  2e-3, the decoded molecules equal.
- ``run_lib.train`` for 3 steps, then ``Elucidator.from_workdir`` and
  ``from_warm_state(overrides={"model.name": "DMT_WO_EQ"})`` serve the
  candidates of the live EMA weights.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.models import dmt_wo_eq as jwo
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.models.dmt import encode_context_train
from diffspectra_tpu.sampling import decode as jdec
from diffspectra_tpu.sampling.ancestral import AncestralSampler as JaxAncestral
from diffspectra_tpu.sampling.ancestral import make_time_steps as jax_time_steps
from diffspectra_tpu.sampling.dpm_solver import DPMSolverPP as JaxDPM
from diffspectra_tpu.training.step import _make_apply_fn, make_loss_fn
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu.utils import scalers as jsc
from diffspectra_tpu_torch import checkpoint as ckpt
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.models import dmt_wo_eq as pwo
from diffspectra_tpu_torch.models.cdgs import CDGS
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.sampling import decode as tdec
from diffspectra_tpu_torch.sampling.ancestral import AncestralSampler, make_time_steps
from diffspectra_tpu_torch.sampling.dpm_solver import DPMSolverPP
from diffspectra_tpu_torch.training.losses import get_sde_graph_loss_fn
from diffspectra_tpu_torch.training.step import load_ema_weights
from diffspectra_tpu_torch.training.train_state import params_of
from diffspectra_tpu_torch.utils import scalers as tsc
from diffspectra_tpu_torch.utils.registry import NOT_PORTED, create_model, get_model_cls
from diffspectra_tpu_torch.warm_state import (
    flax_variables,
    init_variables,
    load_model_state,
    params_from_flax,
    random_variables,
)
from test_torch_dmt import _inputs, _jax_forward, _torch_forward
from test_torch_train import _batch, _jax_batch, _port_batch
from test_torch_variants import _configs, _draws, _jax_schedule, _variables

torch.set_num_threads(2)

TRANS_VERS = ("v1", "v2", "optim")
WO_EQ = {"model.name": "DMT_WO_EQ"}
NARROW = {**WO_EQ, "model.nf": 64, "model.n_layers": 4, "model.n_heads": 8, "data.max_node": 8}
SMALL = {**WO_EQ, "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 6}


def _jax_init(model, n=8, bs=2, feat=6, spec=3501):
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((bs,)), jnp.zeros((bs, n, 3 + feat)),
        jnp.ones((bs, n, 1)), jnp.ones((bs, n, n)), jnp.ones((bs, spec)),
        edge_x=jnp.zeros((bs, n, n, 2)), noise_level=jnp.zeros((bs,)))
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(variables), sep="/").items()}


# ---- the registry -------------------------------------------------------------

def test_registry_builds_the_named_model_and_refuses_others():
    config = configs.get_smoke_config()
    jax_model = diffspectra_qm9s.get_config().model
    assert (config.model.name, config.model.trans_ver, config.model.specformer_bf16) == (
        jax_model.name, jax_model.get("trans_ver", "v2"), jax_model.specformer_bf16)
    assert type(create_model(config)) is DMT
    config.model.name = "DMT_WO_EQ"
    model = create_model(config)
    assert type(model) is pwo.DMT_WO_EQ and get_model_cls("DMT_WO_EQ") is pwo.DMT_WO_EQ
    assert len(model.blocks) == config.model.n_layers
    with pytest.raises(ValueError,
                       match=r"Unknown model 'GNN'; registered: \['CDGS', 'DMT', 'DMT_WO_EQ'\]"):
        get_model_cls("GNN")
    assert not NOT_PORTED
    cdgs = create_model(configs.apply_overrides(copy.deepcopy(config), {"model.name": "CDGS"}))
    assert type(cdgs) is CDGS and get_model_cls("CDGS") is CDGS
    with pytest.raises(ValueError, match="unknown trans_ver"):
        create_model(configs.apply_overrides(config, {"model.name": "DMT_WO_EQ",
                                                      "model.trans_ver": "v3"}))
    with pytest.raises(ValueError, match="remat_policy"):
        create_model(configs.apply_overrides(config, {"model.trans_ver": "v2",
                                                      "model.remat_policy": "some"}))


# ---- the parameter trees ----------------------------------------------------------

TREES = {
    "v1": {"model.trans_ver": "v1"},
    "v2": {"model.trans_ver": "v2"},
    "optim": {"model.trans_ver": "optim"},
    "cond_time_off": {"model.cond_time": False},
    "dist_gbf_off_gaussian": {"model.dist_gbf": False, "model.gbf_name": "GaussianLayer"},
}


@pytest.mark.parametrize("variant", sorted(TREES))
def test_parameter_tree_matches_jax_init_and_carries_across(variant):
    jcfg, pcfg = _configs({**NARROW, **TREES[variant]})
    want = _jax_init(jwo.DMT_WO_EQ.from_config(jcfg))
    port = create_model(pcfg)
    assert {k: v.shape for k, v in flax_variables(port).items()} == {
        k: v.shape for k, v in want.items()}
    load_model_state(port, want)
    got = flax_variables(port)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    fresh = init_variables(create_model(pcfg), seed=0)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in want.items()}
    if variant == "cond_time_off":  # the affine LayerNorms and no time MLPs
        assert "params/blocks/dmt_block/norm1_node/scale" in want
        assert not any("time_mlp" in k for k in want)
    # the position head has no biases
    assert "params/pos_pred_mlp_0/bias" not in want and "params/pos_pred_mlp_1/bias" not in want


# ---- forwards ---------------------------------------------------------------------

def _narrow_forward(tv, precision, has_cond, flat=None):
    jcfg, pcfg = _configs({**NARROW, "model.trans_ver": tv,
                           "training.matmul_precision": precision})
    port = create_model(pcfg)
    flat = random_variables(port, seed=0) if flat is None else flat
    load_model_state(port, flat)
    inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 9, [3501], has_cond)
    model = jwo.DMT_WO_EQ.from_config(jcfg)
    return flat, _torch_forward(port, inp, has_cond), _jax_forward(
        model, _variables(flat), inp, has_cond, jit=True)


@pytest.mark.parametrize("has_cond", [True, False])
@pytest.mark.parametrize("tv", TRANS_VERS)
def test_narrow_forward_matches_jax(tv, has_cond):
    flat, got32, want32 = _narrow_forward(tv, "float32", has_cond)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    _, got16, want16 = _narrow_forward(tv, "bfloat16", has_cond, flat)
    for g, w16, w32 in zip(got16, want16, want32):
        assert np.isfinite(g).all()
        own = np.abs(g - w32).max() / np.abs(w16 - w32).max()
        assert 0.5 <= own <= 1.5, (tv, has_cond, own,
                                   np.abs(g - w16).max() / np.abs(w16 - w32).max())


def _module_inputs(seed=0, B=4, N=8, D=64, De=16, T=256):
    rng = np.random.default_rng(seed)
    node_mask = np.ones((B, N, 1), np.float32)
    node_mask[0, 6:] = 0
    node_mask[2, 5:] = 0
    edge_mask = node_mask * node_mask.transpose(0, 2, 1) * (1 - np.eye(N, dtype=np.float32))
    return dict(h=rng.normal(size=(B, N, D)).astype(np.float32),
                e=rng.normal(size=(B, N, N, De)).astype(np.float32), node_mask=node_mask,
                edge_mask=edge_mask, t=rng.normal(size=(B, T)).astype(np.float32))


def _nonzero_biases(variables, seed=1):
    """flax's init with its zero biases and unit scales moved, so that they
    count."""
    rng = np.random.default_rng(seed)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(variables["params"],
                                                                   sep=".").items()}
    flat = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.3 if v.ndim == 1 else v)
            for k, v in flat.items()}
    return flat, {"params": traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})}


def _module_pair(kind, tv, cond_time, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    if kind == "attention":
        return (jwo.DenseTransLayer(64, 8, trans_ver=tv, dtype=jdt),
                pwo.DenseTransLayer(64, 16, 8, trans_ver=tv, dtype=tdt))
    return (jwo.DMTWoEqBlock(64, 16, 256, 8, cond_time=cond_time, trans_ver=tv, dtype=jdt),
            pwo.DMTWoEqBlock(64, 16, 256, 8, cond_time=cond_time, trans_ver=tv, dtype=tdt))


def _run_module(kind, tv, cond_time, dtype, inp):
    jmod, port = _module_pair(kind, tv, cond_time, dtype)
    h, e, nm, em = (inp[k] for k in ("h", "e", "node_mask", "edge_mask"))
    t = inp["t"] if cond_time else None
    if kind == "attention":
        args = (h, e, em)
    else:
        args = (h, e, nm, em, t, t)
    flat, variables = _nonzero_biases(jmod.init(jax.random.PRNGKey(0), *args))
    want = jax.jit(lambda v: jmod.apply(v, *args))(variables)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    T = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        if kind == "attention":
            got = port(T(h), T(e), T(em))
        else:
            got = port(T(h), T(e), T(nm), T(em), T(t))
    as_list = lambda x: [x] if not isinstance(x, (tuple, list)) else list(x)
    return ([np.asarray(w) for w in as_list(want)], [g.float().numpy() for g in as_list(got)])


MODULES = [("attention", tv, True) for tv in TRANS_VERS] + [
    ("block", tv, ct) for tv in TRANS_VERS for ct in (True, False)]


@pytest.mark.parametrize("kind,tv,cond_time", MODULES)
def test_bf16_attention_and_block_match_flax_on_the_same_inputs(kind, tv, cond_time):
    inp = _module_inputs()
    want32, got32 = _run_module(kind, tv, cond_time, "f32", inp)
    want16, got16 = _run_module(kind, tv, cond_time, "bf16", inp)
    for g32, w32, g16, w16 in zip(got32, want32, got16, want16):
        np.testing.assert_allclose(g32, w32, rtol=2e-5, atol=2e-5)
        err, gap = np.abs(g16 - w16).max(), np.abs(w16 - w32).max()
        assert np.isfinite(g16).all() and gap > 0 and err <= 0.5 * gap, (err, gap, err / gap)


# ---- training -----------------------------------------------------------------------

@pytest.mark.parametrize("tv", TRANS_VERS)
def test_graph_loss_and_gradients_match_jax(tv):
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    try:
        jcfg, pcfg = _configs({**SMALL, "model.trans_ver": tv})
        assert pcfg.model.noise_align and jcfg.model.noise_align
        batch = _batch(1)
        batch["positions"] = batch["positions"] + 0.3 * batch["atom_mask"][..., None]  # off-centre
        port = create_model(pcfg)
        flat = random_variables(port, seed=2)
        load_model_state(port, flat)
        variables = _variables(flat)
        model = jwo.DMT_WO_EQ.from_config(jcfg)
        loss_fn = make_loss_fn(_jax_schedule(jcfg), jsc.get_data_scaler(jcfg), jcfg)

        def wrapped(params, key):
            apply_fn = _make_apply_fn(model, params, train=True)
            apply_fn.encode = lambda r, stats, ctx: encode_context_train(
                model, params, stats, ctx, r)
            return loss_fn(apply_fn, variables["batch_stats"], _jax_batch(batch), key)

        grad_fn = jax.jit(jax.value_and_grad(wrapped, has_aux=True))
        port_loss = get_sde_graph_loss_fn(NoiseScheduleVP.from_config(pcfg),
                                          tsc.get_data_scaler(pcfg), pcfg)
        port.train()
        params = params_of(port)
        seen = set()
        for i in range(40):  # a key with the self-conditioning coin each way
            key = jax.random.PRNGKey(3000 + i)
            draws = _draws(key, batch, 6)
            if draws["use_sc"] in seen:
                continue
            seen.add(draws["use_sc"])
            (want, _), want_grads = grad_fn(variables["params"], key)
            want_grads = params_from_flax({f"params/{p}": np.asarray(v) for p, v in
                                           traverse_util.flatten_dict(jax.device_get(want_grads),
                                                                      sep="/").items()})
            load_model_state(port, flat)  # the batch statistics of the last forward undone
            loss = port_loss(port, _port_batch(batch), draws)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)
            assert set(params) == set(want_grads)
            scale = max(float(g.abs().max()) for g in want_grads.values())
            for (name, p), g in zip(params.items(), grads):
                g = np.zeros(p.shape, np.float32) if g is None else g.numpy()
                np.testing.assert_allclose(g, want_grads[name].numpy(), rtol=0,
                                           atol=1e-4 * scale, err_msg=name)
            if len(seen) == 2:
                break
        assert seen == {True, False}
    finally:
        jax.config.update("jax_default_prng_impl", prev)


def test_remat_policies_give_the_same_loss_and_gradients():
    _, pcfg = _configs({**SMALL, "model.dropout": 0.1})
    batch = _port_batch(_batch(2))
    draws = {"t": torch.full((4,), 0.4), "use_sc": True, "seeds": list(range(1, 6))}
    gen = torch.Generator().manual_seed(0)
    draws["noise"] = torch.randn((4, 6, 9), generator=gen) * batch["atom_mask"][..., None]
    edge = torch.randn((4, 6, 6, 2), generator=gen)
    draws["edge_noise"] = (edge + edge.transpose(1, 2)) * batch["edge_mask"][..., None]
    out = {}
    for policy in ("full", "dots", "none"):
        pcfg.model.remat_policy = policy
        model = create_model(pcfg)
        load_model_state(model, init_variables(model, seed=0))
        params = params_of(model.train())
        loss = get_sde_graph_loss_fn(NoiseScheduleVP.from_config(pcfg),
                                     tsc.get_data_scaler(pcfg), pcfg)(model, batch, draws)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out[policy] = loss.item(), dict(zip(params, grads))
    loss, grads = out["none"]
    scale = max(float(g.abs().max()) for g in grads.values() if g is not None)
    for policy in ("full", "dots"):
        np.testing.assert_allclose(out[policy][0], loss, rtol=1e-6)
        for name, g in grads.items():
            other = out[policy][1][name]
            assert (g is None) == (other is None), name
            if g is not None:
                np.testing.assert_allclose(other.numpy(), g.numpy(), rtol=1e-6,
                                           atol=1e-6 * scale, err_msg=name)


# ---- sampling and decode -------------------------------------------------------------

@pytest.mark.parametrize("method", ["ancestral", "dpm_solver"])
@pytest.mark.parametrize("tv", TRANS_VERS)
def test_sampling_and_decode_match_jax(tv, method):
    steps, n, n_nodes = 10, 8, [8, 6, 8, 5]
    bs = len(n_nodes)
    jcfg, pcfg = _configs({**SMALL, "data.max_node": n, "model.trans_ver": tv})
    port = create_model(pcfg)
    flat = random_variables(port, seed=3)
    load_model_state(port, flat)
    variables = _variables(flat)
    model = jwo.DMT_WO_EQ.from_config(jcfg)

    rng = np.random.default_rng(0)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    z = rng.normal(size=(bs, n, 9)).astype(np.float32) * node_mask
    z[..., :3] -= z[..., :3].sum(1, keepdims=True) / node_mask.sum(1, keepdims=True) * node_mask
    e = np.tril(rng.normal(size=(bs, n, n, 2)).astype(np.float32).transpose(0, 3, 1, 2), -1)
    edge_z = (e + e.transpose(0, 1, 3, 2)).transpose(0, 2, 3, 1) * edge_mask[..., None]
    spec = np.log10(np.abs(rng.normal(size=(bs, 3501))).astype(np.float32) * 10 + 1)

    jsch = _jax_schedule(jcfg)
    kw = dict(self_cond=True, cond_process_fn=jsc.get_self_cond_fn(jcfg),
              sampling_temperature=0.0)
    jsampler = (JaxAncestral if method == "ancestral" else JaxDPM)(
        jsch, jax_time_steps(jsch, steps), jcfg.model.pred_data, pred_edge=True, **kw)

    def model_apply(t, x, nm, em, edge_x, nl, cond_x, cond_edge_x, has_cond, c_emb):
        return model.apply(variables, t, x, nm, em, None, edge_x=edge_x, noise_level=nl,
                           cond_x=cond_x, cond_edge_x=cond_edge_x, has_cond=has_cond,
                           context_emb=c_emb)

    ctx = jax_encode_context(model, variables, jnp.asarray(spec))
    jx, je = jax.jit(lambda z_, e_: jsampler.sampling(
        model_apply, jax.random.PRNGKey(0), z_, jnp.asarray(node_mask),
        jnp.asarray(edge_mask), e_, ctx))(jnp.asarray(z), jnp.asarray(edge_z))
    jout = jdec.post_process(jx, 5, True, jnp.asarray(node_mask),
                             jsc.get_data_inverse_scaler(jcfg), je, jnp.asarray(edge_mask),
                             compress_edge=True)
    jmols = jdec.mol_process(jout[1], jout[0], jout[2], np.asarray(n_nodes), jout[3])

    sch = NoiseScheduleVP.from_config(pcfg)
    kw = dict(self_cond=True, cond_process_fn=tsc.get_self_cond_fn(pcfg),
              sampling_temperature=0.0)
    sampler = (AncestralSampler if method == "ancestral" else DPMSolverPP)(
        sch, make_time_steps(sch, steps), pcfg.model.pred_data, **kw)
    T = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        tctx = port.encode_context([T(spec)])
        tx, te = sampler.sampling(port, torch.Generator().manual_seed(0), T(z), T(node_mask),
                                  T(edge_mask), T(edge_z), tctx)
    tout = tdec.post_process(tx, 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg), te,
                             T(edge_mask))
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2e-3)
    assert len(tmols) == len(jmols) == bs
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)


# ---- train, then serve ------------------------------------------------------------------

def test_train_then_serve_from_the_workdir_and_the_export(tmp_path):
    over = {**SMALL, "data.max_node": 8, "data.synthetic_size": 96, "optim.warmup": 2,
            "sampling.steps": 4, "training.batch_size": 4, "training.n_iters": 2,
            "training.log_freq": 1, "training.snapshot_freq": 2,
            "training.snapshot_freq_for_preemption": 100, "training.snapshot_sampling": False,
            "model.trans_ver": "optim"}
    _, config = _configs(over)
    workdir = str(tmp_path / "run")
    state = run_lib.train(config, workdir, "cpu")
    assert state.step == 3 and ckpt.latest_numbered_checkpoint(workdir) == 1
    assert type(state.model) is pwo.DMT_WO_EQ

    data = generate(seed=7, size=1, max_n=8, fidelity=4)
    n_atoms = int(data["num_atom"][0])
    live = Elucidator(config, load_ema_weights(state, create_model(config)), torch.device("cpu"))
    base = configs.apply_overrides(configs.get_smoke_config(), {
        k: v for k, v in over.items() if k != "model.name"})
    servers = [live, Elucidator.from_workdir(workdir, config, device="cpu"),
               Elucidator.from_warm_state(str(tmp_path / "run" / "warm_state.npz"), base,
                                          overrides={"model.name": "DMT_WO_EQ"},
                                          device="cpu")]
    results = [el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=3, seed=0)
               for el in servers]
    assert sum(c.count for c in results[0].candidates) == 3
    for result in results[1:2]:  # the checkpoint holds the float32 EMA weights
        assert len(result.candidates) == len(results[0].candidates)
        for got, want in zip(result.candidates, results[0].candidates):
            assert got.molgraph.wl_hash() == want.molgraph.wl_hash()
            assert got.count == want.count and got.first_draw == want.first_draw
            np.testing.assert_array_equal(got.positions, want.positions)
    # the export holds them in bfloat16: the same model, served
    assert type(servers[2].model) is pwo.DMT_WO_EQ
    assert sum(c.count for c in results[2].candidates) == 3
