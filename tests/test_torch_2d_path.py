"""The 2-D path (``only_2D``: CDGS, atoms and bonds, no positions) and the
node loss (``pred_edge=False``) against the JAX package on the CPU: the
losses, a train step, both samplers, the decode without positions,
serving, and training then the sweep through ``run_lib``. Inputs come from
numpy seeds.

- The 2-D loss of the narrow CDGS (nf 32, 2 blocks) on JAX's draws, in
  training mode: the loss within 1e-5 relative, each gradient within 1e-4
  of the largest, for the smoke-2d config (noise prediction) and with data
  prediction, self-conditioning (the coin each way) and ``reduce_mean``;
  then one train step of each package from the same state: params, EMA
  and batch statistics within 1e-6 (the noise-only biases within twice the
  learning rate), the moments within 1e-4 of their largest.
- The node loss, which no JAX model runs (its DMT raises on the zero-width
  edges it passes), through a stand-in model function of a few weights:
  the loss within 1e-5 relative and the weights' gradients within 1e-5 of
  the largest, for noise and data prediction, noise alignment on and off,
  self-conditioning and ``reduce_mean``.
- The samplers' ``pred_edge=False`` branch through a stand-in (ancestral,
  DPM-Solver++ ODE and SDE at temperature 0, with and without ``only_2d``,
  self-conditioned): the final nodes within 1e-5 of the largest (noise
  prediction through the stand-in grows them to a few hundred). Their ``only_2d`` branch
  with the narrow CDGS, 10 steps at temperature 0 from a shared ``z_T``:
  the states within 1e-4, the decoded molecules (no positions) equal.
- ``post_process``/``mol_process`` without positions on random tensors:
  equal to JAX's.
- ``run_lib.train`` at the sizes of JAX's ``tests/test_2d_run_lib.py``,
  then ``Elucidator.from_workdir`` (no positions, each sampler) and
  ``evaluate_checkpoints``: the figure names of the log equal JAX's run of
  the same config, no 3D figure logged or returned, the snapshot's sample
  xyz files none and its targets' as JAX writes them.
"""

import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu import run_lib as jax_run_lib
from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.diffusion import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.models import cdgs as jc
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.models.dmt import encode_context_train
from diffspectra_tpu.sampling import decode as jdec
from diffspectra_tpu.sampling.ancestral import AncestralSampler as JaxAncestral
from diffspectra_tpu.sampling.ancestral import make_time_steps as jax_time_steps
from diffspectra_tpu.sampling.dpm_solver import DPMSolverPP as JaxDPM
from diffspectra_tpu.training import optim as jax_optim
from diffspectra_tpu.training.step import _make_apply_fn, make_loss_fn
from diffspectra_tpu.training.step import get_step_fn as jax_step_fn
from diffspectra_tpu.training.train_state import create_train_state as jax_create_train_state
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu.utils import scalers as jsc
from diffspectra_tpu_torch import checkpoint as ckpt
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.sampling import decode as tdec
from diffspectra_tpu_torch.sampling.ancestral import AncestralSampler, make_time_steps
from diffspectra_tpu_torch.sampling.dpm_solver import DPMSolverPP
from diffspectra_tpu_torch.training import optim
from diffspectra_tpu_torch.training.losses import T_EPS
from diffspectra_tpu_torch.training.step import get_step_fn, make_loss_fn as port_loss_fn
from diffspectra_tpu_torch.training.train_state import params_of
from diffspectra_tpu_torch.utils import scalers as tsc
from diffspectra_tpu_torch.utils.registry import create_model
from diffspectra_tpu_torch.warm_state import (
    load_model_state,
    params_from_flax,
    random_variables,
    train_state_from_flax,
)
from test_torch_cdgs import NARROW, cdgs_configs, jax_variables
from test_torch_train import _batch, _compare_states, _jax_batch, _port_batch

torch.set_num_threads(2)

SMALL = {**NARROW, "data.max_node": 6}


@pytest.fixture(autouse=True)
def threefry():
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


def draws_2d(key, batch, feat=5):
    """The draws of JAX's 2-D loss for the step key ``key``."""
    node_mask = jnp.asarray(batch["atom_mask"])[..., None]
    bs, n = batch["atom_mask"].shape
    _, k_t, k_noise, k_edge, k_sc = jax.random.split(key, 5)
    t = jax.random.uniform(k_t, (bs,)) * (1.0 - T_EPS) + T_EPS
    noise = JM.sample_gaussian_with_mask(k_noise, (bs, n, feat), node_mask)
    edge = JM.sample_symmetric_edge_feature_noise(k_edge, bs, n, 2, jnp.asarray(batch["edge_mask"]))
    return dict(t=torch.tensor(np.asarray(t)), noise=torch.tensor(np.asarray(noise)),
                edge_noise=torch.tensor(np.asarray(edge)),
                use_sc=bool(jax.random.bernoulli(k_sc, 0.5)), seeds=None)


def _jax_apply(model, params, jcfg):
    """JAX's train-mode apply, with the one-encoding hook its step sets
    where the spectra are reused for self-conditioning."""
    apply_fn = _make_apply_fn(model, params, train=True)
    if jcfg.model.self_cond and jcfg.model.reuse_cond_emb:
        apply_fn.encode = lambda r, stats, ctx: encode_context_train(model, params, stats, ctx, r)
    return apply_fn


LOSS_VARIANTS = {
    "smoke_2d": {},
    "data_sc_mean": {"model.pred_data": True, "model.self_cond": True,
                     "training.reduce_mean": True},
}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
def test_2d_loss_and_gradients_match_jax(variant):
    jcfg, pcfg = cdgs_configs({**SMALL, **LOSS_VARIANTS[variant]})
    assert jcfg.only_2D and pcfg.only_2D
    batch = _batch(1)
    port = create_model(pcfg)
    flat = random_variables(port, seed=2)
    load_model_state(port, flat)
    variables = jax_variables(flat)
    model = jc.CDGS.from_config(jcfg)
    loss_fn = make_loss_fn(JaxSchedule(jcfg.sde.schedule), jsc.get_data_scaler(jcfg), jcfg)

    def wrapped(params, key):
        apply_fn = _jax_apply(model, params, jcfg)
        return loss_fn(apply_fn, variables["batch_stats"], _jax_batch(batch), key)

    grad_fn = jax.jit(jax.value_and_grad(wrapped, has_aux=True))
    port_loss = port_loss_fn(NoiseScheduleVP.from_config(pcfg), tsc.get_data_scaler(pcfg), pcfg)
    params = params_of(port.train())
    coins = {True, False} if pcfg.model.self_cond else {False}
    seen = set()
    for i in range(40):
        key = jax.random.PRNGKey(500 + i)
        draws = draws_2d(key, batch)
        if draws["use_sc"] in seen or (draws["use_sc"] and not pcfg.model.self_cond):
            continue
        seen.add(draws["use_sc"])
        (want, _), want_grads = grad_fn(variables["params"], key)
        want_grads = params_from_flax({f"params/{p}": np.asarray(v) for p, v in
                                       traverse_util.flatten_dict(jax.device_get(want_grads),
                                                                  sep="/").items()})
        load_model_state(port, flat)  # the batch statistics of the last forward undone
        loss = port_loss(port, _port_batch(batch), draws)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        assert set(params) == set(want_grads)
        scale = max(float(g.abs().max()) for g in want_grads.values())
        for (name, p), g in zip(params.items(), grads):
            g = np.zeros(p.shape, np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(g, want_grads[name].numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
        if seen == coins:
            break
    assert seen == coins


def test_2d_train_step_matches_jax():
    jcfg, pcfg = cdgs_configs(SMALL)
    batch = _batch(3)
    model = jc.CDGS.from_config(jcfg)
    bs, n = batch["atom_mask"].shape
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((bs,)), jnp.zeros((bs, n, 5)),
        jnp.asarray(batch["atom_mask"])[..., None], jnp.asarray(batch["edge_mask"]),
        jnp.asarray(batch["context"]), edge_x=jnp.zeros((bs, n, n, 2)))
    jtx = jax_optim.get_optimizer(jcfg)
    jstate = jax_create_train_state(variables, jtx, jcfg.model.ema_decay)
    tx = optim.get_optimizer(pcfg)
    state = train_state_from_flax(jax.device_get(jstate), create_model(pcfg), tx)
    step = jax.jit(jax_step_fn(JaxSchedule(jcfg.sde.schedule), model, jtx,
                               jsc.get_data_scaler(jcfg), jcfg))
    pstep = get_step_fn(NoiseScheduleVP.from_config(pcfg), tx, tsc.get_data_scaler(pcfg), pcfg)
    key = jax.random.PRNGKey(7)
    jstate, want = step(jstate, _jax_batch(batch), key)
    state, loss = pstep(state, _port_batch(batch), draws_2d(key, batch))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _compare_states(state, jstate, optim.lr_at(pcfg, 0))


# ---- the node loss -------------------------------------------------------------------

NODE_VARIANTS = {
    "noise_aligned": {"model.pred_data": False, "model.noise_align": True,
                      "model.self_cond": False},
    "noise_mean": {"model.pred_data": False, "model.noise_align": False,
                   "model.self_cond": False, "training.reduce_mean": True},
    "data_aligned_sc": {"model.pred_data": True, "model.noise_align": True,
                        "model.self_cond": True},
}


def _node_configs(overrides):
    jcfg, pcfg = jax_smoke.get_config(), configs.get_smoke_config()
    jcfg.pred_edge = pcfg.pred_edge = False
    for key, value in overrides.items():
        section, leaf = key.split(".")
        setattr(getattr(jcfg, section), leaf, value)
        configs.apply_overrides(pcfg, {key: value})
    return jcfg, pcfg


def _stand_in_weights(feat, seed=0):
    rng = np.random.default_rng(seed)
    return dict(w=(rng.normal(size=(feat, feat)) / np.sqrt(feat)).astype(np.float32),
                u=(rng.normal(size=(feat, feat)) / np.sqrt(feat)).astype(np.float32),
                b=(rng.normal(size=(feat,)) * 0.1).astype(np.float32))


def _jax_stand_in(p, t, x, node_mask, noise_level, cond_x, has_cond):
    cond = jnp.asarray(has_cond, jnp.float32) * jnp.tanh(cond_x @ p["u"])
    h = x @ p["w"] + cond + (t[:, None, None] + 0.01 * noise_level[:, None, None]) * p["b"]
    return jnp.tanh(h) * node_mask


class StandIn(torch.nn.Module):
    """A model function of three weights with the models' call: the node
    prediction ``tanh(x W + has_cond tanh(cond_x U) + (t + 0.01 noise_level)
    b)``, masked; the edge prediction ``0.5 edge_x + 0.1``, masked. It
    checks the node loss's contract: zero-width edges, no ``cond_edge_x``,
    no spectra."""

    blocks = ()

    def __init__(self, weights, node_loss=False):
        super().__init__()
        self.node_loss = node_loss
        for k, v in weights.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v)))

    def forward(self, t, x, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x,
                has_cond, context_emb, dropout_seeds=None):
        if self.node_loss:
            assert edge_x.shape[-1] == 0 and cond_edge_x is None and context_emb is None
        cond = float(has_cond) * torch.tanh(cond_x @ self.u) if has_cond else 0.0
        h = x @ self.w + cond + (t[:, None, None] + 0.01 * noise_level[:, None, None]) * self.b
        edge = None if edge_x is None else (0.5 * edge_x + 0.1) * edge_mask[..., None]
        return torch.tanh(h) * node_mask, edge


@pytest.mark.parametrize("variant", sorted(NODE_VARIANTS))
def test_node_loss_matches_jax_through_a_stand_in(variant):
    jcfg, pcfg = _node_configs(NODE_VARIANTS[variant])
    batch = _batch(4)
    batch["positions"] = batch["positions"] + 0.5 * batch["atom_mask"][..., None]  # off-centre
    weights = _stand_in_weights(9)
    loss_fn = make_loss_fn(JaxSchedule(jcfg.sde.schedule), jsc.get_data_scaler(jcfg), jcfg)

    def wrapped(p, key):
        def apply_fn(rng, stats, t, z_t, node_mask, edge_mask, context, *, edge_x,
                     noise_level, cond_x, cond_edge_x, has_cond):
            assert edge_x.shape[-1] == 0 and cond_edge_x is None and context is None
            pred = _jax_stand_in(p, t, z_t, node_mask, noise_level, cond_x, has_cond)
            return (pred, None), stats

        return loss_fn(apply_fn, {}, _jax_batch(batch), key)

    grad_fn = jax.jit(jax.value_and_grad(wrapped, has_aux=True))
    port = StandIn(weights, node_loss=True).train()
    port_loss = port_loss_fn(NoiseScheduleVP.from_config(pcfg), tsc.get_data_scaler(pcfg), pcfg)
    coins = {True, False} if pcfg.model.self_cond else {False}
    seen = set()
    node_mask = jnp.asarray(batch["atom_mask"])[..., None]
    bs, n = batch["atom_mask"].shape
    for i in range(40):
        key = jax.random.PRNGKey(900 + i)
        _, k_t, k_noise, k_sc = jax.random.split(key, 4)
        use_sc = bool(jax.random.bernoulli(k_sc, 0.5))
        if use_sc in seen or (use_sc and not pcfg.model.self_cond):
            continue
        seen.add(use_sc)
        t = jax.random.uniform(k_t, (bs,)) * (1.0 - T_EPS) + T_EPS
        noise = JM.sample_combined_position_feature_noise(k_noise, bs, n, 6, node_mask)
        draws = dict(t=torch.tensor(np.asarray(t)), noise=torch.tensor(np.asarray(noise)),
                     use_sc=use_sc, seeds=None)
        (want, _), want_grads = grad_fn({k: jnp.asarray(v) for k, v in weights.items()}, key)
        loss = port_loss(port, _port_batch(batch), draws)
        grads = torch.autograd.grad(loss, [port.w, port.u, port.b], allow_unused=True)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads.values())
        for name, g in zip("wub", grads):
            g = np.zeros(weights[name].shape, np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(want_grads[name]), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
        if seen == coins:
            break
    assert seen == coins


# ---- sampling and decode ---------------------------------------------------------------

def _shared_start(seed, n_nodes, n, feat, only_2d):
    rng = np.random.default_rng(seed)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    bs = len(n_nodes)
    z = rng.normal(size=(bs, n, feat)).astype(np.float32) * node_mask
    if not only_2d:
        z[..., :3] -= z[..., :3].sum(1, keepdims=True) / node_mask.sum(1, keepdims=True) * node_mask
    e = np.tril(rng.normal(size=(bs, n, n, 2)).astype(np.float32).transpose(0, 3, 1, 2), -1)
    edge_z = (e + e.transpose(0, 1, 3, 2)).transpose(0, 2, 3, 1) * edge_mask[..., None]
    return node_mask, edge_mask, z, edge_z


SAMPLERS = {"ancestral": {}, "dpm_solver": {"stochastic": False},
            "dpm_solver_sde": {"stochastic": True}}


def _sampler_pair(method, jcfg, pcfg, steps, **kw):
    jsch, sch = JaxSchedule(jcfg.sde.schedule), NoiseScheduleVP.from_config(pcfg)
    jcls, pcls = (JaxAncestral, AncestralSampler) if method == "ancestral" else (JaxDPM,
                                                                                 DPMSolverPP)
    return (jcls(jsch, jax_time_steps(jsch, steps), jcfg.model.pred_data,
                 sampling_temperature=0.0, **SAMPLERS[method], **kw),
            pcls(sch, make_time_steps(sch, steps), pcfg.model.pred_data,
                 sampling_temperature=0.0, **SAMPLERS[method], **kw))


@pytest.mark.parametrize("only_2d", [True, False])
@pytest.mark.parametrize("method", sorted(SAMPLERS))
def test_samplers_without_edge_prediction_match_jax(method, only_2d):
    n_nodes, n = [5, 3, 6], 6
    feat = 5 if only_2d else 9
    jcfg, pcfg = _node_configs({"model.pred_data": method != "ancestral"})
    weights = _stand_in_weights(feat, seed=1)
    node_mask, edge_mask, z, edge_z = _shared_start(2, n_nodes, n, feat, only_2d)
    jsampler, sampler = _sampler_pair(method, jcfg, pcfg, 8, pred_edge=False, only_2d=only_2d,
                                      self_cond=True)
    p = {k: jnp.asarray(v) for k, v in weights.items()}

    def model_apply(t, x, nm, em, edge_x, nl, cond_x, cond_edge_x, has_cond, c_emb):
        return (_jax_stand_in(p, t, x, nm, nl, cond_x, has_cond),
                (0.5 * edge_x + 0.1) * em[..., None])

    want = jax.jit(lambda z_, e_: jsampler.sampling(
        model_apply, jax.random.PRNGKey(0), z_, jnp.asarray(node_mask), jnp.asarray(edge_mask),
        e_, None))(jnp.asarray(z), jnp.asarray(edge_z))
    T = torch.from_numpy
    got = sampler.sampling(StandIn(weights), torch.Generator().manual_seed(0), T(z),
                           T(node_mask), T(edge_mask), T(edge_z), None)
    assert isinstance(got, torch.Tensor)  # the nodes alone
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("method", sorted(SAMPLERS))
def test_2d_sampling_and_decode_match_jax(method):
    steps, n, n_nodes = 10, 8, [8, 6, 8, 5]
    bs = len(n_nodes)
    jcfg, pcfg = cdgs_configs({**NARROW, "data.max_node": n})
    port = create_model(pcfg)
    flat = random_variables(port, seed=3)
    load_model_state(port, flat)
    variables = jax_variables(flat)
    model = jc.CDGS.from_config(jcfg)
    node_mask, edge_mask, z, edge_z = _shared_start(0, n_nodes, n, 5, True)
    spec = np.log10(np.abs(np.random.default_rng(1).normal(size=(bs, 3501))) * 10 + 1)
    spec = spec.astype(np.float32)
    jsampler, sampler = _sampler_pair(method, jcfg, pcfg, steps, pred_edge=True, only_2d=True)

    def model_apply(t, x, nm, em, edge_x, nl, cond_x, cond_edge_x, has_cond, c_emb):
        return model.apply(variables, t, x, nm, em, None, edge_x=edge_x, noise_level=nl,
                           context_emb=c_emb)

    ctx = jax_encode_context(model, variables, jnp.asarray(spec))
    jx, je = jax.jit(lambda z_, e_: jsampler.sampling(
        model_apply, jax.random.PRNGKey(0), z_, jnp.asarray(node_mask),
        jnp.asarray(edge_mask), e_, ctx))(jnp.asarray(z), jnp.asarray(edge_z))
    jout = jdec.post_process(jx, 5, False, jnp.asarray(node_mask),
                             jsc.get_data_inverse_scaler(jcfg), je, jnp.asarray(edge_mask),
                             compress_edge=True, has_positions=False)
    jmols = jdec.mol_process(jout[1], jout[0], jout[2], np.asarray(n_nodes), jout[3])

    T = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        tctx = port.encode_context([T(spec)])
        tx, te = sampler.sampling(port, torch.Generator().manual_seed(0), T(z), T(node_mask),
                                  T(edge_mask), T(edge_z), tctx)
    tout = tdec.post_process(tx, 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg), te,
                             T(edge_mask), include_charge=False, has_positions=False)
    assert tout[0] is None and jout[0] is None
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])
    scale = max(np.abs(np.asarray(jx)).max(), 1.0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-4 * scale)
    assert len(tmols) == len(jmols) == bs
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        assert tp is None and jp is None
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("include_charge", [False, True])
def test_decode_without_positions_matches_jax(include_charge):
    rng = np.random.default_rng(5)
    n_nodes, n, feat = [4, 7, 2], 7, 5 + include_charge
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    xh = (rng.normal(size=(3, n, feat)) * 0.4 * node_mask).astype(np.float32)
    e = rng.uniform(-1.2, 1.2, size=(3, n, n, 2)).astype(np.float32)
    edge_x = ((e + e.transpose(0, 2, 1, 3)) / 2 * edge_mask[..., None]).astype(np.float32)
    jcfg, pcfg = cdgs_configs({})
    jout = jdec.post_process(jnp.asarray(xh), 5, include_charge, jnp.asarray(node_mask),
                             jsc.get_data_inverse_scaler(jcfg), jnp.asarray(edge_x),
                             jnp.asarray(edge_mask), compress_edge=True, has_positions=False)
    T = torch.from_numpy
    tout = tdec.post_process(T(xh), 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg),
                             T(edge_x), T(edge_mask), include_charge, has_positions=False)
    assert tout[0] is None and jout[0] is None
    for g, w in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tmols = tdec.mol_process(tout[1], None, tout[2], n_nodes, tout[3])
    jmols = jdec.mol_process(jout[1], None, jout[2], np.asarray(n_nodes), jout[3])
    for tm, jm in zip(tmols, jmols):
        assert tm[0] is None and jm[0] is None
        for g, w in zip(tm[1:], jm[1:]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# ---- train, serve and sweep -------------------------------------------------------------

# JAX's tests/test_2d_run_lib.py sizes
RUN = {**NARROW, "data.synthetic_size": 64, "training.base_batch_size": 4,
       "training.batch_size": 4, "training.eval_batch_size": 4, "training.eval_samples": 4,
       "training.n_iters": 4, "training.snapshot_freq": 4,
       "training.snapshot_freq_for_preemption": 8, "training.log_freq": 2,
       "sampling.steps": 4, "eval.num_samples": 4, "eval.batch_size": 4,
       "eval.begin_ckpt": 1, "eval.end_ckpt": 1,
       "eval.sub_geometry": False}  # 2-D molecules carry no conformers, as JAX's test sets
FIGURE_LINE = re.compile(r"^(Metric-\w+) \|\||Generalization \|\| (.+) exact match"
                         r"|^(Top-\d+ accuracy|Consensus Top-1 \(mode of \d+ draws\)) \|\| (\w+)")


def figure_names(messages):
    """The figure names of a sweep's log lines: ``Metric-2D``, each
    generalisation split's tag and each Top-K and consensus line's."""
    names = set()
    for msg in messages:
        m = FIGURE_LINE.search(msg)
        if m:
            names.add(" ".join(g for g in m.groups() if g))
    return names


def _sweep_log(caplog, run):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        out = run()
    return out, [r.getMessage() for r in caplog.records]


def test_train_serve_and_sweep_as_jax_names_the_figures(tmp_path, caplog):
    jcfg, pcfg = cdgs_configs(RUN)
    jcfg.training.num_devices = 1
    jcfg.eval.sub_geometry = False  # 2-D molecules carry no conformers
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_run_lib.train(jcfg, None, jdir)
    _, jax_log = _sweep_log(caplog, lambda: jax_run_lib.evaluate(jcfg, None, jdir, "eval"))

    state = run_lib.train(pcfg, pdir, "cpu")
    assert state.step == 5 and ckpt.latest_numbered_checkpoint(pdir) == 1
    assert type(state.model).__name__ == "CDGS"
    files = {tree: {sub: sorted(os.listdir(os.path.join(d, "samples", sub)))
                    for sub in ("iter_4", "iter_4_gt")} for tree, d in (("jax", jdir),
                                                                       ("port", pdir))}
    assert files["port"]["iter_4"] == [] and len(files["port"]["iter_4_gt"]) == 4
    assert {k: len(v) for k, v in files["port"].items()} == {
        k: len([f for f in v if f.endswith(".xyz")]) for k, v in files["jax"].items()}

    data = generate(seed=7, size=1, max_n=10, fidelity=4)
    n_atoms = int(data["num_atom"][0])
    for method in ("ancestral", "dpm_solver"):
        el = Elucidator.from_workdir(pdir, configs.apply_overrides(
            configs.get_smoke_2d_config(), {**RUN, "sampling.method": method}), device="cpu")
        result = el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=3, seed=0)
        assert sum(c.count for c in result.candidates) == 3
        for c in result.candidates:
            assert c.positions is None and c.molgraph.positions is None
            assert c.molgraph.n_atoms == n_atoms
            assert c.molgraph.bond_orders.shape == (n_atoms, n_atoms)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Elucidator.from_workdir(pdir, pcfg)

    figures, port_log = _sweep_log(caplog, lambda: run_lib.evaluate_checkpoints(
        pcfg, pdir, "eval", "cpu"))
    names = figure_names(port_log)
    assert names == figure_names(jax_log) == {"Metric-2D", "Top-1 2D"}
    assert not [m for m in port_log if "3D" in m]
    fig = figures[1]
    assert not [k for k in fig if "3d" in k] and "Top-1 3D" not in fig["generalization"]
    assert fig["targets"] == 4 and 0 <= fig["top1_2d"] <= 1
    assert all(0 <= v <= 1 for v in fig["metric_2d"].values())


def test_command_lines_take_the_2d_config(tmp_path, capsys):
    """``main.py --smoke-2d`` trains CDGS and sweeps its checkpoint with
    the 2-D figures alone; ``tools/eval_sweep.py --smoke-2d`` builds the
    same config and sweeps random weights; ``--smoke`` and ``--smoke-2d``
    exclude each other."""
    import json

    from diffspectra_tpu_torch import main
    from diffspectra_tpu_torch.tools import eval_sweep

    narrow = ["--config", "model.nf=32", "--config", "model.n_layers=2", "--config",
              "model.n_heads=4", "--config", "sampling.steps=3", "--config",
              "data.synthetic_size=64", "--config", "eval.sub_geometry=false", "--device", "cpu"]
    work = str(tmp_path / "w")
    state = main.main(["--mode", "train", "--smoke-2d", "--workdir", work, "--config",
                       "training.n_iters=2", "--config", "training.snapshot_freq=2", *narrow])
    assert type(state.model).__name__ == "CDGS" and state.step == 3
    figures = main.main(["--mode", "eval", "--smoke-2d", "--workdir", work, *narrow])
    assert set(figures) == {1} and "metric_3d" not in figures[1] and "metric_2d" in figures[1]
    assert eval_sweep.build_config(eval_sweep.parse_args(["--smoke-2d"])).only_2D
    argv = ["--smoke-2d", "--random-weights", "--device", "cpu", "--steps", "2",
            "--num-samples", "4", "--synthetic-size", "64", "--workdir", str(tmp_path / "s")]
    capsys.readouterr()
    assert eval_sweep.main(argv) == 0
    swept = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "top1_2d" in swept and "top1_3d" not in swept
    with pytest.raises(SystemExit):
        main.parse_args(["--mode", "train", "--workdir", work, "--smoke", "--smoke-2d"])
