"""The DMT's other configurations against the JAX package on the CPU: the
schedules ``linear``, ``discrete`` and ``discrete_poly``, ``GaussianLayer``,
``cond_time=False``, ``dist_gbf=False`` and ``include_fc_charge=False``,
trained and served, and ``Elucidator.from_workdir``. Inputs come from numpy
seeds; the JAX Pallas paths run in interpret mode.

- The schedules: ``marginal_log_mean_coeff``, ``marginal_prob``,
  ``marginal_lambda``, ``get_noiseLevel`` and ``inverse_lambda`` of every
  schedule, each value within 1e-6 of JAX's relative, plus 2 float32 steps
  times the function's condition where the value comes from a difference
  of nearly equal numbers (XLA's exp and log differ from torch's in the last
  bit): none for log alpha, alpha and t, 1 / sigma for sigma, 1 / sigma^2
  for lambda and the log SNR (measured at most 0.98 of those 2 steps). The
  discrete schedules' keypoints agree to 1e-6 of their largest value; their
  marginals are held on the same keypoints, since XLA's cumulative sums run
  in another order and the functions' flat ends magnify a last bit.
- ``GaussianLayer`` and ``CondGaussianLayer`` without a time embedding
  against flax at 1e-6.
- The parameter trees: JAX's ``model.init`` of a variant loads into the
  port and comes back unchanged; the port's fresh init has its leaves.
- The narrow DMT (nf=64, 4 blocks, 8 heads, N <= 8) of each variant: its
  parameter tree equal to JAX's ``model.init``'s (names and shapes), its
  self-conditioned forward against JAX's jitted forward (``use_pallas``,
  ``DIFFSPECTRA_PALLAS_INTERPRET=1``) on both ``pallas_ops``: in float32
  within rtol = atol = 2e-4 (as ``tests/test_torch_dmt.py``; measured at
  most 8e-6), in bfloat16 within half of JAX's own bfloat16-against-float32
  gap (as ``tests/test_torch_bf16.py``; measured at most 0.29).
- Training, float32, nf=32, 2 blocks: the graph loss and every gradient of
  two variants (``linear`` with cond_time, dist_gbf and the charge off;
  ``discrete_poly`` with ``GaussianLayer``), on seeded weights in the
  JAX tree, against JAX's jitted loss on JAX's draws, as
  ``tests/test_torch_train.py`` holds them: the loss within 2e-5 relative,
  each gradient within 1e-4 of the largest.
- Sampling, float32: 10 ancestral and DPM-Solver++ steps at
  ``sampling_temperature=0`` from a shared ``z_T`` under ``linear`` (betas
  0.1 and 15, not the defaults) and ``discrete_poly``, decoded (the first
  variant without a charge channel): states within 2e-3 and the decoded
  molecules equal, as ``tests/test_torch_sampler.py`` holds them.
- ``Elucidator.from_workdir``: ``run_lib.train`` for 3 steps of a variant,
  then the checkpoint it wrote serves the same candidates as the live EMA
  weights; a missing checkpoint raises ``FileNotFoundError``; ``main.py
  --mode eval`` sweeps the workdir's checkpoint; without CUDA and without
  ``device="cpu"`` it raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import diffspectra_tpu.models.layers as jl
from diffspectra_tpu.configs import smoke
from diffspectra_tpu.diffusion.schedule import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.diffusion.schedule import get_polynomial_schedule as jax_poly
from diffspectra_tpu.models.dmt import DMT as JaxDMT
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
from diffspectra_tpu_torch import configs, main, run_lib
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP, get_polynomial_schedule
from diffspectra_tpu_torch.models import layers as tl
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.sampling import decode as tdec
from diffspectra_tpu_torch.sampling.ancestral import AncestralSampler, make_time_steps
from diffspectra_tpu_torch.sampling.dpm_solver import DPMSolverPP
from diffspectra_tpu_torch.training.losses import T_EPS, get_sde_graph_loss_fn
from diffspectra_tpu_torch.training.step import load_ema_weights
from diffspectra_tpu_torch.training.train_state import params_of
from diffspectra_tpu_torch.utils import scalers as tsc
from diffspectra_tpu_torch.warm_state import (
    flax_variables,
    init_variables,
    load_model_state,
    params_from_flax,
    random_variables,
)
from test_torch_dmt import _inputs, _jax_forward, _torch_forward
from test_torch_train import _batch, _jax_batch, _port_batch

torch.set_num_threads(2)

EPS32 = 2.0 ** -23

# ---- the schedules ------------------------------------------------------------

BETAS = np.linspace(1e-4, 0.02, 1000).astype(np.float32)
SCHEDULES = {  # name -> (schedule, its discrete keypoints)
    "linear": ("linear", {}),
    "cosine": ("cosine", {}),
    "discrete_poly": ("discrete_poly", {}),
    "discrete_betas": ("discrete", {"betas": BETAS}),
    "discrete_alphas_cumprod": (
        "discrete", {"alphas_cumprod": np.cumprod(1.0 - BETAS.astype(np.float64)).astype(np.float32)}),
}


def _close(got, want, cond=1.0, what=""):
    """Within 1e-6 relative plus 2 float32 steps times the condition."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    tol = 1e-6 * np.abs(want) + 2 * EPS32 * cond
    assert np.all(np.abs(got - want) <= tol), (what, np.max((np.abs(got - want) - tol)))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    schedule, keys = SCHEDULES[name]
    js = JaxSchedule(schedule, **{k: jnp.asarray(v) for k, v in keys.items()})
    ts = NoiseScheduleVP(schedule, **{k: torch.from_numpy(v) for k, v in keys.items()})
    assert ts.T == js.T and ts.T == (0.9946 if schedule == "cosine" else 1.0)
    if "discrete" in schedule:
        want = np.asarray(js.log_alpha_array)
        np.testing.assert_allclose(ts.log_alpha_array.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_array_equal(ts.t_array.numpy(), np.asarray(js.t_array))
        js.log_alpha_array = jnp.asarray(ts.log_alpha_array.numpy())  # the same keypoints
    t = np.linspace(1e-3, ts.T, 201).astype(np.float32)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    sigma = np.asarray(js.marginal_std(jt), np.float64)
    _close(ts.marginal_log_mean_coeff(tt), js.marginal_log_mean_coeff(jt), what="log alpha")
    (alpha, sig), (j_alpha, j_sig) = ts.marginal_prob(tt), js.marginal_prob(jt)
    _close(alpha, j_alpha, what="alpha")
    _close(sig, j_sig, 1 / sigma, "sigma")
    _close(ts.marginal_lambda(tt), js.marginal_lambda(jt), 1 / sigma**2, "lambda")
    _close(ts.get_noiseLevel(tt), js.get_noiseLevel(jt), 1 / sigma**2, "log SNR")
    lamb = np.linspace(-8, 8, 33).astype(np.float32)
    _close(ts.inverse_lambda(torch.from_numpy(lamb)), js.inverse_lambda(jnp.asarray(lamb)),
           what="inverse lambda")
    np.testing.assert_allclose(make_time_steps(ts, 10).numpy(),
                               np.asarray(jax_time_steps(js, 10)), rtol=0, atol=1e-7)


def test_polynomial_schedule_matches_jax():
    want = np.asarray(jax_poly(1000))
    np.testing.assert_allclose(get_polynomial_schedule(1000).numpy(), want, rtol=1e-6, atol=0)


def test_schedule_from_config_takes_the_configs_betas():
    config = configs.apply_overrides(configs.get_smoke_config(), {
        "sde.schedule": "linear", "sde.continuous_beta_0": 0.2, "sde.continuous_beta_1": 15.0})
    sch = NoiseScheduleVP.from_config(config)
    assert (sch.schedule, sch.beta_0, sch.beta_1) == ("linear", 0.2, 15.0)
    want = JaxSchedule("linear", continuous_beta_0=0.2, continuous_beta_1=15.0)
    t = np.linspace(1e-3, 1.0, 11).astype(np.float32)
    _close(sch.marginal_log_mean_coeff(torch.from_numpy(t)),
           want.marginal_log_mean_coeff(jnp.asarray(t)))


# ---- the Gaussian layers ------------------------------------------------------

def _port_layer(module, variables):
    flat = traverse_util.flatten_dict(jax.device_get(variables["params"]), sep=".")
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()})
    return module


def test_gaussian_layers_without_time_match_flax():
    rng = np.random.default_rng(5)
    x = (rng.uniform(0, 4, size=(2, 5, 5, 1))).astype(np.float32)
    temb = rng.normal(size=(2, 16)).astype(np.float32)
    for jmod, port in ((jl.GaussianLayer(8, 16), tl.GaussianLayer(8, 16)),
                       (jl.CondGaussianLayer(8, 16), tl.CondGaussianLayer(8))):
        variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), None)
        assert set(variables["params"]) == {"means", "stds"}
        port = _port_layer(port, variables)
        want = np.asarray(jmod.apply(variables, jnp.asarray(x), None))
        got = port(torch.from_numpy(x), None).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the whole-block kernel's GBF modulation: zeros, as JAX exports them
    jmod = jl.GaussianLayer(8, 16)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), None)
    want = jmod.apply(variables, jnp.asarray(x), None, export_params=True)
    got = _port_layer(tl.GaussianLayer(8), variables).export_params(torch.from_numpy(temb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


# ---- the narrow DMT -------------------------------------------------------------

VARIANTS = {
    "cond_time_off": {"model.cond_time": False},
    "dist_gbf_off": {"model.dist_gbf": False},
    "gaussian_layer": {"model.gbf_name": "GaussianLayer"},
    "no_fc_charge": {"model.include_fc_charge": False},
}
OPS = {"attn_equi": ("attn", "equi"), "block": ("block",)}
NARROW = {"model.nf": 64, "model.n_layers": 4, "model.n_heads": 8, "data.max_node": 8}


JAX_ONLY = ("model.use_pallas",)  # the port's kernels run wherever pallas_ops names them


def _configs(overrides):
    """The JAX smoke config and the port's with the same overrides."""
    jcfg, pcfg = smoke.get_config(), configs.get_smoke_config()
    for key, value in overrides.items():
        section, leaf = key.split(".")
        node = getattr(jcfg, section)
        if leaf in node and type(node[leaf]) is not type(value):  # ml_collections keeps types
            del node[leaf]
        setattr(node, leaf, value)
        if key not in JAX_ONLY:
            configs.apply_overrides(pcfg, {key: value})
    return jcfg, pcfg


def _node_features(pcfg):
    return pcfg.data.atom_types + int(pcfg.model.include_fc_charge)


def _variables(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _jax_tree_shapes(model, feat, n=8, bs=2):
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((bs,)), jnp.zeros((bs, n, 3 + feat)),
        jnp.ones((bs, n, 1)), jnp.ones((bs, n, n)), jnp.ones((bs, 3501)),
        edge_x=jnp.zeros((bs, n, n, 2)), noise_level=jnp.zeros((bs,)))
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_narrow_variant_forward_matches_jax(monkeypatch, variant, ops):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    outs = {}
    for precision in ("float32", "bfloat16"):
        jcfg, pcfg = _configs({**NARROW, **VARIANTS[variant], "model.use_pallas": True,
                               "model.pallas_ops": OPS[ops],
                               "training.matmul_precision": precision})
        port = DMT.from_config(pcfg)
        flat = random_variables(port, seed=0)
        load_model_state(port, flat)
        model = JaxDMT.from_config(jcfg)
        feat = _node_features(pcfg)
        if precision == "float32":  # the same parameter tree as JAX's init
            assert _jax_tree_shapes(model, feat) == {k: v.shape for k, v in flat.items()}
        inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 3 + feat, [3501], True)
        outs[precision] = (_torch_forward(port, inp, True),
                           _jax_forward(model, _variables(flat), inp, True, jit=True))
    (got32, want32), (got16, want16) = outs["float32"], outs["bfloat16"]
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    for g, w, w32 in zip(got16, want16, want32):
        assert np.isfinite(g).all()
        err, gap = np.abs(g - w).max(), np.abs(w - w32).max()
        assert gap > 0 and err <= 0.5 * gap, (err, gap, err / gap)


@pytest.mark.parametrize("variant", ["cond_time_off_dist_gbf_off_no_fc_charge", "gaussian_layer"])
def test_variant_parameters_carry_across(variant):
    """JAX's ``model.init`` of a variant loads into the port strictly and
    comes back unchanged (``flax_variables``); the port's fresh init
    (``init_variables``) has JAX's leaves and shapes."""
    over = ({"model.cond_time": False, "model.dist_gbf": False, "model.include_fc_charge": False}
            if variant != "gaussian_layer" else VARIANTS["gaussian_layer"])
    jcfg, pcfg = _configs({**SMALL, **over})
    model, n, bs = JaxDMT.from_config(jcfg), 6, 2
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((bs,)), jnp.zeros((bs, n, 3 + _node_features(pcfg))),
        jnp.ones((bs, n, 1)), jnp.ones((bs, n, n)), jnp.ones((bs, 3501)),
        edge_x=jnp.zeros((bs, n, n, 2)), noise_level=jnp.zeros((bs,)))
    want = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(variables), sep="/").items()}
    port = DMT.from_config(pcfg)
    load_model_state(port, want)
    got = flax_variables(port)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    fresh = init_variables(DMT.from_config(pcfg), seed=0)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in want.items()}


def test_block_dispatch_follows_jax():
    """``('block',)`` runs the whole-block kernel only where the JAX block
    does (cond_time and dist_gbf on), else the XLA branch of both ops; the
    per-op kernels run in every variant of ``('attn', 'equi')``."""
    for variant, over in VARIANTS.items():
        for ops in OPS.values():
            _, pcfg = _configs({**NARROW, **over, "model.pallas_ops": ops})
            block = DMT.from_config(pcfg).blocks[0].e_block
            fused = ops == ("block",) and pcfg.model.cond_time and pcfg.model.dist_gbf
            assert block.block_kernel == fused, (variant, ops)
            assert block.attn_mpnn.kernel == block.equi_update.kernel == ("attn" in ops)


# ---- training ---------------------------------------------------------------------

SMALL = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 6}
TRAIN_VARIANTS = {
    "linear_no_time_no_gbf_no_charge": {
        "sde.schedule": "linear", "sde.continuous_beta_1": 15.0, "model.cond_time": False,
        "model.dist_gbf": False, "model.include_fc_charge": False},
    "discrete_poly_gaussian_layer": {"sde.schedule": "discrete_poly",
                                     "model.gbf_name": "GaussianLayer"},
}


def _jax_schedule(jcfg):
    return JaxSchedule(jcfg.sde.schedule, continuous_beta_0=jcfg.sde.continuous_beta_0,
                       continuous_beta_1=jcfg.sde.continuous_beta_1)


def _draws(key, batch, feat):
    """The draws of the JAX loss for the step key ``key``."""
    node_mask = jnp.asarray(batch["atom_mask"])[..., None]
    bs, n = batch["atom_mask"].shape
    _, k_t, k_noise, k_edge, k_sc = jax.random.split(key, 5)
    t = jax.random.uniform(k_t, (bs,)) * (1.0 - T_EPS) + T_EPS
    noise = JM.sample_combined_position_feature_noise(k_noise, bs, n, feat, node_mask)
    edge = JM.sample_symmetric_edge_feature_noise(k_edge, bs, n, 2, jnp.asarray(batch["edge_mask"]))
    return dict(t=torch.tensor(np.asarray(t)), noise=torch.tensor(np.asarray(noise)),
                edge_noise=torch.tensor(np.asarray(edge)),
                use_sc=bool(jax.random.bernoulli(k_sc, 0.5)), seeds=None)


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_variant_graph_loss_and_gradients_match_jax(variant):
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    try:
        jcfg, pcfg = _configs({**SMALL, **TRAIN_VARIANTS[variant]})
        batch = _batch(1)
        port = DMT.from_config(pcfg)
        flat = random_variables(port, seed=2)
        load_model_state(port, flat)
        variables = _variables(flat)
        model = JaxDMT.from_config(jcfg)
        loss_fn = make_loss_fn(_jax_schedule(jcfg), jsc.get_data_scaler(jcfg), jcfg)

        def wrapped(params, key):
            apply_fn = _make_apply_fn(model, params, train=True)
            apply_fn.encode = lambda r, stats, ctx: encode_context_train(
                model, params, stats, ctx, r)
            return loss_fn(apply_fn, variables["batch_stats"], _jax_batch(batch), key)

        grad_fn = jax.jit(jax.value_and_grad(wrapped, has_aux=True))
        feat = _node_features(pcfg)
        port_loss = get_sde_graph_loss_fn(NoiseScheduleVP.from_config(pcfg),
                                          tsc.get_data_scaler(pcfg), pcfg)
        port.train()
        params = params_of(port)
        seen = set()
        for i in range(40):  # a key with the self-conditioning coin each way
            key = jax.random.PRNGKey(2000 + i)
            draws = _draws(key, batch, feat)
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


# ---- sampling and decode -------------------------------------------------------------

SAMPLE_VARIANTS = {
    "linear": TRAIN_VARIANTS["linear_no_time_no_gbf_no_charge"],
    "discrete_poly": TRAIN_VARIANTS["discrete_poly_gaussian_layer"],
}


@pytest.mark.parametrize("method", ["ancestral", "dpm_solver"])
@pytest.mark.parametrize("schedule", sorted(SAMPLE_VARIANTS))
def test_variant_sampling_and_decode_match_jax(schedule, method):
    steps, n, n_nodes = 10, 8, [8, 6, 8, 5]
    bs = len(n_nodes)
    jcfg, pcfg = _configs({**SMALL, "data.max_node": n, **SAMPLE_VARIANTS[schedule]})
    port = DMT.from_config(pcfg)
    flat = random_variables(port, seed=3)
    load_model_state(port, flat)
    variables = _variables(flat)
    model = JaxDMT.from_config(jcfg)
    feat, fc = _node_features(pcfg), bool(pcfg.model.include_fc_charge)

    rng = np.random.default_rng(0)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    z = rng.normal(size=(bs, n, 3 + feat)).astype(np.float32) * node_mask
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
    jout = jdec.post_process(jx, 5, fc, jnp.asarray(node_mask), jsc.get_data_inverse_scaler(jcfg),
                             je, jnp.asarray(edge_mask), compress_edge=True)
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
                             T(edge_mask), include_charge=fc)
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2e-3)
    assert len(tmols) == len(jmols) == bs
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        assert np.asarray(tf).shape == np.asarray(jf).shape
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)


def test_no_charge_clamped_self_conditioning_matches_jax():
    jcfg, pcfg = _configs({"model.include_fc_charge": False, "model.self_cond_type": "clamp"})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32) * 2
    e = rng.normal(size=(2, 5, 5, 2)).astype(np.float32) * 2
    want = jsc.get_self_cond_fn(jcfg)(jnp.asarray(x), jnp.asarray(e))
    got = tsc.get_self_cond_fn(pcfg)(torch.from_numpy(x), torch.from_numpy(e))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- from_workdir ---------------------------------------------------------------------

def test_from_workdir_serves_the_checkpoint_train_wrote(tmp_path, monkeypatch):
    over = {**SMALL, "data.max_node": 8, **TRAIN_VARIANTS["linear_no_time_no_gbf_no_charge"],
            "data.synthetic_size": 96, "optim.warmup": 2, "sampling.steps": 4,
            "training.batch_size": 4, "training.n_iters": 2, "training.log_freq": 1,
            "training.snapshot_freq": 2, "training.snapshot_freq_for_preemption": 100,
            "training.snapshot_sampling": False, "eval.num_samples": 4, "eval.batch_size": 4}
    _, config = _configs(over)
    workdir = str(tmp_path / "run")
    state = run_lib.train(config, workdir, "cpu")
    assert state.step == 3 and ckpt.latest_numbered_checkpoint(workdir) == 1

    data = generate(seed=7, size=1, max_n=8, fidelity=4)
    n_atoms = int(data["num_atom"][0])
    live = Elucidator(config, load_ema_weights(state, DMT.from_config(config)),
                      torch.device("cpu"))
    results = [el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=3, seed=0)
               for el in (live, Elucidator.from_workdir(workdir, config, device="cpu"),
                          Elucidator.from_workdir(workdir, config, ckpt=1, device="cpu"))]
    assert results[1].candidates and sum(c.count for c in results[1].candidates) == 3
    for result in results[1:]:
        assert len(result.candidates) == len(results[0].candidates)
        for got, want in zip(result.candidates, results[0].candidates):
            assert got.molgraph.wl_hash() == want.molgraph.wl_hash()
            assert got.count == want.count and got.first_draw == want.first_draw
            np.testing.assert_array_equal(got.positions, want.positions)
    with pytest.raises(FileNotFoundError):
        Elucidator.from_workdir(str(tmp_path / "empty"), config, device="cpu")
    with pytest.raises(FileNotFoundError):
        Elucidator.from_workdir(workdir, config, ckpt=5, device="cpu")

    monkeypatch.setattr(configs, "get_smoke_config", lambda: copy.deepcopy(config))
    # --mode eval sweeps the smoke config's numbered checkpoint 1
    figures = main.main(["--mode", "eval", "--workdir", workdir, "--smoke", "--device", "cpu"])[1]
    assert figures["targets"] == 4 and 0.0 <= figures["top1_2d"] <= 1.0
    with pytest.raises(FileNotFoundError):
        main.main(["--mode", "eval", "--workdir", str(tmp_path / "none"), "--smoke",
                   "--device", "cpu"])


def test_from_workdir_runs_on_cuda_unless_told(tmp_path, monkeypatch):
    """``device=None`` means cuda: without CUDA the entry point raises before
    it reads the workdir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, config = _configs(SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Elucidator.from_workdir(str(tmp_path), config)
