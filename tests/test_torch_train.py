"""The port's training path against the JAX package's, on the CPU, float32,
smoke widths (nf 32, 2 blocks, 4 heads, N <= 6, dropout 0, threefry keys).

Both packages start from one state: JAX's ``create_train_state`` of its own
init, carried into the port by ``warm_state.train_state_from_flax``. Every
draw the port's loss takes (``t``, the node and edge noise, ``use_sc``) is
recomputed here from the key splits of ``diffspectra_tpu/training/
losses.py:136-137, 189-190``, so both see the same numbers.

Tolerances (float32, sums in another order):
- the loss within 2e-5 relative, every parameter's gradient within 1e-4 of
  the largest |gradient| of the model;
- after one and three train steps (then the eval step's loss, from the
  EMA weights, within 2e-5 relative): params and the EMA shadow within 1e-6
  (SpecFormer's key, value, to_out and ff2 biases, whose exact gradient
  is zero in training mode and whose rounding noise Adam scales up, within
  twice the learning rates' sum), the batch statistics within 1e-5 plus
  that (a running mean takes those biases in),
  the optimizer's moments within 1e-4 of the largest of their kind (they
  carry the gradients' differences), the clip queue within 1e-5 relative,
  counts and steps exact;
- the optimizer chain over 30 steps of one gradient sequence (warmup, a
  clip, amsgrad's max): params within 1e-6; the EMA within 1e-6;
- SpecFormer in training mode (batch statistics, running update) within
  1e-5; the full-width loss from ``artifacts/warm_qm9s_as.npz`` within 1e-4
  relative.

bfloat16 (``training.matmul_precision``, the production dtype), against JAX's
jitted XLA path in bfloat16 on the same weights and inputs:
- the DMT's train-mode forward at dropout 0 (both train branches, the
  embeddings): each output within 0.05 of JAX's bfloat16-against-float32 gap
  (measured 2e-5 and 4e-5; rounded otherwise, as below, 0.33 and 0.61);
- the graph loss from the state and draws above: the loss within half of
  JAX's gap (measured 0.004 self-conditioned, 0.0004 not), every gradient
  within the largest such gap over the model's gradients (measured 0.15 and
  0.44). The gradients are not bit for bit: a torch backward rounds each
  op's gradient to bfloat16 where XLA's fusions keep float32, so single
  gradients differ by a bfloat16 step or two.
"Rounded otherwise": ``q * k`` and ``e1 * alpha`` in float32 instead of the
einsums' pairwise bfloat16 products, and the bias adds that only float32
math reads (the equivariant input layer's, the embeddings') and the update's
tanh rounded to bfloat16.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.diffusion import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.models import ema as jax_ema
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.models.dmt import encode_context_train
from diffspectra_tpu.models.specformer import SpecFormer as JaxSpecFormer
from diffspectra_tpu.training import optim as jax_optim
from diffspectra_tpu.training.step import _make_apply_fn, get_step_fn, make_loss_fn
from diffspectra_tpu.training.train_state import create_train_state as jax_create_train_state
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu.utils.scalers import get_data_scaler as jax_data_scaler
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.models import ema
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.models.layers import cast_param, dropout
from diffspectra_tpu_torch.models.specformer import SpecFormer
from diffspectra_tpu_torch.training import optim
from diffspectra_tpu_torch.training.losses import T_EPS, get_sde_graph_loss_fn
from diffspectra_tpu_torch.training.step import get_step_fn as port_step_fn
from diffspectra_tpu_torch.training.train_state import create_train_state, params_of
from diffspectra_tpu_torch.utils.scalers import get_data_scaler
from diffspectra_tpu_torch.warm_state import (
    flax_variables,
    load_model_state,
    params_from_flax,
    random_variables,
    read_warm_state,
    train_state_from_flax,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")
SMALL = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 6,
         "optim.warmup": 2}


@pytest.fixture(autouse=True)
def _threefry():
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


def _configs(**overrides):
    jcfg = jax_smoke.get_config()
    pcfg = configs.get_smoke_config()
    for key, value in {**SMALL, **overrides}.items():
        section, leaf = key.split(".")
        node = getattr(jcfg, section)
        if type(node[leaf]) is not type(value):  # ml_collections keeps a field's type
            del node[leaf]
        setattr(node, leaf, value)
        setattr(getattr(pcfg, section), leaf, value)
    return jcfg, pcfg


def _batch(seed, bs=4, n=6, n_nodes=None):
    """A seeded numpy batch of the dense layout."""
    rng = np.random.default_rng(seed)
    n_nodes = np.asarray(n_nodes if n_nodes is not None else rng.integers(3, n + 1, bs))
    node_mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None] * (1 - np.eye(n, dtype=np.float32))
    atoms = rng.integers(0, 5, (bs, n))
    bonds = np.triu(rng.integers(0, 4, (bs, n, n)), 1)
    bonds = (bonds + bonds.transpose(0, 2, 1)) * edge_mask
    edge = np.stack([(bonds > 0), bonds / 3.0], -1).astype(np.float32)
    return dict(
        positions=(rng.normal(size=(bs, n, 3)) * node_mask[..., None]).astype(np.float32),
        atom_mask=node_mask, edge_mask=edge_mask,
        atom_one_hot=(np.eye(5, dtype=np.float32)[atoms] * node_mask[..., None]),
        edge_one_hot=edge * edge_mask[..., None],
        formal_charges=(rng.integers(-1, 2, (bs, n, 1)) * node_mask[..., None]).astype(np.float32),
        context=np.log10(np.abs(rng.normal(size=(bs, 3501))).astype(np.float32) * 10 + 1),
    )


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items() if k != "context"}
    out["context"] = (torch.from_numpy(batch["context"]),)
    return out


def _jax_state(jcfg, batch):
    """JAX's train state of its own init (jitted: a few times faster than
    flax's eager ``init`` at these widths)."""
    model = JaxDMT.from_config(jcfg)
    tx = jax_optim.get_optimizer(jcfg)
    bs, n = batch["atom_mask"].shape
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((bs,)), jnp.zeros((bs, n, 9)),
        jnp.asarray(batch["atom_mask"])[..., None], jnp.asarray(batch["edge_mask"]),
        jnp.asarray(batch["context"]), edge_x=jnp.zeros((bs, n, n, 2)),
        noise_level=jnp.zeros((bs,)),
    )
    return model, tx, jax_create_train_state(variables, tx, jcfg.model.ema_decay)


def _port_state(pcfg, jax_state):
    model = DMT.from_config(pcfg)
    tx = optim.get_optimizer(pcfg)
    return tx, train_state_from_flax(jax.device_get(jax_state), model, tx)


def jax_draws(rng, batch, jcfg):
    """The draws of the JAX loss for the step key ``rng``."""
    node_mask = jnp.asarray(batch["atom_mask"])[..., None]
    bs, n = batch["atom_mask"].shape
    _, k_t, k_noise, k_edge, k_sc = jax.random.split(rng, 5)
    t = jax.random.uniform(k_t, (bs,)) * (1.0 - T_EPS) + T_EPS
    noise = JM.sample_combined_position_feature_noise(k_noise, bs, n, 6, node_mask)
    edge = JM.sample_symmetric_edge_feature_noise(k_edge, bs, n, 2, jnp.asarray(batch["edge_mask"]))
    return dict(t=torch.tensor(np.asarray(t)), noise=torch.tensor(np.asarray(noise)),
                edge_noise=torch.tensor(np.asarray(edge)),
                use_sc=bool(jax.random.bernoulli(k_sc, 0.5)), seeds=None)


def _key_with_sc(use_sc, batch, jcfg):
    for i in range(100):
        key = jax.random.PRNGKey(1000 + i)
        if jax_draws(key, batch, jcfg)["use_sc"] == use_sc:
            return key
    raise AssertionError("no key")


def _to_port(flat_tree):
    """A nested flax param tree (numpy) -> port names."""
    flat = traverse_util.flatten_dict(jax.device_get(flat_tree), sep="/")
    return {k: v for k, v in params_from_flax({f"params/{p}": v for p, v in flat.items()}).items()}


def _jax_grad_fn(jcfg, batch, batch_stats):
    """JAX's jitted loss and gradient of (params, step key) in train mode."""
    model = JaxDMT.from_config(jcfg)
    loss_fn = make_loss_fn(JaxSchedule(jcfg.sde.schedule), jax_data_scaler(jcfg), jcfg)

    def wrapped(params, key):
        apply_fn = _make_apply_fn(model, params, train=True)
        apply_fn.encode = lambda r, stats, ctx: encode_context_train(model, params, stats, ctx, r)
        return loss_fn(apply_fn, batch_stats, _jax_batch(batch), key)

    return jax.jit(jax.value_and_grad(wrapped, has_aux=True))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, compiled once for the module: the small DMT's fresh
    train state on batch 1, the jitted loss-and-gradient of a step key (in
    float32, and in bfloat16 on first use), and the jitted train step."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    jcfg, pcfg = _configs()
    batch = _batch(1)
    model, tx, jstate = _jax_state(jcfg, batch)
    step_fn, eval_fn = (jax.jit(get_step_fn(JaxSchedule(jcfg.sde.schedule), model, tx,
                                            jax_data_scaler(jcfg), jcfg, train=train))
                        for train in (True, False))
    bf16 = _configs(**{"training.matmul_precision": "bfloat16"})
    yield dict(jcfg=jcfg, pcfg=pcfg, batch=batch, jstate=jstate,
               grad_fn=_jax_grad_fn(jcfg, batch, jstate.batch_stats), step_fn=step_fn,
               eval_fn=eval_fn, bf16=(*bf16, _jax_grad_fn(bf16[0], batch, jstate.batch_stats)))
    jax.config.update("jax_default_prng_impl", prev)


def _port_loss_and_grads(pcfg, jstate, batch, draws):
    """The port's train-mode loss and each parameter's gradient (zeros where
    none reaches it), from the JAX state."""
    _, state = _port_state(pcfg, jstate)
    loss_fn = get_sde_graph_loss_fn(NoiseScheduleVP(pcfg.sde.schedule), get_data_scaler(pcfg), pcfg)
    port = state.model.train()
    params = params_of(port)
    loss = loss_fn(port, _port_batch(batch), draws)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss, port, {name: (np.zeros(p.shape, np.float32) if g is None else g.float().numpy())
                        for (name, p), g in zip(params.items(), grads)}


@pytest.mark.parametrize("use_sc", [True, False])
def test_graph_loss_and_gradients_match_jax(jax_run, use_sc):
    jcfg, pcfg, batch, jstate = (jax_run[k] for k in ("jcfg", "pcfg", "batch", "jstate"))
    assert jcfg.model.noise_align and pcfg.model.noise_align and pcfg.model.reuse_cond_emb
    key = _key_with_sc(use_sc, batch, jcfg)
    (want_loss, want_stats), want_grads = jax_run["grad_fn"](jstate.params, key)
    want_grads = _to_port(want_grads)

    loss, port, grads = _port_loss_and_grads(pcfg, jstate, batch, jax_draws(key, batch, jcfg))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    assert set(grads) == set(want_grads)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads.values())
    for name, got in grads.items():
        np.testing.assert_allclose(got, want_grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    stats = flax_variables(port)
    for path, value in traverse_util.flatten_dict(jax.device_get(want_stats), sep="/").items():
        np.testing.assert_allclose(stats[f"batch_stats/{path}"], value, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_sc", [True, False])
def test_bf16_graph_loss_and_gradients_match_jax(jax_run, use_sc):
    """bfloat16 against JAX's bfloat16 XLA path, from one state and JAX's
    draws: the loss within half of JAX's bfloat16-against-float32 gap, each
    gradient within the largest such gap of the model's gradients (the
    readings are in the module's docstring)."""
    jcfg, batch, jstate = (jax_run[k] for k in ("jcfg", "batch", "jstate"))
    jcfg16, pcfg16, grad_fn16 = jax_run["bf16"]
    key = _key_with_sc(use_sc, batch, jcfg)
    (want32, _), grads32 = jax_run["grad_fn"](jstate.params, key)
    (want, _), want_grads = grad_fn16(jstate.params, key)
    want_grads, grads32 = _to_port(want_grads), _to_port(grads32)

    loss, port, grads = _port_loss_and_grads(pcfg16, jstate, batch, jax_draws(key, batch, jcfg16))
    assert port.dtype == torch.bfloat16 and set(grads) == set(want_grads)
    gap = abs(float(want) - float(want32))
    assert gap > 0 and abs(loss.item() - float(want)) <= 0.5 * gap, (loss.item(), want, gap)
    gap = max(float(np.abs(np.asarray(want_grads[k]) - np.asarray(grads32[k])).max())
              for k in grads)
    assert gap > 0
    for name, got in grads.items():
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want_grads[name], rtol=0, atol=gap, err_msg=name)


class _MockDMT(torch.nn.Module):
    """A stand-in for the DMT whose predictions are fixed functions of its
    inputs, for the loss's arithmetic alone."""

    blocks = ()

    def encode_context(self, context, generator=None):
        return None

    def forward(self, t, z_t, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x,
                has_cond, context_emb, dropout_seeds=None):
        return 0.5 * z_t + 0.1 * cond_x, 0.3 * edge_x


@pytest.mark.parametrize("pred_data,noise_align,reduce_mean,self_cond",
                         [(True, True, False, True), (True, False, True, True),
                          (False, True, False, False), (False, False, True, False)])
def test_loss_arithmetic_matches_jax(pred_data, noise_align, reduce_mean, self_cond):
    """The loss with a fixed mock model in both packages: the weights,
    reductions, SNR factor, alignment and noise-prediction targets of
    ``tests/test_loss_golden.py``'s formulas; within 1e-5 relative."""
    over = {"model.pred_data": pred_data, "model.noise_align": noise_align,
            "training.reduce_mean": reduce_mean, "model.self_cond": self_cond}
    jcfg, pcfg = _configs(**over)
    batch = _batch(9)

    def apply_fn(rng, stats, t, z_t, nm, em, context, **kw):
        return (0.5 * z_t + 0.1 * kw["cond_x"], 0.3 * kw["edge_x"]), stats

    key = _key_with_sc(True, batch, jcfg)
    loss_fn = make_loss_fn(JaxSchedule(jcfg.sde.schedule), jax_data_scaler(jcfg), jcfg)
    want, _ = loss_fn(apply_fn, {}, _jax_batch(batch), key)
    got = get_sde_graph_loss_fn(NoiseScheduleVP(pcfg.sde.schedule), get_data_scaler(pcfg), pcfg)(
        _MockDMT(), _port_batch(batch), jax_draws(key, batch, jcfg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# SpecFormer's biases whose exact gradient is zero in training mode: a key
# bias shifts a softmax row, a value bias adds a constant that to_out carries
# and the next BatchNorm removes, as it removes to_out's and ff2's. Their
# gradient is rounding noise (below 4e-8 of the largest here), which Adam
# scales to steps of about the learning rate, so the two packages move them
# apart by up to the learning rate a step.
NOISE_ONLY = tuple(f"self_attn{sep}{w}{sep}bias" for sep in "/." for w in ("W_K", "W_V", "to_out")
                   ) + ("ff2/bias", "ff2.bias")


def _param_tol(name, lr_sum):
    return 2 * lr_sum if name.endswith(NOISE_ONLY) else 1e-6


def _compare_states(state, jstate, lr_sum):
    jstate = jax.device_get(jstate)
    assert state.step == int(jstate.step)
    got = flax_variables(state.model)
    for tree in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(getattr(jstate, tree), sep="/")
        for path, value in want.items():
            # a running mean takes in the noise-only biases' moves
            tol = _param_tol(path, lr_sum) if tree == "params" else 1e-5 + 2 * lr_sum
            np.testing.assert_allclose(got[f"{tree}/{path}"], value, rtol=0, atol=tol,
                                       err_msg=path)
    shadow = _to_port(jstate.ema.shadow_params)
    assert state.ema.num_updates == int(jstate.ema.num_updates)
    for name, value in shadow.items():
        np.testing.assert_allclose(state.ema.shadow_params[name].numpy(), value, rtol=0,
                                   atol=_param_tol(name, lr_sum), err_msg=name)
    clip, (moments, _, schedule) = jstate.opt_state
    opt = state.opt_state
    assert opt["count"] == int(moments.count) and opt["lr_count"] == int(schedule.count)
    assert opt["clip"]["count"] == int(clip.count)
    np.testing.assert_allclose(opt["clip"]["queue"].numpy(), clip.queue, rtol=1e-5)
    for key in ("mu", "nu", "nu_max"):
        want = _to_port(getattr(moments, key))
        scale = max(float(np.abs(v).max()) for v in want.values())
        for name, value in want.items():
            np.testing.assert_allclose(opt[key][name].numpy(), value, rtol=0,
                                       atol=1e-4 * scale, err_msg=f"{key} {name}")


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_run, steps):
    jcfg, pcfg, batch, jstate = (jax_run[k] for k in ("jcfg", "pcfg", "batch", "jstate"))
    _, state = _port_state(pcfg, jstate)
    pstep = port_step_fn(NoiseScheduleVP(pcfg.sde.schedule), optim.get_optimizer(pcfg),
                         get_data_scaler(pcfg), pcfg)
    rng = jax.random.PRNGKey(5)
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        jstate, want = jax_run["step_fn"](jstate, _jax_batch(batch), key)
        state, loss = pstep(state, _port_batch(batch), jax_draws(key, batch, jcfg))
        np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)
    _compare_states(state, jstate, sum(optim.lr_at(pcfg, i) for i in range(steps)))
    # the eval step: the EMA weights, deterministic (eval mode: the kernels'
    # plain versions, SpecFormer's running statistics)
    rng, key = jax.random.split(rng)
    _, want = jax_run["eval_fn"](jstate, _jax_batch(batch), key)
    eval_step = port_step_fn(NoiseScheduleVP(pcfg.sde.schedule), optim.get_optimizer(pcfg),
                             get_data_scaler(pcfg), pcfg, train=False)
    _, got = eval_step(state, _port_batch(batch), jax_draws(key, batch, jcfg),
                       DMT.from_config(pcfg))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-5)


@pytest.mark.parametrize("name,grad_clip,weight_decay",
                         [("AdamW", 10.0, 0.0), ("Adam", 0.5, 1e-2), ("Adam", -1.0, 0.0)])
def test_optimizer_chain_matches_optax(name, grad_clip, weight_decay):
    """30 steps of one gradient sequence: the warmup (10 steps), clip
    events (norms up to 40 against 10, or the plain clip), and amsgrad's
    max (the gradients shrink after step 15). Params within 1e-6."""
    jcfg, pcfg = _configs(**{"optim.optimizer": name, "optim.grad_clip": grad_clip,
                              "optim.weight_decay": weight_decay, "optim.warmup": 10})
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    params0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtx = jax_optim.get_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    jopt = jtx.init(jparams)
    tx = optim.get_optimizer(pcfg)
    params = {k: torch.tensor(v) for k, v in params0.items()}
    opt = tx.init(params)
    for step in range(30):
        scale = 8.0 if step < 15 else 0.1
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, jopt = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt = tx.update({k: torch.tensor(v) for k, v in grads.items()}, opt, params)
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {step} {k}")
    assert opt["count"] == 30 and opt["lr_count"] == 30
    if grad_clip > 1:
        np.testing.assert_allclose(opt["clip"]["queue"].numpy(), np.asarray(jopt[0].queue),
                                   rtol=1e-5)
        assert opt["clip"]["count"] == int(jopt[0].count) == optim.QUEUE_LEN - 19


def test_ema_matches_jax():
    """Six updates through the warmup of the decay; within 1e-6."""
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    jst = jax_ema.init({"w": jnp.asarray(p["w"])}, 0.999)
    st = ema.init({"w": torch.tensor(p["w"])}, 0.999)
    for _ in range(6):
        new = rng.normal(size=(4, 3)).astype(np.float32)
        jst = jax_ema.update(jst, {"w": jnp.asarray(new)})
        st = ema.update(st, {"w": torch.tensor(new)})
        np.testing.assert_allclose(st.shadow_params["w"].numpy(), np.asarray(jst.shadow_params["w"]),
                                   rtol=0, atol=1e-6)
    assert st.num_updates == int(jst.num_updates) == 6


def test_specformer_train_mode_matches_flax():
    """Two train-mode passes: the output from the batch's statistics and the
    running statistics after each (flax's biased variance, momentum 0.9),
    then eval mode from the running ones; within 1e-5."""
    rng = np.random.default_rng(2)
    port = SpecFormer("ir", output_dim=32, n_layers=2)
    flat = random_variables(port, seed=3)
    port.load_state_dict({k.split("/", 1)[1].replace("/", "."): torch.tensor(v)
                          for k, v in flat.items()})
    model = JaxSpecFormer(output_dim=32, spectra_version="ir", n_layers=2)
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in flat.items()})
    for _ in range(2):
        spec = np.log10(np.abs(rng.normal(size=(3, 3501))).astype(np.float32) * 10 + 1)
        want, mutated = model.apply(variables, jnp.asarray(spec), deterministic=False,
                                    mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        got = port.train()([torch.tensor(spec)])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        stats = traverse_util.flatten_dict(jax.device_get(mutated["batch_stats"]), sep=".")
        for key, value in stats.items():
            np.testing.assert_allclose(port.state_dict()[key].numpy(), value, rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    want = model.apply(variables, jnp.asarray(spec))
    with torch.no_grad():
        got = port.eval()([torch.tensor(spec)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dropout_share_and_scale():
    """Of 200,000 ones at p = 0.1: zeros 0.1 within 0.005 (over 5 binomial
    standard errors), every survivor exactly 1 / 0.9; p = 0 and no
    generator leave the input as it is."""
    x = torch.ones(200_000)
    out = dropout(x, 0.1, torch.Generator().manual_seed(0))
    zeros = (out == 0).float().mean().item()
    assert abs(zeros - 0.1) < 0.005, zeros
    assert torch.equal(out[out != 0], torch.full_like(out[out != 0], 1 / 0.9))
    assert dropout(x, 0.0, torch.Generator()) is x and dropout(x, 0.1, None) is x


def _small_dmt(pcfg, seed=0, **overrides):
    configs.apply_overrides(pcfg, overrides)
    model = DMT.from_config(pcfg)
    load_model_state(model, random_variables(model, seed=seed))
    return model


def _forward_inputs(seed=4, bs=3, n=6):
    rng = np.random.default_rng(seed)
    batch = _batch(seed, bs, n)
    node_mask = torch.tensor(batch["atom_mask"])[..., None]
    edge_mask = torch.tensor(batch["edge_mask"])
    xh = torch.tensor(rng.normal(size=(bs, n, 9)).astype(np.float32)) * node_mask
    edge_x = torch.tensor(rng.normal(size=(bs, n, n, 2)).astype(np.float32))
    edge_x = (edge_x + edge_x.transpose(1, 2)) * edge_mask[..., None]
    cond_x = torch.tensor(rng.normal(size=(bs, n, 9)).astype(np.float32)) * node_mask
    cond_e = torch.tensor(rng.normal(size=(bs, n, n, 2)).astype(np.float32)) * edge_mask[..., None]
    return dict(t=torch.full((bs,), 0.5), xh=xh, node_mask=node_mask, edge_mask=edge_mask,
                edge_x=edge_x, noise_level=torch.tensor(rng.normal(size=bs).astype(np.float32)),
                cond_x=cond_x, cond_e=cond_e, ctx=torch.tensor(
                    rng.normal(size=(bs, 128)).astype(np.float32)))


def _forward(model, inp, has_cond, seeds=None):
    return model(inp["t"], inp["xh"], inp["node_mask"], inp["edge_mask"], inp["edge_x"],
                 inp["noise_level"], inp["cond_x"], inp["cond_e"], has_cond, inp["ctx"], seeds)


@pytest.mark.parametrize("pallas_ops", [("attn", "equi"), ("block",)])
@pytest.mark.parametrize("has_cond", [True, False])
def test_train_and_eval_modes_agree_at_dropout_0(pallas_ops, has_cond):
    """Training mode (the XLA branches under autograd) against eval mode
    (the kernels' plain versions) at dropout 0: within 1e-5."""
    model = _small_dmt(_configs()[1], **{"model.pallas_ops": pallas_ops})
    inp = _forward_inputs()
    with torch.no_grad():
        want = _forward(model.eval(), inp, has_cond)
    got = _forward(model.train(), inp, has_cond)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("has_cond", [True, False])
def test_bf16_train_forward_matches_jax_xla_path(has_cond):
    """The bfloat16 DMT in training mode at dropout 0 (the attention's and
    the equivariant update's train branches) against JAX's jitted XLA path
    in bfloat16 on the same weights and inputs: each output within 0.05 of
    JAX's bfloat16-against-float32 gap (the readings are in the module's
    docstring)."""
    inp = _forward_inputs()
    if not has_cond:  # the first self-conditioning pass: zeros, as the loss passes
        inp["cond_x"], inp["cond_e"] = inp["cond_x"] * 0, inp["cond_e"] * 0
    j = lambda x: jnp.asarray(x.numpy())
    want, variables = {}, None
    for precision in ("float32", "bfloat16"):
        jcfg, pcfg = _configs(**{"training.matmul_precision": precision})
        if variables is None:
            flat = random_variables(DMT.from_config(pcfg), seed=0)
            variables = traverse_util.unflatten_dict(
                {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
        model = JaxDMT.from_config(jcfg)
        apply = jax.jit(lambda v, *a: model.apply(
            v, *a[:4], edge_x=a[4], noise_level=a[5], cond_x=a[6], cond_edge_x=a[7],
            has_cond=has_cond, context_emb=a[8], deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])[0])
        want[precision] = apply(variables, *(j(inp[k]) for k in (
            "t", "xh", "node_mask", "edge_mask", "edge_x", "noise_level", "cond_x", "cond_e",
            "ctx")))
    port = DMT.from_config(pcfg)
    load_model_state(port, flat)
    got = _forward(port.train(), inp, has_cond)
    for g, w, w32 in zip(got, want["bfloat16"], want["float32"]):
        g, w, w32 = g.detach().float().numpy(), np.asarray(w, np.float32), np.asarray(w32)
        err, gap = np.abs(g - w).max(), np.abs(w - w32).max()
        assert gap > 0 and err <= 0.05 * gap, (err, gap, err / gap)


def test_dropout_masks_replay_under_remat():
    """At dropout 0.1 the same seeds give the same output; other seeds
    another; and the gradient with ``remat_policy='full'`` (each block
    recomputed, its masks drawn again from its seed) or ``'dots'`` (all but
    the 2-D products recomputed) equals the one with ``'none'`` within
    1e-6; an unknown policy raises."""
    inp = _forward_inputs()
    grads = {}
    for policy in ("full", "dots", "none"):
        model = _small_dmt(_configs()[1], **{"model.dropout": 0.1,
                                              "model.remat_policy": policy}).train()
        out = _forward(model, inp, True, [11, 12])
        if policy == "full":
            again = _forward(model, inp, True, [11, 12])
            other = _forward(model, inp, True, [13, 12])
            assert torch.equal(out[0], again[0])
            assert (out[0] - other[0]).abs().max() > 1e-3
        loss = out[0].square().sum() + out[1].square().sum()
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    for policy in ("full", "dots"):
        for a, b in zip(grads[policy], grads["none"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        _small_dmt(_configs()[1], **{"model.remat_policy": "dots_all"})


def test_bf16_train_step_reads_live_weights():
    """A bf16 DMT's train step: every parameter gets a finite gradient, and
    none is zero throughout (a self-conditioned draw, so the distance layer
    is read); forwards with gradients read the live weights, so the next
    one sees the step, and those without read copies the step made anew
    (equal outputs)."""
    jcfg, pcfg = _configs(**{"training.matmul_precision": "bfloat16", "optim.warmup": 1})
    model = _small_dmt(pcfg)
    assert model.dtype == torch.bfloat16
    tx = optim.get_optimizer(pcfg)
    state = create_train_state(model, tx, pcfg.model.ema_decay)
    batch = _batch(6)
    key = _key_with_sc(True, batch, jcfg)
    draws = jax_draws(key, batch, jcfg)
    loss_fn = get_sde_graph_loss_fn(NoiseScheduleVP(pcfg.sde.schedule), get_data_scaler(pcfg), pcfg)
    params = params_of(model.train())
    grads = torch.autograd.grad(loss_fn(model, _port_batch(batch), draws), list(params.values()),
                                allow_unused=True)
    for name, g in zip(params, grads):
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, name
    inp = _forward_inputs()
    before = _forward(model, inp, True)[0].detach()
    step = port_step_fn(NoiseScheduleVP(pcfg.sde.schedule), tx, get_data_scaler(pcfg), pcfg)
    for _ in range(2):  # the first update has a learning rate of 0
        state, _ = step(state, _port_batch(batch), draws)
    dense = model.blocks[0].e_block.ff_linear1
    assert torch.equal(cast_param(dense, "kernel"), dense.kernel.to(torch.bfloat16))
    after = _forward(model, inp, True)[0].detach()
    assert (after - before).abs().max() > 0
    # the no-grad forwards (the self-conditioning pass, sampling) read copies
    # the step made anew
    with torch.no_grad():
        assert torch.equal(cast_param(dense, "kernel"), dense.kernel.to(torch.bfloat16))
        no_grad = _forward(model, inp, True)[0]
    np.testing.assert_array_equal(no_grad.float().numpy(), after.float().numpy())


def test_full_width_loss_from_the_warm_state_matches_jax():
    """The flagship at full width from ``artifacts/warm_qm9s_as.npz``
    (params and batch statistics, float32, dropout 0), batch 2, N <= 29,
    one self-conditioned draw: the train-mode loss within 1e-4 relative."""
    warm = read_warm_state(WARM)
    jcfg = diffspectra_qm9s.get_config()
    jcfg.training.matmul_precision = "float32"
    jcfg.model.dropout = 0.0
    pcfg = configs.apply_overrides(configs.get_config(), {
        "training.matmul_precision": "float32", "model.dropout": 0.0})
    batch = _batch(7, bs=2, n=29, n_nodes=[29, 17])
    spec = batch.pop("context")
    rng = np.random.default_rng(8)
    batch["context"] = tuple(
        np.log10(np.abs(rng.normal(size=(2, L))).astype(np.float32) * 10 + 1)
        for L in (701, 3501, 3501))
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in
                                              {**warm["params"], **warm["batch_stats"]}.items()})
    model = JaxDMT.from_config(jcfg)
    key = _key_with_sc(True, {**batch, "context": spec}, jcfg)
    loss_fn = make_loss_fn(JaxSchedule(jcfg.sde.schedule), jax_data_scaler(jcfg), jcfg)
    params = variables["params"]
    apply_fn = _make_apply_fn(model, params, train=True)
    apply_fn.encode = lambda r, stats, ctx: encode_context_train(model, params, stats, ctx, r)
    jbatch = {k: (tuple(jnp.asarray(c) for c in v) if k == "context" else jnp.asarray(v))
              for k, v in batch.items()}
    want, _ = jax.jit(lambda b, k: loss_fn(apply_fn, variables["batch_stats"], b, k))(jbatch, key)

    port = DMT.from_config(pcfg)
    load_model_state(port, {**warm["params"], **warm["batch_stats"]})
    tbatch = {k: (tuple(torch.tensor(c) for c in v) if k == "context" else torch.tensor(v))
              for k, v in batch.items()}
    loss_fn = get_sde_graph_loss_fn(NoiseScheduleVP(pcfg.sde.schedule), get_data_scaler(pcfg), pcfg)
    draws = jax_draws(key, {**batch, "context": spec}, jcfg)
    with torch.no_grad():
        got = loss_fn(port.train(), tbatch, draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
