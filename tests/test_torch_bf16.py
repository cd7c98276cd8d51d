"""The port in bfloat16, the JAX package's production dtype
(``training.matmul_precision='bfloat16'``), against the JAX package.

1. The layers against flax on seeded inputs, bfloat16 against bfloat16:
   ``silu`` and the modulation of a bfloat16 LayerNorm bit for bit (0
   differing elements). ``Dense(dtype=bfloat16)`` and the LayerNorm round
   their float32 results once, as flax's do, but those float32 results
   are not XLA's to the bit: torch's bfloat16 product sums in another
   order than XLA's, and XLA's float32 rsqrt on the CPU is not the
   correctly rounded 1/sqrt (983 of 3364 values differ from it). So a
   value next to a bfloat16 rounding boundary can fall the other way:
   each output equals flax's or is one bfloat16 step off, at most 1e-4 of
   them for Dense (measured 1 of 22272) and 1e-5 for the LayerNorm
   (measured 1 of 215296); the LayerNorm -> modulate chain differs only
   where its LayerNorm does. A bfloat16 Dense reads copies of its
   parameters that each load_state_dict makes: no cast a call, and a
   second load takes effect.
2. Each kernel's plain version on the bfloat16 operands the JAX DMT in
   bfloat16 passes (mix_attention: q, k, v, edge_attr, w0, w1;
   equi_update: node_i, node_j, edge_attr, dist, w_e, w_d, bias;
   block_fused: q, k, v) against the JAX Pallas kernel run with
   ``interpret=True`` on the same bfloat16 arrays: 1e-5 (1e-4 for
   block_fused), as in float32, since both compute in float32 from the
   same values.
3. The DMT in bfloat16 against JAX ``DMT(dtype=bfloat16, use_pallas=True)``
   (``DIFFSPECTRA_PALLAS_INTERPRET=1``: the Pallas path, whose kernels
   compute in float32 as the port's do; JAX's XLA path rounds e0, e1 and
   alpha to bfloat16 and the kernels do not), jitted as JAX samples (a
   jitted forward leaves the embeddings' bias add in float32, where only a
   cast to float32 reads it; the eager ``model.apply`` rounds it to
   bfloat16, and the port follows the jitted rule), on the same weights: the
   narrow model (nf=32, 2 blocks) on both paths with and without
   self-conditioning, and the full-width flagship from
   ``artifacts/warm_qm9s_as.npz`` (B=2, N=12, as ``tests/test_torch_dmt.py``
   holds it in float32) on the default ``('attn','equi')`` path. The bound:
   max |port - JAX bf16| at most half of max |JAX bf16 - JAX f32| on the
   same inputs, each output. Measured ratios: narrow 0.00001-0.0017, full
   width 0.48 (pred) and 0.19 (edge_pred). Exact agreement is out of
   reach: any float32 difference ahead of a rounding to bfloat16 (a sum
   in another order) moves a value by a bfloat16 step now and then, and
   8 blocks carry it on.
   With ``model.specformer_bf16`` (JAX's ``SpecFormer(dtype=bfloat16)``):
   SpecFormer alone, and the narrow DMT whose spectra encoding it runs,
   against JAX's jitted forward. Half of JAX's own gap is out of reach
   here: XLA's float32 exp on the CPU differs from torch's in about 10% of
   values, so softmax weights next to a bfloat16 rounding fall the other
   way (one attention layer on the same inputs reads 0.79 of its own gap;
   SpecFormer 0.58, the DMT 0.78 and 0.61). They are held instead to JAX's
   bfloat16 precision: max |port bf16 - JAX f32| between 0.5 and 1.5 times
   max |JAX bf16 - JAX f32| (measured 1.03, and 1.19 and 1.15), which a
   missing or an extra rounding to bfloat16 moves out of the band.
4. The configs default as JAX's: ``get_config()`` bfloat16,
   ``get_smoke_config()`` float32; other values raise; the Elucidator
   serves in bfloat16 by default and in float32 on the override.
5. The wrappers refuse a mix of dtypes that the JAX package never passes,
   and a pair-grid operand of the wrong dtype; the bfloat16 launch plans,
   and equi_update's for a 1-wide dist in both dtypes, cover every row once
   and fit the card.
6. ``tools/bf16_noise.py`` changes the kernel wrappers, at the model's
   call sites, as it says (``drop_k`` is the kernel with its gate
   products short of their last k step of 16) and restores them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as nn
from flax import traverse_util

from diffspectra_tpu.configs import diffspectra_qm9s, smoke
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.models.layers import modulate as jax_modulate
from diffspectra_tpu.ops.pallas_attention import mix_attention as jax_attention
from diffspectra_tpu.ops.pallas_block import block_fused as jax_block
from diffspectra_tpu.ops.pallas_equi_update import equi_update_fused as jax_equi
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.models.layers import Dense, layer_norm, modulate, silu
from diffspectra_tpu_torch.ops._row_tile import MAX_SMEM, SMEM_PER_SM
from diffspectra_tpu_torch.ops.block_fused import _DATA, _WEIGHTS, block_fused
from diffspectra_tpu_torch.ops.equi_update import equi_update
from diffspectra_tpu_torch.ops.equi_update import launch_plan as equi_plan
from diffspectra_tpu_torch.ops.mix_attention import launch_plan as attn_plan
from diffspectra_tpu_torch.ops.mix_attention import mix_attention
from diffspectra_tpu_torch.warm_state import load_model_state, load_warm_state, random_variables
from test_torch_block import block_case
from test_torch_dmt import _inputs, _jax_forward, _torch_forward
from test_torch_ops import _attn_inputs, _equi_inputs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")
BF16 = torch.bfloat16


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.array(a)).to(BF16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


# ---- 1. the layers ----------------------------------------------------------

def _one_step_at_most(got, want, share):
    """Each value equal or one bfloat16 step off, at most ``share`` off."""
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step)
    assert (got != want).sum() <= share * want.size


def test_dense_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 29, 256)).astype(np.float32)
    kernel = (rng.normal(size=(256, 192)) / 16).astype(np.float32)
    bias = (rng.normal(size=(192,)) * 0.1).astype(np.float32)
    want = nn.Dense(192, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    dense = Dense(256, 192, dtype=BF16)
    dense.load_state_dict({"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias)})
    got = dense(torch.from_numpy(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    _one_step_at_most(_f32(got), _f32(want), 1e-4)


def test_dense_casts_its_parameters_at_load_not_per_call():
    dense = Dense(64, 32, dtype=BF16)
    rng = np.random.default_rng(2)
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((64, 32), (32,))]
    dense.load_state_dict({"kernel": w[0], "bias": w[1]})
    assert dense.kernel.dtype == torch.float32 and dense.kernel_cast.dtype == BF16
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(BF16)
    with torch.no_grad(), torch.profiler.profile() as prof:  # serving: no gradients
        got = dense(x)
    assert "aten::_to_copy" not in {e.key for e in prof.key_averages()}
    assert torch.equal(got, x @ w[0].to(BF16) + w[1].to(BF16))
    assert "kernel_cast" not in dense.state_dict()
    # with gradients (training) the live parameter is cast, so it gets one
    dense(x).float().sum().backward()
    assert dense.kernel.grad is not None and dense.bias.grad is not None


def test_bf16_weight_copies_follow_each_load():
    """A second load_state_dict makes the bfloat16 copies anew: the model
    then computes as one that only ever held the second weights."""
    narrow = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
              "training.matmul_precision": "bfloat16"}
    config = configs.apply_overrides(configs.get_smoke_config(), narrow)
    inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 9, [3501], True)
    first, second = DMT.from_config(config), DMT.from_config(config)
    load_model_state(first, random_variables(first, seed=0))
    before = _torch_forward(first, inp, True)
    load_model_state(first, random_variables(first, seed=1))
    load_model_state(second, random_variables(second, seed=1))
    after = _torch_forward(first, inp, True)
    for a, b, s in zip(after, before, _torch_forward(second, inp, True)):
        assert np.array_equal(a, s) and not np.array_equal(a, b)


def test_silu_matches_flax_bit_for_bit():
    y = (np.random.default_rng(1).normal(size=(64, 1024)) * 3).astype(np.float32)
    want = nn.silu(_jbf(y))
    got = silu(_tbf(y))
    assert got.dtype == BF16
    assert (_f32(got) != _f32(want)).sum() == 0


def _ln_inputs():
    rng = np.random.default_rng(2)
    e = rng.normal(size=(4, 29, 29, 64)).astype(np.float32)
    shift = (rng.normal(size=(4, 1, 1, 64)) * 0.3).astype(np.float32)
    scale = (rng.normal(size=(4, 1, 1, 64)) * 0.3).astype(np.float32)
    return e, shift, scale


def test_bf16_modulation_matches_flax_bit_for_bit():
    e, shift, scale = _ln_inputs()
    ln = np.asarray(nn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)
                    .apply({}, _jbf(e)).astype(jnp.float32))
    want = jax_modulate(_jbf(ln), _jbf(shift), _jbf(scale))
    got = modulate(_tbf(ln), _tbf(shift), _tbf(scale))
    assert got.dtype == BF16
    assert (_f32(got) != _f32(want)).sum() == 0


def test_bf16_layer_norm_modulate_chain_matches_flax():
    e, shift, scale = _ln_inputs()
    ln = nn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)
    want_ln, got_ln = ln.apply({}, _jbf(e)), layer_norm(_tbf(e))
    assert want_ln.dtype == jnp.bfloat16 and got_ln.dtype == BF16
    _one_step_at_most(_f32(got_ln), _f32(want_ln), 1e-5)
    want = _f32(jax_modulate(want_ln, _jbf(shift), _jbf(scale)))
    got = _f32(modulate(got_ln, _tbf(shift), _tbf(scale)))
    ln_off = (_f32(got_ln) != _f32(want_ln)).any(axis=-1, keepdims=True)
    assert np.array_equal(got[~np.broadcast_to(ln_off, got.shape)],
                          want[~np.broadcast_to(ln_off, want.shape)])


# ---- 2. the kernels' plain versions ----------------------------------------

def test_mix_attention_plain_on_bf16_matches_jax_kernel():
    args = _attn_inputs(3, 2, 12, 64, 14, 18, 16, 16, 2)  # E*sc = 252
    bf = range(6)  # q, k, v, edge_attr, w0, w1
    jargs = [_jbf(a) if i in bf else jnp.asarray(a) for i, a in enumerate(args)]
    targs = [_tbf(a) if i in bf else torch.from_numpy(a) for i, a in enumerate(args)]
    want = np.asarray(jax_attention(*jargs, set_inf=True, interpret=True))
    got = mix_attention(*targs, set_inf=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_equi_update_plain_on_bf16_matches_jax_kernel():
    args = _equi_inputs(4, 2, 12, 64, 64, 256, 2)
    bf = (0, 1, 2, 3, 7, 8, 9)  # node_i, node_j, edge_attr, dist, w_e, w_d, bias
    jargs = [_jbf(a) if i in bf else jnp.asarray(a) for i, a in enumerate(args)]
    targs = [_tbf(a) if i in bf else torch.from_numpy(a) for i, a in enumerate(args)]
    want = np.asarray(jax_equi(*jargs, interpret=True))
    got = equi_update(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_block_fused_plain_on_bf16_qkv_matches_jax_kernel():
    arrays, kw = block_case(np.random.default_rng(5), [5, 8, 3], 8, 32, 4)
    bf = [_DATA.index(k) for k in ("q", "k", "v")]
    jargs = [_jbf(a) if i in bf else jnp.asarray(a) for i, a in enumerate(arrays)]
    targs = [_tbf(a) if i in bf else torch.from_numpy(a) for i, a in enumerate(arrays)]
    want = jax_block(*jargs, set_inf=True, interpret=True, **kw)
    got = block_fused(*targs, set_inf=True, **kw)
    for name, g, w in zip(("h_out", "edge_out", "agg"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)


# ---- 3. the DMT -------------------------------------------------------------

def _jax_dmt(cfg, precision, ops):
    cfg.training.matmul_precision = precision
    cfg.model.use_pallas = True
    cfg.model.pallas_ops = ops
    return JaxDMT.from_config(cfg)


def _within_half_the_gap(got, want_bf16, want_f32):
    for g, w, w32 in zip(got, want_bf16, want_f32):
        assert np.isfinite(g).all()
        err, gap = np.abs(g - w).max(), np.abs(w - w32).max()
        assert gap > 0 and err <= 0.5 * gap, (err, gap, err / gap)


@pytest.mark.parametrize("has_cond", [True, False])
@pytest.mark.parametrize("ops", [("attn", "equi"), ("block",)])
def test_narrow_bf16_dmt_matches_jax_bf16_pallas_path(monkeypatch, ops, has_cond):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    narrow = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
              "model.pallas_ops": ops, "training.matmul_precision": "bfloat16"}
    port = DMT.from_config(configs.apply_overrides(configs.get_smoke_config(), narrow))
    assert port.dtype == BF16
    flat = random_variables(port, seed=0)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 9, [3501], has_cond)
    want = {}
    for precision in ("bfloat16", "float32"):
        cfg = smoke.get_config()
        cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 4
        cfg.data.max_node = 8
        want[precision] = _jax_forward(_jax_dmt(cfg, precision, ops), variables, inp, has_cond,
                                       jit=True)
    _within_half_the_gap(_torch_forward(port, inp, has_cond), want["bfloat16"], want["float32"])


def test_full_width_bf16_forward_from_warm_weights_matches_jax(monkeypatch):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    flat = load_warm_state(WARM)["variables"]
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
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
    ops = ("attn", "equi")
    want = {p: _jax_forward(_jax_dmt(diffspectra_qm9s.get_config(), p, ops), variables, inp, True,
                            jit=True)
            for p in ("bfloat16", "float32")}
    port = DMT.from_config(configs.get_config())  # bfloat16, ('attn', 'equi'): the defaults
    load_model_state(port, flat)
    got = _torch_forward(port, inp, True)
    for g in got:
        assert 0.1 < np.abs(g).max() < 10  # in range, so that the bound means something
    _within_half_the_gap(got, want["bfloat16"], want["float32"])


# ---- 4. the configs and the entry point -------------------------------------

def _within_jax_bf16_precision(got, want_bf16, want_f32):
    """max |port bf16 - JAX f32| between 0.5 and 1.5 times max |JAX bf16 -
    JAX f32|, each output."""
    for g, w, w32 in zip(got, want_bf16, want_f32):
        own = np.abs(g - w32).max() / np.abs(w - w32).max()
        assert np.isfinite(g).all() and 0.5 <= own <= 1.5, (
            own, np.abs(g - w).max() / np.abs(w - w32).max())


def test_bf16_specformer_matches_jax():
    from diffspectra_tpu.models.specformer import SpecFormer as JaxSpecFormer
    from diffspectra_tpu_torch.models.specformer import SpecFormer

    port = SpecFormer("ir", output_dim=64, dtype=BF16)
    flat = random_variables(port, seed=0)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    spec = np.log10(np.abs(np.random.default_rng(2).normal(size=(4, 3501))) * 10 + 1)
    spec = spec.astype(np.float32)
    want = {dt: np.asarray(jax.jit(JaxSpecFormer(output_dim=64, dtype=dt).apply)(
        variables, jnp.asarray(spec))) for dt in (jnp.bfloat16, jnp.float32)}
    with torch.no_grad():
        got = port([torch.from_numpy(spec)]).numpy()
    _within_jax_bf16_precision([got], [want[jnp.bfloat16]], [want[jnp.float32]])


def test_narrow_dmt_with_bf16_specformer_matches_jax(monkeypatch):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    narrow = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
              "training.matmul_precision": "bfloat16", "model.specformer_bf16": True}
    port = DMT.from_config(configs.apply_overrides(configs.get_smoke_config(), narrow))
    assert port.cond_encoder.W_P_1.dtype == BF16 and port.cond_encoder.head_linear.dtype != BF16
    plain = DMT.from_config(configs.apply_overrides(configs.get_smoke_config(), {
        **narrow, "model.specformer_bf16": False}))
    assert plain.cond_encoder.W_P_1.dtype == torch.float32
    flat = random_variables(port, seed=0)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 9, [3501], True)
    want = {}
    for precision in ("bfloat16", "float32"):
        cfg = smoke.get_config()
        cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 4
        cfg.data.max_node, cfg.model.specformer_bf16 = 8, True
        want[precision] = _jax_forward(_jax_dmt(cfg, precision, ("attn", "equi")), variables,
                                       inp, True, jit=True)
    _within_jax_bf16_precision(_torch_forward(port, inp, True), want["bfloat16"],
                               want["float32"])


def test_configs_default_to_the_jax_dtypes():
    assert configs.get_config().training.matmul_precision == \
        diffspectra_qm9s.get_config().training.matmul_precision == "bfloat16"
    assert configs.get_smoke_config().training.matmul_precision == \
        smoke.get_config().training.matmul_precision == "float32"
    assert configs.model_dtype(configs.get_config()) == BF16
    assert configs.model_dtype(configs.get_smoke_config()) == torch.float32
    bad = configs.apply_overrides(configs.get_config(), {"training.matmul_precision": "highest"})
    with pytest.raises(ValueError, match="matmul_precision"):
        DMT.from_config(bad)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_elucidator_serves_in_the_configured_dtype(precision):
    overrides = {"sampling.steps": 2}
    if precision == "float32":
        overrides["training.matmul_precision"] = "float32"
    el = Elucidator.from_warm_state(WARM, overrides=overrides, device="cpu")
    want = BF16 if precision == "bfloat16" else torch.float32
    assert el.model.dtype == want
    assert el.model.blocks[0].e_block.ff_linear1.dtype == want
    data = generate(seed=5, size=1, max_n=29, fidelity=4)
    n = int(data["num_atom"][0])
    result = el.elucidate({k: data[k][0] for k in ("uv", "ir", "raman")}, n_atoms=n,
                          num_candidates=2, seed=0)
    assert sum(c.count for c in result.candidates) == 2
    assert all(np.isfinite(c.positions).all() for c in result.candidates)


# ---- 5. the wrappers' dtypes and the bfloat16 launch plans -------------------

def _attn_args(dtypes):
    args = [torch.from_numpy(a) for a in _attn_inputs(6, 2, 8, 16, 3, 4, 4, 3, 1)]
    return [a.to(dtypes.get(i, a.dtype)) for i, a in enumerate(args)]


def _equi_args(dtypes):
    args = [torch.from_numpy(a) for a in _equi_inputs(7, 2, 8, 16, 16, 32, 2)]
    return [a.to(dtypes.get(i, a.dtype)) for i, a in enumerate(args)]


def _block_args(dtypes):
    arrays, kw = block_case(np.random.default_rng(8), [5, 8], 8, 32, 4)
    args = [torch.from_numpy(a) for a in arrays]
    return [a.to(dtypes.get(_DATA[i] if i < len(_DATA) else i, a.dtype))
            for i, a in enumerate(args)], kw


ATTN_BF16 = dict.fromkeys(range(6), BF16)
EQUI_BF16 = dict.fromkeys((0, 1, 2, 3, 7, 8, 9), BF16)
GUARDS = {  # a dtype mix the JAX package never passes -> TypeError
    "attn_q_bf16_edge_f32": ("attn", {0: BF16}),
    "attn_edge_bf16_w0_f32": ("attn", {**ATTN_BF16, 4: torch.float32}),
    "attn_extra_bf16": ("attn", {**ATTN_BF16, 6: BF16}),       # pair grid: extra
    "attn_mask_bf16": ("attn", {**ATTN_BF16, 7: BF16}),        # pair grid: edge_mask
    "attn_edge_f16": ("attn", dict.fromkeys(range(6), torch.float16)),
    "equi_dist_f32_edge_bf16": ("equi", {**EQUI_BF16, 3: torch.float32}),  # pair grid: dist
    "equi_normed_bf16": ("equi", {**EQUI_BF16, 4: BF16}),      # pair grid: normed_diff
    "equi_adj_bf16": ("equi", {**EQUI_BF16, 5: BF16}),         # pair grid: adj_extra
    "equi_shift_bf16": ("equi", {**EQUI_BF16, 10: BF16}),
    "equi_w0_bf16": ("equi", {**EQUI_BF16, 12: BF16}),
    "equi_node_i_bf16_only": ("equi", {0: BF16}),
    "block_q_bf16_k_f32": ("block", {"q": BF16, "v": BF16}),
    "block_edge_in_bf16": ("block", {"q": BF16, "k": BF16, "v": BF16, "edge_in": BF16}),
    "block_h_bf16": ("block", {"q": BF16, "k": BF16, "v": BF16, "h": BF16}),
    "block_weight_bf16": ("block", {"q": BF16, "k": BF16, "v": BF16, len(_DATA) + 17: BF16}),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_wrappers_refuse_dtype_mixes_jax_never_passes(case):
    kernel, dtypes = GUARDS[case]
    with pytest.raises(TypeError):
        if kernel == "attn":
            mix_attention(*_attn_args(dtypes), set_inf=True)
        elif kernel == "equi":
            equi_update(*_equi_args(dtypes))
        else:
            args, kw = _block_args(dtypes)
            block_fused(*args, set_inf=True, **kw)


def test_wrappers_take_the_jax_bf16_mixes_on_the_cpu():
    got = mix_attention(*_attn_args(ATTN_BF16), set_inf=True)
    want = mix_attention(*[a.float() for a in _attn_args(ATTN_BF16)], set_inf=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    got = equi_update(*_equi_args(EQUI_BF16))
    assert got.dtype == torch.float32 and torch.equal(
        got, equi_update(*[a.float() for a in _equi_args(EQUI_BF16)]))
    args, kw = _block_args({"q": BF16, "k": BF16, "v": BF16})
    assert all(o.dtype == torch.float32 for o in block_fused(*args, set_inf=True, **kw))


@pytest.mark.parametrize("batch", [1, 3, 10, 80, 128])
@pytest.mark.parametrize("n", [8, 17, 21, 25, 29, 32])
def test_bf16_launch_plans_cover_each_row_once_and_fit(n, batch):
    for plan in (attn_plan(batch, n, 64, 252, 256, 16, True),
                 equi_plan(batch, n, 64, 64, 256, True)):
        rows = [(b, i0 + r) for b, i0, k in plan.row_tiles() for r in range(k)]
        assert sorted(rows) == [(b, i) for b in range(batch) for i in range(n)]
        assert all(k * n <= plan.tile_rows for _, _, k in plan.row_tiles())
        assert plan.smem <= MAX_SMEM
        assert 1 <= plan.blocks_per_sm and plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("batch", [1, 10, 80, 128])
@pytest.mark.parametrize("n", [8, 17, 21, 25, 29, 32])
def test_dd1_launch_plans_cover_each_row_once_and_fit(n, batch, bf16):
    """equi_update's plans for a 1-wide dist (``dist_gbf=False``), in
    bfloat16 (no dist column in the slab) and in float32."""
    plan = equi_plan(batch, n, 64, 1, 256, bf16)
    rows = [(b, i0 + r) for b, i0, k in plan.row_tiles() for r in range(k)]
    assert sorted(rows) == [(b, i) for b in range(batch) for i in range(n)]
    assert all(k * n <= plan.tile_rows for _, _, k in plan.row_tiles())
    assert plan.smem <= MAX_SMEM
    assert 1 <= plan.blocks_per_sm and plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_PER_SM
    assert plan.smem <= equi_plan(batch, n, 64, 16, 256, bf16).smem


def test_bf16_plans_reckon_the_bf16_slabs():
    """The shared memory the kernels' notes give at the flagship widths:
    109,856 bytes (mix_attention) and 109,312 (equi_update) for tiles of 64
    rows, two blocks an SM."""
    attn, equi = attn_plan(80, 29, 64, 252, 256, 16, True), equi_plan(80, 29, 64, 64, 256, True)
    assert (attn.tile_rows, attn.rows_per_tile, attn.smem, attn.blocks_per_sm) == (64, 2, 109856, 2)
    assert (equi.tile_rows, equi.rows_per_tile, equi.smem, equi.blocks_per_sm) == (64, 2, 109312, 2)


# ---- 6. the bf16 noise tool's changes to the kernel wrappers ----------------

def test_noise_tool_changes_each_wrapper_as_it_says_and_restores_it():
    from diffspectra_tpu_torch.models import dmt as port_dmt
    from diffspectra_tpu_torch.models import layers as port_layers
    from diffspectra_tpu_torch.tools.bf16_noise import K_STEP, perturbed

    attn = [torch.from_numpy(a) for a in _attn_inputs(3, 2, 12, 64, 14, 18, 16, 16, 2)]
    equi = [torch.from_numpy(a) for a in _equi_inputs(4, 2, 12, 64, 64, 256, 2)]
    block, kw = _block_args({})
    names = _DATA + _WEIGHTS

    def short(args, idx):  # the gate weights without their last k step
        args = [a.clone() for a in args]
        for i in idx:
            args[i][-K_STEP:] = 0
        return args

    with perturbed("drop_k"):
        got = (port_layers.mix_attention(*attn, set_inf=True), port_dmt.equi_update(*equi),
               port_dmt.block_fused(*block, set_inf=True, **kw))
    want = (mix_attention(*short(attn, (4, 5)), set_inf=True), equi_update(*short(equi, (8,))),
            block_fused(*short(block, [names.index(w) for w in ("w0a", "w1a", "w_d")]),
                        set_inf=True, **kw))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))
    assert not torch.equal(got[0], mix_attention(*attn, set_inf=True))

    plain = equi_update(*equi)
    with perturbed("bf16"):
        assert torch.equal(port_dmt.equi_update(*equi), plain.to(BF16).float())
    with perturbed("ulp", seed=0):
        moved = port_dmt.equi_update(*equi)
    rel = ((moved - plain) / plain.abs().clamp_min(1e-30)).abs()
    assert 0 < rel.max() <= 2.0 ** -22 * 8
    assert (port_layers.mix_attention, port_dmt.equi_update, port_dmt.block_fused) == \
        (mix_attention, equi_update, block_fused)

