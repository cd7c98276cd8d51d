"""The port's layers against the flax layers on the same parameters, handed
over with ``params_from_flax``: CondGaussian basis, CoorsNorm,
DenseTransMixLayer, SpecFormer (eval mode, running BatchNorm statistics),
MultiCondEquiUpdate and one EquivariantMixBlock; and the traps of the
reference (tanh GELU, no-affine LayerNorm with eps 1e-6, chunk orders).

All in float32 on the CPU at small widths. Tolerance atol 2e-5 (rtol 1e-5)
for single layers; 1e-4 for SpecFormer and the block, whose several
LayerNorms and softmaxes sum in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from diffspectra_tpu.models import dmt as jdmt
from diffspectra_tpu.models import layers as jl
from diffspectra_tpu.models import specformer as jsf
from diffspectra_tpu_torch.models import dmt as tdmt
from diffspectra_tpu_torch.models import layers as tl
from diffspectra_tpu_torch.models import specformer as tsf
from diffspectra_tpu_torch.warm_state import params_from_flax

torch.set_num_threads(2)

B, N = 2, 6


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _masks(n_nodes):
    nm = (np.arange(N)[None] < np.asarray(n_nodes)[:, None]).astype(np.float32)
    em = nm[:, :, None] * nm[:, None, :] * (1.0 - np.eye(N, dtype=np.float32))
    return nm[..., None], em


def _flax_variables(module, seed, *args, **kwargs):
    """flax init, with every leaf nudged so that zero-initialised biases and
    unit running variances are not special; variances stay positive."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    out = {}
    for k, v in flat.items():
        v = np.asarray(v) + _np(rng, *np.shape(v), scale=0.05)
        out[k] = np.abs(v) + 0.5 if k.endswith("/var") else v
    return out


def _port(module, flat):
    module.load_state_dict(params_from_flax(flat), strict=True)
    return module.eval()


def _apply(module, flat, *args, **kwargs):
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    return np.asarray(module.apply(variables, *args, **kwargs))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_cond_gaussian_layer():
    rng = np.random.default_rng(0)
    x = np.abs(_np(rng, B, N, N, 1)) * 3
    temb = _np(rng, B, 16)
    mod = jl.CondGaussianLayer(8, 16)
    flat = _flax_variables(mod, 0, x, temb)
    want = _apply(mod, flat, x, temb)
    with torch.no_grad():
        got = _port(tl.CondGaussianLayer(8, 16), flat)(*_t(x, temb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_coors_norm_keeps_zero_vectors_at_zero():
    rng = np.random.default_rng(1)
    pos = _np(rng, B, N, 3)
    diff = pos[:, :, None] - pos[:, None]  # exact zeros on the diagonal
    mod = jl.CoorsNorm(scale_init=1e-2)
    flat = _flax_variables(mod, 1, diff)
    want = _apply(mod, flat, diff)
    with torch.no_grad():
        got = _port(tl.CoorsNorm(), flat)(*_t(diff)).numpy()
    assert np.all(got[:, np.arange(N), np.arange(N)] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n_extra_given", [2, 1])
def test_dense_trans_mix_layer(n_extra_given):
    rng = np.random.default_rng(2)
    x = _np(rng, B, N, 32)
    edge = _np(rng, B, N, N, 8)
    extra = (rng.random((B, N, N, n_extra_given)) > 0.5).astype(np.float32)
    _, em = _masks([6, 4])
    mod = jl.DenseTransMixLayer(32, 8, extra_heads=2, heads=4, set_inf=True)
    flat = _flax_variables(mod, 2, x, edge, extra, em)
    want = _apply(mod, flat, x, edge, extra, em)
    port = _port(tl.DenseTransMixLayer(32, 8, 8, extra_heads=2, heads=4, set_inf=True), flat)
    with torch.no_grad():
        got = port(*_t(x, edge, extra, em)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_specformer_eval_mode():
    rng = np.random.default_rng(3)
    specs = tuple(np.log10(np.abs(_np(rng, B, L)) * 10 + 1) for L in (701, 3501, 3501))
    mod = jsf.SpecFormer(output_dim=16, spectra_version="allspectra", n_layers=2,
                         d_model=32, n_heads=4, d_ff=64)
    flat = _flax_variables(mod, 3, specs)
    assert any(k.startswith("batch_stats/") for k in flat)
    want = _apply(mod, flat, specs, deterministic=True)
    port = _port(tsf.SpecFormer("allspectra", output_dim=16, n_layers=2, d_model=32,
                                n_heads=4, d_ff=64), flat)
    with torch.no_grad():
        got = port(_t(*specs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_multi_cond_equi_update_shift_scale_order():
    """The time MLP's two chunks are (shift, scale), in that order."""
    rng = np.random.default_rng(4)
    h, pos = _np(rng, B, N, 32), _np(rng, B, N, 3)
    edge, dist = _np(rng, B, N, N, 8), _np(rng, B, N, N, 8)
    temb = _np(rng, B, 16)
    adj = (rng.random((B, N, N, 2)) > 0.5).astype(np.float32)
    _, em = _masks([6, 5])
    mod = jdmt.MultiCondEquiUpdate(32, 8, 8, 16, 2)
    flat = _flax_variables(mod, 4, h, pos, edge, dist, temb, adj, em)
    want = _apply(mod, flat, h, pos, edge, dist, temb, adj, em)
    port = _port(tdmt.MultiCondEquiUpdate(32, 8, 8, 16, 2), flat)
    with torch.no_grad():
        got = port(*_t(h, pos, edge, dist, temb, adj, em)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_equivariant_mix_block_six_way_split():
    """One block: the 6-way adaLN split (shift_msa, scale_msa, gate_msa,
    shift_mlp, scale_mlp, gate_mlp) and both kernels' callers."""
    rng = np.random.default_rng(5)
    pos, h = _np(rng, B, N, 3), _np(rng, B, N, 32)
    edge = _np(rng, B, N, N, 8)
    temb = _np(rng, B, 16)
    nm, em = _masks([6, 3])
    adj = (rng.random((B, N, N, 2)) > 0.5).astype(np.float32) * em[..., None]
    mod = jdmt.EquivariantMixBlock(32, 8, 16, 2, 4)
    args = (pos, h, edge, nm, em, adj, temb, temb)
    flat = _flax_variables(mod, 5, *args)
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    want = [np.asarray(o) for o in mod.apply(variables, *args)]
    port = _port(tdmt.EquivariantMixBlock(32, 8, 16, 2, 4), flat)
    with torch.no_grad():
        got = port(*_t(pos, h, edge, nm, em, adj, temb))
    for g, w in zip(got, want):  # h_out, edge_out, pos
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_gelu_is_flax_tanh_approximation():
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = tl.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the exact GELU would not do


def test_layer_norm_has_no_affine_and_eps_1e6():
    rng = np.random.default_rng(6)
    x = _np(rng, 4, 64, scale=1e-3)  # variance ~1e-6: eps matters
    ln = fnn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)
    want = np.asarray(ln.apply({}, jnp.asarray(x)))
    got = tl.layer_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    other = torch.nn.functional.layer_norm(torch.from_numpy(x), (64,), eps=1e-5).numpy()
    assert np.abs(other - want).max() > 1e-2  # torch's default eps would not do
