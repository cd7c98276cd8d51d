"""The port's DMT against the JAX DMT on the same weights and inputs.

1. A small DMT (smoke dims, 2 layers) against JAX with both Pallas kernels
   switched in (``use_pallas=True, pallas_ops=('attn','equi')``, interpret
   mode), with and without self-conditioning inputs. Tolerance rtol = atol
   = 2e-4, as ``tests/test_pallas_dispatch.py`` holds the two JAX paths.
2. The full-width flagship forward from the EMA weights of
   ``artifacts/warm_qm9s_as.npz`` at B=2, N=12, against the JAX XLA path in
   float32 at ``highest`` matmul precision. Tolerance: 1e-3 of the largest
   |value| of each output, since 8 blocks sum in another order. The same
   for the IR-only state ``artifacts/warm_qm9s_ir.npz``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import diffspectra_qm9s, smoke
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.warm_state import load_model_state, load_warm_state, random_variables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")


def _inputs(rng, n_nodes, n, xh_dim, spec_lens, has_cond):
    """Seeded numpy inputs shared by both frameworks."""
    bs = len(n_nodes)
    node_mask, edge_mask = (np.array(a) for a in JM.build_masks(jnp.asarray(n_nodes), n))
    xh = rng.normal(size=(bs, n, xh_dim)).astype(np.float32) * node_mask
    edge_x = rng.normal(size=(bs, n, n, 2)).astype(np.float32)
    edge_x = (edge_x + edge_x.transpose(0, 2, 1, 3)) * edge_mask[..., None]
    cond_x = (rng.normal(size=xh.shape).astype(np.float32) * node_mask if has_cond
              else np.zeros_like(xh))
    cond_e = (rng.normal(size=edge_x.shape).astype(np.float32) * edge_mask[..., None]
              if has_cond else np.zeros_like(edge_x))
    return dict(
        t=np.full((bs,), 0.5, np.float32),
        xh=xh, node_mask=node_mask, edge_mask=edge_mask, edge_x=edge_x,
        noise_level=rng.normal(size=(bs,)).astype(np.float32),
        cond_x=cond_x, cond_edge_x=cond_e,
        specs=[np.log10(np.abs(rng.normal(size=(bs, L))).astype(np.float32) * 10 + 1)
               for L in spec_lens],
    )


def _jax_forward(model, variables, inp, has_cond):
    specs = [jnp.asarray(s) for s in inp["specs"]]
    ctx = jax_encode_context(model, variables, specs if len(specs) > 1 else specs[0])
    pred, edge = model.apply(
        variables, jnp.asarray(inp["t"]), jnp.asarray(inp["xh"]),
        jnp.asarray(inp["node_mask"]), jnp.asarray(inp["edge_mask"]), None,
        edge_x=jnp.asarray(inp["edge_x"]), noise_level=jnp.asarray(inp["noise_level"]),
        cond_x=jnp.asarray(inp["cond_x"]), cond_edge_x=jnp.asarray(inp["cond_edge_x"]),
        has_cond=has_cond, context_emb=ctx,
    )
    return np.asarray(pred), np.asarray(edge)


def _torch_forward(model, inp, has_cond):
    T = {k: torch.from_numpy(v) for k, v in inp.items() if k != "specs"}
    with torch.no_grad():
        ctx = model.encode_context([torch.from_numpy(s) for s in inp["specs"]])
        pred, edge = model(
            T["t"], T["xh"], T["node_mask"], T["edge_mask"], T["edge_x"], T["noise_level"],
            T["cond_x"] if has_cond else None, T["cond_edge_x"] if has_cond else None,
            has_cond, ctx,
        )
    return pred.numpy(), edge.numpy()


@pytest.mark.parametrize("has_cond", [True, False])
def test_small_dmt_matches_jax_pallas_path(monkeypatch, has_cond):
    monkeypatch.setenv("DIFFSPECTRA_PALLAS_INTERPRET", "1")
    cfg = smoke.get_config()
    cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 2, 4
    cfg.data.max_node = 8
    cfg.model.use_pallas = True
    cfg.model.pallas_ops = ("attn", "equi")
    model = JaxDMT.from_config(cfg)
    assert model.use_pallas

    pcfg = configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8})
    port = DMT.from_config(pcfg)
    flat = random_variables(port, seed=0)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )

    inp = _inputs(np.random.default_rng(0), [5, 7, 6, 8], 8, 9, [3501], has_cond)
    want_pred, want_edge = _jax_forward(model, variables, inp, has_cond)
    got_pred, got_edge = _torch_forward(port, inp, has_cond)

    np.testing.assert_allclose(got_pred, want_pred, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_edge, want_edge, rtol=2e-4, atol=2e-4)


def _warm_forward_matches_jax(path, spectra_version, spec_keys):
    state = load_warm_state(path)
    flat = state["variables"]
    cfg = diffspectra_qm9s.get_config()
    cfg.data.spectra_version = spectra_version
    cfg.training.matmul_precision = "float32"  # f32 DMT, as the port
    model = JaxDMT.from_config(cfg)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )

    rng = np.random.default_rng(1)
    lens = {"uv": 701, "ir": 3501, "raman": 3501}
    inp = _inputs(rng, [12, 9], 12, 9, [lens[k] for k in spec_keys], True)
    # the warm model's operating range: conditioning inside its clamp range,
    # spectra of synthetic molecules, noise levels across the schedule
    nm, em = inp["node_mask"], inp["edge_mask"]
    inp["cond_x"] = np.concatenate(
        [rng.normal(size=(2, 12, 3)) * 1.5, rng.uniform(-0.25, 0.25, size=(2, 12, 6))], -1
    ).astype(np.float32) * nm
    c = rng.uniform(-1, 1, size=(2, 12, 12, 2)).astype(np.float32)
    inp["cond_edge_x"] = 0.5 * (c + c.transpose(0, 2, 1, 3)) * em[..., None]
    data = generate(seed=3, size=2, max_n=12, fidelity=4)
    inp["specs"] = [np.log10(data[k] + 1.0).astype(np.float32) for k in spec_keys]
    inp["noise_level"] = np.asarray([-6.0, 4.0], np.float32)
    with jax.default_matmul_precision("highest"):
        want_pred, want_edge = _jax_forward(model, variables, inp, True)

    port = DMT.from_config(configs.apply_overrides(
        configs.get_config(), {"data.spectra_version": spectra_version}))
    load_model_state(port, flat)
    got_pred, got_edge = _torch_forward(port, inp, True)

    assert np.isfinite(got_pred).all() and np.isfinite(got_edge).all()
    for got, want in ((got_pred, want_pred), (got_edge, want_edge)):
        scale = np.abs(want).max()
        assert 0.1 < scale < 10  # in range, so that the tolerance means something
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


def test_flagship_forward_from_warm_weights_matches_jax():
    _warm_forward_matches_jax(WARM, "allspectra", ("uv", "ir", "raman"))


def test_ir_forward_from_warm_weights_matches_jax():
    """The IR-only warm state (``data.spectra_version='ir'``), the same way."""
    _warm_forward_matches_jax(os.path.join(ROOT, "artifacts", "warm_qm9s_ir.npz"), "ir",
                              ("ir",))
