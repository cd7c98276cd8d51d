"""The rest of the port's serving against the JAX package: the atom-count
head, the marginal over atom counts, ``elucidate_batch`` and DPM-Solver.

- The count head: the committed ``artifacts/atom_count_head.npz`` loaded by
  both packages gives the same probabilities on a seeded embedding within
  atol 1e-5 (its logits reach |120|, where float32 rounding is about 1e-5:
  both packages sit 4-5e-5 off a float64 evaluation, and the softmax
  passes that on; measured 1.9e-6) and the same ``top_counts``;
  ``encode_spec_pooled`` agrees with JAX at the smoke size within 1e-4
  (the SpecFormer forward, as ``test_torch_layers.py`` holds it); a head
  for another ``max_n`` than ``data.max_node`` is refused.
- The marginal and the batch logic run against the JAX ``Elucidator``'s own
  methods on the same decoded draws: both packages' rounds are replaced by
  one fake that decodes fixed molecules, so the counts tried, the draws per
  count, the rounds' sizes and the consensus ranking (with its tie-break by
  the count's prior) must be equal, with no tolerance.
- DPM-Solver: a small DMT, 5 steps of the ODE from a shared ``z_T``, atom
  types and bonds identical and positions within atol 2e-3 (the argument of
  ``test_torch_sampler.py``); the SDE's per-step coefficient identities, as
  ``tests/test_dpm_solver.py`` asserts them for JAX.
- Every serving mode end to end on the CPU at a tiny size.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.api import Elucidator as JaxElucidator
from diffspectra_tpu.configs import smoke
from diffspectra_tpu.diffusion.schedule import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.models import atom_count as jac
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.models.dmt import encode_context as jax_encode_context
from diffspectra_tpu.sampling import decode as jdec
from diffspectra_tpu.sampling.ancestral import make_time_steps as jax_time_steps
from diffspectra_tpu.sampling.dpm_solver import DPMSolverPP as JaxDPM
from diffspectra_tpu.utils import masks as JM
from diffspectra_tpu.utils import scalers as jsc
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.models import atom_count as ac
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.sampling import decode as tdec
from diffspectra_tpu_torch.sampling.ancestral import make_time_steps
from diffspectra_tpu_torch.sampling.dpm_solver import DPMSolverPP
from diffspectra_tpu_torch.utils import scalers as tsc
from diffspectra_tpu_torch.warm_state import load_model_state, random_variables
from test_torch_dmt import ROOT

torch.set_num_threads(2)

HEAD = f"{ROOT}/artifacts/atom_count_head.npz"
TINY = {"model.nf": 32, "model.n_layers": 1, "model.n_heads": 4, "sampling.steps": 2}
INFO = get_dataset_info("qm9_second_half")


def _tiny_elucidator(overrides=None):
    config = configs.apply_overrides(configs.get_smoke_config(), {**TINY, **(overrides or {})})
    model = DMT.from_config(config)
    load_model_state(model, random_variables(model, seed=0))
    return Elucidator(config, model.eval(), torch.device("cpu"))


def _jax_stub(max_node, buckets):
    """A JAX ``Elucidator`` without a model: its serving logic only."""
    cfg = smoke.get_config()
    cfg.data.max_node = max_node
    cfg.eval.bucket_sizes = buckets
    el = object.__new__(JaxElucidator)
    el.config, el.dataset_info = cfg, INFO
    el._count_head, el._vars_on_device, el.variables = None, True, None
    return el


def _fake_mols(n_nodes, tag):
    """Decoded draws: row d is a chain of n_nodes[d] atoms whose types
    follow ``tag[d]`` (so the rows' WL hashes tell them apart)."""
    bs, n = len(n_nodes), max(n_nodes)
    one_hot = np.zeros((bs, n, 5), np.float32)
    edge = np.zeros((bs, n, n), np.float32)
    for d, (m, t) in enumerate(zip(n_nodes, tag)):
        one_hot[d, np.arange(m), (np.arange(m) + int(t)) % 2 + 1] = 1.0
        edge[d, np.arange(m - 1), np.arange(1, m)] = 1.0
        edge[d, np.arange(1, m), np.arange(m - 1)] = 1.0
    pos = np.zeros((bs, n, 3), np.float32)
    fc = np.zeros((bs, n, 1), np.float32)
    return pos, one_hot, fc, edge


def _ranking(result):
    return [(c.molgraph.wl_hash(), c.count, c.first_draw, c.molgraph.n_atoms)
            for c in result.candidates]


# ---------------------------------------------------------------- count head

def test_count_head_matches_jax_on_the_committed_head():
    jhead, jparams, jmeta = jac.load_head(HEAD)
    head, meta = ac.load_head(HEAD, "cpu")
    assert meta == jmeta and head.max_n == jhead.max_n == 29
    emb = np.random.default_rng(0).normal(size=(4, 256)).astype(np.float32)
    want = np.asarray(jac.predict_count_probs(jhead, jparams, jnp.asarray(emb)))
    with torch.no_grad():
        got = ac.predict_count_probs(head, torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for kw in (dict(), dict(coverage=0.5, cap=2), dict(coverage=0.99, cap=6)):
        assert ac.top_counts(want, **kw) == jac.top_counts(want, **kw)
    probs = np.zeros((1, 30))
    probs[0, [0, 9, 12]] = [0.5, 0.3, 0.2]  # an implausible count 0 is dropped
    assert ac.top_counts(probs, coverage=0.85) == jac.top_counts(probs, coverage=0.85)


def test_encode_spec_pooled_matches_jax():
    config = configs.apply_overrides(configs.get_smoke_config(), TINY)
    port = DMT.from_config(config)
    flat = random_variables(port, seed=4)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    cfg = smoke.get_config()
    cfg.model.nf, cfg.model.n_layers, cfg.model.n_heads = 32, 1, 4
    spec = np.log10(generate(seed=5, size=3, max_n=16, fidelity=4)["ir"] + 1.0).astype(np.float32)
    want = np.asarray(jac.encode_spec_pooled(JaxDMT.from_config(cfg), variables,
                                             jnp.asarray(spec)))
    with torch.no_grad():
        got = ac.encode_spec_pooled(port.eval(), [torch.from_numpy(spec)]).numpy()
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_load_count_head_refuses_another_max_n(tmp_path):
    el = _tiny_elucidator()  # data.max_node = 16
    with pytest.raises(ValueError, match="max_node=16"):
        el.load_count_head(HEAD)  # max_n 29
    with np.load(HEAD) as npz:
        arrays = {k: npz[k] for k in npz.files}
    meta = json.loads(str(arrays["__meta__"]))
    doctored = str(tmp_path / "head.npz")
    arrays["__meta__"] = np.asarray(json.dumps({**meta, "max_n": 28}))
    arrays["p/out/kernel"] = arrays["p/out/kernel"][:, :29]  # counts 0..28
    arrays["p/out/bias"] = arrays["p/out/bias"][:29]
    np.savez(doctored, **arrays)
    el29 = _tiny_elucidator({"data.max_node": 29})
    with pytest.raises(ValueError, match="up to 28"):
        el29.load_count_head(doctored)
    assert el29.load_count_head(HEAD) == meta


def test_load_head_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ac.load_head(HEAD)
    head, _ = ac.load_head(HEAD, "cpu")
    assert head.out.kernel.device == torch.device("cpu")


# ---------------------------------------------------------------- marginal

@pytest.mark.parametrize("num_candidates,draws_per_n,use_head", [
    (10, None, False), (40, None, False), (10, 3, False), (10, None, True),
])
def test_marginal_matches_jax(num_candidates, draws_per_n, use_head):
    buckets = (17, 21, 25, 29)
    jel = _jax_stub(29, buckets)
    el = _tiny_elucidator({"data.max_node": 29, "eval.bucket_sizes": buckets})
    assert el._plausible_n() == JaxElucidator._plausible_n(jel)
    assert el._plausible_n(0.5, 3) == JaxElucidator._plausible_n(jel, 0.5, 3)
    if use_head:
        counts = ([19, 17, 21], {19: 0.5, 17: 0.3, 21: 0.2})
        jel._count_head = el._count_head = object()
        jel._predict_counts = el._predict_counts = lambda context: counts

    rounds = {"jax": [], "port": []}

    def jax_round_fn(K, n_pad):
        def run(variables, key, ctx, n_vec):
            n_vec = np.asarray(n_vec)
            rounds["jax"].append((K, n_pad, int(n_vec[0])))
            return _fake_mols(list(n_vec), np.arange(K) % 2)
        return run

    def port_round(contexts, n_atoms, n_pad, generator):
        K = len(n_atoms)
        rounds["port"].append((K, n_pad, n_atoms[0]))
        out = [torch.from_numpy(a) for a in _fake_mols(list(n_atoms), np.arange(K) % 2)]
        return tdec.mol_process(out[1], out[0], out[2], list(n_atoms), out[3])

    jel._round_fn = jax_round_fn
    el._round = port_round
    spectrum = np.ones(3501, np.float32)
    want = JaxElucidator._elucidate_marginal(jel, spectrum, num_candidates, 0, False, draws_per_n)
    got = el.elucidate(spectrum, n_atoms=None, num_candidates=num_candidates,
                       draws_per_n=draws_per_n)
    assert rounds["port"] == rounds["jax"] and rounds["port"]
    assert got.n_atoms is None and got.num_draws == want.num_draws
    assert _ranking(got) == _ranking(want)
    # each count gives two structures of equal frequency: the tie-break by
    # the count's prior decides the order
    assert [c.count for c in got.candidates] == sorted((c.count for c in got.candidates),
                                                       reverse=True)


# ---------------------------------------------------------------- batch

def test_elucidate_batch_matches_jax():
    buckets = (17, 21, 25, 29)
    jel = _jax_stub(29, buckets)
    el = _tiny_elucidator({"data.max_node": 29, "eval.bucket_sizes": buckets})
    n_list = [19, None, 12, 23, None, 20, 18, 29, 21]
    seed, K, qpr = 11, 3, 2
    host = np.random.default_rng(seed)
    drawn = [JaxElucidator._sample_n_atoms(jel, host) if n is None else n for n in n_list]
    spectra = [np.full(3501, q, np.float32) for q in range(len(n_list))]

    rounds = {"jax": [], "port": []}

    def jax_round_fn(batch, n_pad):
        def run(variables, key, ctx, n_vec):
            rounds["jax"].append((batch, n_pad))
            return _fake_mols(list(np.asarray(n_vec)), np.asarray(ctx)[:, 0])
        return run

    def port_round(contexts, n_atoms, n_pad, generator):
        rounds["port"].append((len(n_atoms), n_pad))
        out = [torch.from_numpy(a) for a in
               _fake_mols(list(n_atoms), [c[0][0] for c in contexts])]
        return tdec.mol_process(out[1], out[0], out[2], list(n_atoms), out[3])

    jel._round_fn = jax_round_fn
    jel._prepare_context = lambda spec, normalized: spec  # log10 is the same in both
    el._round = port_round
    el._prepare_context = lambda spec, normalized: (spec,)
    want = JaxElucidator.elucidate_batch(jel, spectra, n_list, num_candidates=K, seed=seed,
                                         queries_per_round=qpr)
    got = el.elucidate_batch(spectra, n_list, num_candidates=K, seed=seed,
                             queries_per_round=qpr)
    assert rounds["port"] == rounds["jax"]
    assert all(batch == qpr * K for batch, _ in rounds["port"])
    assert [r.n_atoms for r in got] == [r.n_atoms for r in want] == drawn
    for q, (g, w) in enumerate(zip(got, want)):
        assert g.num_draws == K and sum(c.count for c in g.candidates) == K
        assert _ranking(g) == _ranking(w)
        # the draws of query q decode its own spectrum (tag q), in input order
        assert [s for s in g.best.molgraph.atom_syms[:2]] == \
            ["N" if q % 2 else "C", "C" if q % 2 else "N"]


# ---------------------------------------------------------------- DPM-Solver

def test_dpm_solver_ode_matches_jax():
    steps, n, n_nodes = 5, 8, [8, 6, 7, 5]
    bs = len(n_nodes)
    pcfg = configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": n})
    port = DMT.from_config(pcfg)
    flat = random_variables(port, seed=5)
    load_model_state(port, flat)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
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

    jsch = JaxSchedule(cfg.sde.schedule)
    jsampler = JaxDPM(jsch, jax_time_steps(jsch, steps), cfg.model.pred_data, pred_edge=True,
                      self_cond=True, cond_process_fn=jsc.get_self_cond_fn(cfg))

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
    sampler = DPMSolverPP(sch, make_time_steps(sch, steps), pcfg.model.pred_data,
                          self_cond=True, cond_process_fn=tsc.get_self_cond_fn(pcfg))
    T = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        tctx = port.encode_context([T(spec)])
        tx, te = sampler.sampling(port, torch.Generator().manual_seed(0), T(z), T(node_mask),
                                  T(edge_mask), T(edge_z), tctx)
    tout = tdec.post_process(tx, 5, T(node_mask), tsc.get_data_inverse_scaler(pcfg),
                             te, T(edge_mask))
    tmols = tdec.mol_process(tout[1], tout[0], tout[2], n_nodes, tout[3])

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2e-3)
    for (tp, ta, tb, tf), (jp, ja, jb, jf) in zip(tmols, jmols):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-3)


@pytest.mark.parametrize("steps", [8, 100])
def test_dpm_solver_coefficients_match_jax(steps):
    jsch, sch = JaxSchedule("cosine"), NoiseScheduleVP("cosine")
    for stochastic in (False, True):
        want = JaxDPM(jsch, jax_time_steps(jsch, steps), True, pred_edge=True,
                      stochastic=stochastic)
        got = DPMSolverPP(sch, make_time_steps(sch, steps), True, stochastic=stochastic)
        # rtol 1e-4: the two linspaces differ by an ulp of t, and the steps
        # h are differences of close lambdas (measured 4e-5 at 100 steps)
        for name in ("alpha", "sigma", "noise_levels", "c_x", "c_d", "c_n", "w_cur", "w_prev"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        if stochastic:
            # the SDE keeps N(alpha_i x0, sigma_i^2) exact per step
            a, s = got.alpha, got.sigma
            np.testing.assert_allclose((got.c_x * a[:-1] + got.c_d).numpy(), a[1:].numpy(),
                                       rtol=1e-5)
            np.testing.assert_allclose((got.c_x**2 * s[:-1] ** 2 + got.c_n**2).numpy(),
                                       (s[1:] ** 2).numpy(), rtol=1e-5)


# ---------------------------------------------------------------- end to end

@pytest.mark.parametrize("method", ["dpm_solver", "dpm_solver_sde"])
def test_dpm_solver_serves(method):
    el = _tiny_elucidator({"sampling.method": method})
    assert isinstance(el.sampler, DPMSolverPP) and el.sampler.stochastic == method.endswith("sde")
    data = generate(seed=7, size=1, max_n=16, fidelity=4)
    n = int(data["num_atom"][0])
    result = el.elucidate(data["ir"][0], n_atoms=n, num_candidates=3, seed=1)
    assert sum(c.count for c in result.candidates) == 3
    assert all(np.isfinite(c.positions).all() and c.molgraph.n_atoms == n
               for c in result.candidates)


def test_batch_and_marginal_serve_end_to_end():
    el = _tiny_elucidator({"model.pallas_ops": ("block",)})
    assert el.model.blocks[0].e_block.block_kernel
    data = generate(seed=8, size=3, max_n=16, fidelity=4)
    given = [int(data["num_atom"][0]), None, int(data["num_atom"][2])]
    results = el.elucidate_batch([data["ir"][q] for q in range(3)], given, num_candidates=2,
                                 seed=3, queries_per_round=2)
    assert len(results) == 3 and results[0].n_atoms == given[0] and results[2].n_atoms == given[2]
    for r in results:
        assert r.num_draws == 2 and sum(c.count for c in r.candidates) == 2
        assert all(c.molgraph.n_atoms == r.n_atoms for c in r.candidates)
    marginal = el.elucidate(data["ir"][0], n_atoms=None, num_candidates=4, draws_per_n=1)
    ns = el._plausible_n()
    assert marginal.n_atoms is None and marginal.num_draws == len(ns)
    assert {c.molgraph.n_atoms for c in marginal.candidates} <= set(ns)


def test_unknown_sampling_method_raises():
    with pytest.raises(ValueError, match="sampling.method"):
        _tiny_elucidator({"sampling.method": "euler"})
