"""Atom-count-free elucidation in the port against the JAX package on the
CPU: ``diffspectra_tpu_torch/tools/nfree_eval.py`` against
``tools/nfree_eval.py``, and the demo.

- Both tools run whole at size 512, fidelity 2, with the same stand-in
  draws (an ``Elucidator`` without a model whose ``elucidate_batch``
  returns fixed candidates: a query's target when its atom count is
  right, and chains that recur across queries) and the same stand-in
  spectrum embedding before the committed count head: every call of
  ``elucidate_batch`` (the targets' spectra, their counts, the draws, the
  seed, the queries a round: protocol A's true counts, B's plausible
  counts, C's count sets and ``k_head``) and every figure of the JSON but
  the wall times are equal. The targets, their ids, the unseen mask and
  the plausible counts are held to the JAX package's functions too. JAX's
  ``canonical_id`` memo is keyed by ``id(molecule)``, so the stand-in keeps
  every candidate alive, as the real tool does not.
- The ranking of protocols B and C on hand-built tallies that hit each
  tie-break, in the order of the JAX tool's sort keys; ``score``'s columns.
- The port's tool end to end from ``warm_qm9s_ir.npz`` (2 targets, 2
  steps, with the count head): JAX's JSON keys; the demo on one target
  with and without its atom count; and the refusals without CUDA.
"""

import importlib.util
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from flax import traverse_util

from diffspectra_tpu.api import Elucidator as JaxElucidator
from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.data import synthetic as jax_synthetic
from diffspectra_tpu.data.info import get_dataset_info as jax_dataset_info
from diffspectra_tpu.data.pipeline import _conditional_splits as jax_splits
from diffspectra_tpu.evaluation import compute_metrics as jcm
from diffspectra_tpu.evaluation import molgraph as jmg
from diffspectra_tpu.models import atom_count as jac
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.warm_state import _decode
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import Elucidator, load_model
from diffspectra_tpu_torch.data import synthetic
from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.evaluation import molgraph as tmg
from diffspectra_tpu_torch.tools import elucidate_demo, nfree_eval

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = os.path.join(ROOT, "artifacts", "atom_count_head.npz")
WARM_IR = os.path.join(ROOT, "artifacts", "warm_qm9s_ir.npz")
SIZE, FIDELITY, NT = 512, 2, 16
TIMES = ("wall_s", "ms_per_query")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_nfree_eval", os.path.join(ROOT, "tools", "nfree_eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chain(n, k):
    """A chain of ``n`` atoms whose first ``k`` are N, the rest C."""
    atom_type = np.where(np.arange(n) < k, 2, 1)
    edge = np.zeros((n, n), np.int64)
    edge[np.arange(n - 1), np.arange(1, n)] = edge[np.arange(1, n), np.arange(n - 1)] = 1
    return np.zeros((n, 3), np.float32), atom_type, edge, np.zeros(n, np.int64)


class _Draws:
    """``elucidate_batch`` of a stand-in ``Elucidator``: records each call
    and returns, for each query, its target (when asked at the target's
    count and ``(m + seed) % 3``), and two chains of the asked count, one
    shared by every query of the call; keeps every candidate alive."""

    class Cand:
        def __init__(self, molgraph, count):
            self.molgraph, self.count = molgraph, count

    class Res:
        def __init__(self, candidates):
            self.candidates = candidates

    def __init__(self, raw, from_decoded, decoder):
        self.raw, self.from_decoded, self.decoder = raw, from_decoded, decoder
        self.index = {raw["ir"][m].tobytes(): m for m in range(len(raw["ir"]))}
        self.calls, self.keep = [], []

    def __call__(self, spectra_list, n_atoms_list, num_candidates=10, seed=0, normalized=False,
                 queries_per_round=8):
        self.calls.append((np.stack(spectra_list), [int(n) for n in n_atoms_list],
                           num_candidates, seed, queries_per_round))
        out = []
        for spec, n in zip(spectra_list, n_atoms_list):
            m = self.index[np.asarray(spec, np.float32).tobytes()]
            true_n = int(self.raw["num_atom"][m])
            mols = []
            if n == true_n and (m + seed) % 3:
                mols.append(((self.raw["pos"][m, :n], self.raw["atom_type"][m, :n],
                              self.raw["edge_type"][m, :n, :n], self.raw["fc"][m, :n]), 2))
            mols.append((_chain(n, seed % 3), 1 + m % 2))
            mols.append((_chain(n, 3 + m % 2), 1))
            out.append(self.Res([self.Cand(self.from_decoded(t, self.decoder), c)
                                 for t, c in mols]))
        self.keep.append(out)
        return out


@pytest.fixture(scope="module")
def encoders():
    """``warm_qm9s_ir.npz``'s SpecFormer: the JAX model and variables (its
    ``cond_encoder`` trees) and the port's DMT, as the tools load them."""
    cfg = diffspectra_qm9s.get_config()
    cfg.data.spectra_version = "ir"
    with np.load(WARM_IR, allow_pickle=False) as npz:
        trees = {tree: {k: np.asarray(v, np.float32) for k, v in _decode(npz, name).items()
                        if k.startswith("cond_encoder/")}
                 for tree, name in (("params", "ema"), ("batch_stats", "batch_stats"))}
    variables = {tree: traverse_util.unflatten_dict(flat, sep="/") for tree, flat in trees.items()}
    port = configs.get_config()
    port.data.spectra_version = "ir"
    return (JaxDMT.from_config(cfg), variables), load_model(WARM_IR, port, "cpu")


@pytest.fixture(scope="module")
def raws():
    want = jax_synthetic.generate(seed=42, size=SIZE, max_n=29, fidelity=FIDELITY)
    got = synthetic.generate(seed=42, size=SIZE, max_n=29, fidelity=FIDELITY)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return want, got


def _run_jax(raw, tmp, encoder, skip_ab=False):
    cfg = diffspectra_qm9s.get_config()
    cfg.data.spectra_version = "ir"
    stub = object.__new__(JaxElucidator)
    stub.config, stub.dataset_info = cfg, jax_dataset_info("qm9_second_half")
    stub.model, stub.variables = encoder
    stub.elucidate_batch = draws = _Draws(raw, jmg.from_decoded, stub.dataset_info["atom_decoder"])
    env = {"WARM": "warm.npz", "SIZE": str(SIZE), "FIDELITY": str(FIDELITY), "NT": str(NT),
           "COUNT_HEAD": HEAD, "OUT": os.path.join(tmp, "jax.json"),
           "SKIP_AB": "1" if skip_ab else ""}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(JaxElucidator, "from_warm_state", classmethod(lambda cls, *a, **k: stub))
        mp.setattr(jax_synthetic, "generate", lambda **kw: raw)
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        mp.setattr(logging, "basicConfig", lambda *a, **k: None)
        _jax_tool().main()
    with open(env["OUT"]) as f:
        return json.load(f), draws, stub


def _run_port(raw, tmp, model, skip_ab=False):
    cfg = configs.get_config()
    cfg.data.spectra_version = "ir"
    stub = object.__new__(Elucidator)
    stub.config, stub.dataset_info = cfg, get_dataset_info("qm9_second_half")
    stub.model, stub.device = model, torch.device("cpu")
    stub.elucidate_batch = draws = _Draws(raw, tmg.from_decoded, stub.dataset_info["atom_decoder"])
    out = os.path.join(tmp, "port.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Elucidator, "from_warm_state", classmethod(lambda cls, *a, **k: stub))
        mp.setattr(synthetic, "generate", lambda **kw: raw)
        mp.setattr(logging, "basicConfig", lambda *a, **k: None)
        results = nfree_eval.main(["--warm-state", "warm.npz", "--size", str(SIZE),
                                   "--fidelity", str(FIDELITY), "--nt", str(NT),
                                   "--count-head", HEAD, "--out", out, "--device", "cpu"]
                                  + (["--skip-ab"] if skip_ab else []))
    with open(out) as f:
        assert json.load(f) == results
    return results, draws, stub



def _without_times(results):
    return {k: ({kk: vv for kk, vv in v.items() if kk not in TIMES} if isinstance(v, dict) else v)
            for k, v in results.items()}


@pytest.mark.parametrize("skip_ab", [False, True])
def test_the_tool_equals_jax_on_the_same_draws(raws, encoders, tmp_path, skip_ab):
    want, jdraws, _ = _run_jax(raws[0], str(tmp_path), encoders[0], skip_ab)
    got, tdraws, _ = _run_port(raws[1], str(tmp_path), encoders[1], skip_ab)
    # A's one call, B's one a plausible count, C's one a rank of the count sets (two here)
    assert len(tdraws.calls) == len(jdraws.calls) == (0 if skip_ab else 1 + 12) + 2
    for g, w in zip(tdraws.calls, jdraws.calls):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
    assert _without_times(got) == _without_times(want)
    assert json.loads(json.dumps(got)).keys() == want.keys()
    for key in ("n_known", "n_free", "n_free_head"):
        if key in want:
            assert set(got[key]) == set(want[key])
    # k_head = max(2, 10 // 2) draws at each of two ranks; no figure all zero or all one
    head = got["n_free_head"]
    assert [c[2:] for c in tdraws.calls[-2:]] == [(5, 500, 16), (5, 501, 16)]
    assert head["draws_per_query"] == 10 and 0 < head["aggregate"]["top1"] < 1
    assert 0 < head["count_top1"] < head["count_cover90"] < 1
    if not skip_ab:
        assert got["n_known"]["aggregate"]["top1"] > 0 and got["n_free"]["top1_count_correct"] > 0


def test_targets_ids_and_counts_equal_jax(raws):
    raw = raws[0]
    el = object.__new__(Elucidator)
    el.config, el.dataset_info = configs.get_config(), get_dataset_info("qm9_second_half")
    t = nfree_eval.prepare(el, raws[1], SIZE, NT)
    # tools/nfree_eval.py:93-131 with the JAX package's functions
    first, second, _val, test = jax_splits(np.random.default_rng(42), SIZE)
    decoder = jax_dataset_info("qm9_second_half")["atom_decoder"]

    def graph(m):
        n = int(raw["num_atom"][m])
        return jmg.from_decoded((raw["pos"][m, :n], raw["atom_type"][m, :n],
                                 raw["edge_type"][m, :n, :n], raw["fc"][m, :n]), decoder)

    train_hashes = {graph(m).wl_hash() for m in np.concatenate([first, second])}
    targets = [int(test[i]) for i in np.random.default_rng(7).permutation(len(test))[:NT]]
    assert t["targets"] == targets
    assert t["ids"] == [jcm.canonical_id(graph(m), _cache={}) for m in targets]
    np.testing.assert_array_equal(t["unseen"], [graph(m).wl_hash() not in train_hashes
                                                for m in targets])
    assert t["true_ns"] == [int(raw["num_atom"][m]) for m in targets]
    assert 0 < t["unseen"].sum() < NT
    jel = object.__new__(JaxElucidator)
    jel.config, jel.dataset_info = diffspectra_qm9s.get_config(), jax_dataset_info(
        "qm9_second_half")
    assert el._plausible_n() == jel._plausible_n() == list(range(12, 24))


def test_count_sets_equal_jax():
    probs = np.zeros((4, 30))
    probs[0, [19, 18]] = [0.95, 0.05]  # one count
    probs[1, [14, 15, 16, 17]] = [0.4, 0.3, 0.2, 0.1]  # capped at three
    probs[2, [1, 21, 22]] = [0.06, 0.9, 0.04]  # a count under 2 dropped
    probs[3, [20, 21]] = [0.5, 0.5]
    sets, n_ranks, k_head = nfree_eval.count_sets(probs, 10)
    assert sets == jac.top_counts(probs, coverage=0.9, cap=3)
    assert [c for c, _ in sets] == [[19], [14, 15, 16], [21], [20, 21]]
    assert (n_ranks, k_head) == (3, max(2, 10 // 3))
    assert nfree_eval.count_sets(probs[:1], 2)[1:] == (1, 2)


# (count, n_atoms, first seen) by id: ties in count, in probability and in both
TALLY = {"a": [2, 14, 0], "b": [3, 19, 1], "c": [2, 19, 2], "d": [2, 14, 3], "e": [1, 27, 4],
         "f": [2, 30, 5]}


@pytest.mark.parametrize("n_prob, order", [
    ({14: 0.1, 19: 0.2, 27: 0.05}, ["b", "c", "a", "d", "f", "e"]),  # B: the prior
    ({14: 0.7, 19: 0.2}, ["b", "a", "d", "c", "f", "e"]),  # C: the head's probabilities
])
def test_ranking_follows_the_jax_sort_keys(n_prob, order):
    # tools/nfree_eval.py:204-209 and :286-294
    want = [cid for cid, _ in sorted(
        TALLY.items(), key=lambda kv: (-kv[1][0], -n_prob.get(kv[1][1], 0.0), kv[1][2]))]
    assert nfree_eval.rank_tally(TALLY, n_prob) == want == order


def test_score_columns():
    ranks = [["x", "y"], ["z"], ["q", "w"], ["e"]]
    ids = ["x", "z", "w", "n"]
    got = nfree_eval.score(ranks, ids, [True, False, True, False])
    assert got == {"aggregate": {"top1": 0.5, "in_list": 0.75, "n": 4},
                   "unseen": {"top1": 0.5, "in_list": 1.0, "n": 2},
                   "seen": {"top1": 0.5, "in_list": 0.5, "n": 2}}
    assert nfree_eval.score(ranks, ids, [False] * 4)["unseen"] == {"top1": 0.0, "in_list": 0.0,
                                                                     "n": 0}
    tallies = [{"x": [2, 19, 0]}, {"z": [1, 14, 0]}, {"q": [3, 20, 0]}, {"e": [1, 8, 0]}]
    assert nfree_eval.top1_count_correct(ranks, tallies, [19, 15, 20, 9]) == 0.5


def test_the_tool_runs_end_to_end_on_the_cpu(raws, encoders, tmp_path, monkeypatch, capsys):
    want, _, _ = _run_jax(raws[0], str(tmp_path), encoders[0])
    monkeypatch.setattr(nfree_eval, "SYNTH_CACHE", str(tmp_path / "cache"))
    out = tmp_path / "nfree.json"
    got = nfree_eval.main(["--device", "cpu", "--warm-state", WARM_IR, "--size", "64",
                           "--nt", "2", "--k-known", "2", "--k-per-n", "1", "--steps", "2",
                           "--count-head", HEAD, "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "NFREE_EVAL OK" and json.loads(lines[-2]) == got
    assert got.keys() == want.keys()
    for key in ("n_known", "n_free", "n_free_head"):
        assert got[key].keys() == want[key].keys()
        assert got[key]["aggregate"]["n"] == 2 and got[key]["wall_s"] > 0
    assert got["n_known"]["draws_per_query"] == 2 and got["n_free"]["draws_per_query"] == 12
    assert os.listdir(tmp_path / "cache") == ["synth_42_64_29_qm9_second_half_f2.npz"]


@pytest.mark.parametrize("known_n", [True, False])
def test_the_demo_runs_on_one_target(capsys, known_n):
    assert elucidate_demo.main(["--device", "cpu", "--warm-state", WARM_IR, "--targets", "1",
                                "--k", "2", "--steps", "2"] + (["--known-n"] if known_n else [])) == 0
    out = capsys.readouterr().out
    n = int(synthetic.generate(seed=7, size=1, max_n=29, fidelity=2)["num_atom"][0])
    draws = 2 if known_n else 2 * 12  # max(2, k // 4) a plausible count
    mode = "known n" if known_n else f"n marginalized ({draws} draws)"
    assert f"=== target 0: {n} atoms ({mode}), id wl:" in out
    counts = [int(line.split()[1][1:]) for line in out.splitlines() if line.startswith("  #")]
    assert sum(counts) == draws
    assert out.strip().splitlines()[-1] in ("consensus Top-1: 0/1", "consensus Top-1: 1/1")


def test_the_tools_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nfree_eval.main(["--warm-state", WARM_IR, "--size", "16"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        elucidate_demo.main(["--warm-state", WARM_IR, "--targets", "1"])


def test_defaults_are_the_jax_tools():
    args = nfree_eval.parse_args([])
    assert (args.warm_state, args.size, args.fidelity, args.nt, args.k_known, args.k_per_n,
            args.method, args.steps, args.count_head, args.skip_ab) == (
        "artifacts/warm_qm9s_ir.npz", 131072, 2, 512, 10, 2, "dpm_solver_sde", 100, "", False)
    demo = elucidate_demo.parse_args([])
    assert (demo.warm_state, demo.targets, demo.k, demo.method, demo.steps, demo.known_n) == (
        "artifacts/warm_qm9s_ir.npz", 3, 10, "dpm_solver_sde", 50, False)
