"""The port's evaluation metrics (``diffspectra_tpu_torch/evaluation/``)
against the JAX package's graph mode (the mode without RDKit, which neither
this machine nor the card has), on the same molecules.

The molecules: ``generate(seed=3, size=40, max_n=29)`` and seeded numpy
perturbations of them (a bond order changed, an atom type swapped, a
formal charge set, positions jittered by 0.05-0.3 A, a bond cut into two
fragments). Every module the sweep scores with runs on both sides: bond
orders from positions, both stability checks, ``eval_molgraphs``, the WL
fingerprints, MCES, the functional groups, the pair scores, the exact
match, ``canonical_id``, ``consensus_rank``, ``top_k_exact_match`` and the
three output files (the summary CSV byte for byte against pandas, the
detailed CSV and JSON as parsed values). Everything must be equal; floats
(similarities, means) get an absolute tolerance of 1e-12, for sums taken in
another order.
"""

import csv
import json
import math

import numpy as np
import pytest

from diffspectra_tpu.data.info import get_dataset_info as jax_dataset_info
from diffspectra_tpu.data.synthetic import generate
from diffspectra_tpu.evaluation import compute_metrics as jcm
from diffspectra_tpu.evaluation import fingerprints as jfp
from diffspectra_tpu.evaluation import mces as jmces
from diffspectra_tpu.evaluation import molgraph as jmg
from diffspectra_tpu.evaluation import rdkit_metric as jrm
from diffspectra_tpu.evaluation import stability as jst
from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.evaluation import compute_metrics as tcm
from diffspectra_tpu_torch.evaluation import fingerprints as tfp
from diffspectra_tpu_torch.evaluation import mces as tmces
from diffspectra_tpu_torch.evaluation import molgraph as tmg
from diffspectra_tpu_torch.evaluation import stability as tst

ATOL = 1e-12
INFO, JINFO = get_dataset_info("qm9_second_half"), jax_dataset_info("qm9_second_half")
DECODER = INFO["atom_decoder"]
PERTURBATIONS = ("bond_order", "atom_type", "charge", "jitter", "cut")


def _base_molecules():
    raw = generate(seed=3, size=40, max_n=29)
    mols = []
    for m in range(40):
        n = int(raw["num_atom"][m])
        mols.append((raw["pos"][m, :n].copy(), raw["atom_type"][m, :n].copy(),
                     raw["edge_type"][m, :n, :n].copy(), raw["fc"][m, :n].copy()))
    return mols


def _perturb(mol, kind, rng):
    """One seeded edit of a decoded tuple ``(pos, atom_type, edge_type, fc)``."""
    pos, at, et, fc = (a.copy() for a in mol)
    iu, ju = np.nonzero(np.triu(et, 1))
    if kind == "bond_order" and len(iu):
        k = rng.integers(len(iu))
        et[iu[k], ju[k]] = et[ju[k], iu[k]] = 1 + (et[iu[k], ju[k]] % 3)
    elif kind == "atom_type":
        i = rng.integers(len(at))
        at[i] = (at[i] + 1 + rng.integers(4)) % 5
    elif kind == "charge":
        fc[rng.integers(len(fc))] = rng.choice([-1, 1])
    elif kind == "jitter":
        pos = pos + rng.uniform(0.05, 0.3, size=pos.shape) * rng.choice([-1, 1], size=pos.shape)
        pos = pos.astype(np.float32)
    elif kind == "cut" and len(iu):
        k = rng.integers(len(iu))
        et[iu[k], ju[k]] = et[ju[k], iu[k]] = 0
    return pos, at, et, fc


@pytest.fixture(scope="module")
def pairs():
    """(target, prediction) decoded tuples: each molecule with itself and
    with each of its perturbations."""
    rng = np.random.default_rng(11)
    out = []
    for mol in _base_molecules():
        out.append((mol, mol))
        for kind in PERTURBATIONS:
            out.append((mol, _perturb(mol, kind, rng)))
    # the decoder's bond matrices are float32
    out += [(t, (p[0], p[1], p[2].astype(np.float32), p[3])) for t, p in out[:12]]
    return out


def _graphs(tuples):
    return ([tmg.from_decoded(m, DECODER) for m in tuples],
            [jmg.from_decoded(m, DECODER) for m in tuples])


def _same_graph(a, b):
    assert a.atom_syms == b.atom_syms
    np.testing.assert_array_equal(a.formal_charges, b.formal_charges)
    np.testing.assert_array_equal(a.bond_orders, b.bond_orders)
    assert a.bond_orders.dtype == b.bond_orders.dtype
    if b.positions is None:
        assert a.positions is None
    else:
        np.testing.assert_array_equal(a.positions, b.positions)


def _close(a, b):
    if isinstance(b, float) and math.isnan(b):
        assert isinstance(a, float) and math.isnan(a)
    elif isinstance(b, (bool, np.bool_)):
        assert a == b and isinstance(a, bool)
    else:
        assert abs(a - b) <= ATOL, (a, b)


def test_perturbations_reach_every_case(pairs):
    """The set holds fragments, charges, wrong valences and equal graphs."""
    preds_t, _ = _graphs([p for _, p in pairs])
    assert any(g.n_fragments() == 2 for g in preds_t)
    assert any(int(c) != 0 for g in preds_t for c in g.formal_charges)
    assert any(not g.valence_ok() for g in preds_t) and any(g.valence_ok() for g in preds_t)


def test_molgraph_fragments_and_valence(pairs):
    got, want = _graphs([p for _, p in pairs])
    for a, b in zip(got, want):
        assert a.n_fragments() == b.n_fragments()
        assert a.valence_ok() == b.valence_ok()
        assert a.wl_hash() == b.wl_hash()
        _same_graph(a.largest_fragment(), b.largest_fragment())


def test_stability_3d_bonds_from_positions(pairs):
    for _, (pos, at, _, _) in pairs:
        got = tst.check_stability(pos, at, INFO)
        want = jst.check_stability(pos, at, JINFO)
        assert got[:3] == want[:3]
        _same_graph(got[3], want[3])


def test_stability_2d(pairs):
    for _, (pos, at, et, fc) in pairs:
        got = tst.check_2D_stability(pos, at, fc, et, INFO)
        want = jst.check_2D_stability(pos, at, fc, et, JINFO)
        assert got[:3] == want[:3]
        _same_graph(got[3], want[3])


@pytest.mark.parametrize("factory", ["get_edm_metric", "get_2D_edm_metric"])
@pytest.mark.parametrize("with_train", [False, True])
def test_edm_metrics_and_eval_molgraphs(pairs, factory, with_train):
    preds = [p for _, p in pairs]
    train_t = train_j = None
    if with_train:  # half the targets as the train split, for Novelty
        train_t, train_j = _graphs([t for t, _ in pairs[::12]])
    got = getattr(tst, factory)(INFO, train_t)(preds)
    want = getattr(jst, factory)(JINFO, train_j)(preds)
    assert got[0].keys() == want[0].keys() and got[1].keys() == want[1].keys()
    for k in want[0]:
        _close(got[0][k], want[0][k])
    for k in want[1]:
        _close(got[1][k], want[1][k])
    for a, b in zip(got[2], want[2]):
        _same_graph(a, b)
    hashes = None if train_j is None else {g.wl_hash() for g in train_j}
    assert tst.eval_molgraphs(got[2], hashes) == jrm.eval_molgraphs(want[2], hashes)
    assert tst.eval_molgraphs([], hashes) == jrm.eval_molgraphs([], hashes)


def test_fingerprints(pairs):
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    for a_t, a_j, b_t, b_j in zip(ts, tj, ps, pj):
        fa, fb = tfp.wl_fingerprint(a_t), tfp.wl_fingerprint(b_t)
        assert fa == jfp.wl_fingerprint(a_j) and fb == jfp.wl_fingerprint(b_j)
        _close(tfp.tanimoto(fa, fb), jfp.tanimoto(fa, fb))
        _close(tfp.cosine(fa, fb), jfp.cosine(fa, fb))


def test_mces_matches_both_jax_searches(pairs):
    """The port's Python search against the JAX package's dispatch (its C++
    twin where the native library loads) and its Python search: equal
    distances, exact everywhere."""
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    exhausted = tmces.EXHAUSTED_PAIRS
    for a_t, a_j, b_t, b_j in zip(ts, tj, ps, pj):
        got = tmces.mces_distance(a_t, b_t)
        assert got == jmces.mces_distance(a_j, b_j)
        s1, b1 = jmces._heavy_graph(a_j)
        s2, b2 = jmces._heavy_graph(b_j)
        common, exact = jmces._max_common_edges_py(s1, b1, s2, b2)
        assert exact and got == float(jmces._edge_count(b1) + jmces._edge_count(b2) - 2 * common)
        assert tmces.max_common_edges(s1, b1, s2, b2) == (common, True)
    assert tmces.EXHAUSTED_PAIRS == exhausted


def test_mces_budget_exhaustion_is_counted(monkeypatch):
    """With a budget of one node the search stops on its incumbent: both
    packages return the same upper bound and count the pair."""
    mols = _base_molecules()
    a, b = tmg.from_decoded(mols[0], DECODER), tmg.from_decoded(mols[1], DECODER)
    ja, jb = jmg.from_decoded(mols[0], DECODER), jmg.from_decoded(mols[1], DECODER)
    monkeypatch.setattr(tmces, "_MAX_NODES", 1)
    monkeypatch.setattr(jmces, "_MAX_NODES", 1)
    monkeypatch.setattr(jmces, "_load_native", lambda: None)
    before_t, before_j = tmces.EXHAUSTED_PAIRS, jmces.EXHAUSTED_PAIRS
    got, want = tmces.mces_distance(a, b), jmces.mces_distance(ja, jb)
    assert got == want
    assert tmces.EXHAUSTED_PAIRS - before_t == jmces.EXHAUSTED_PAIRS - before_j == 1


def test_functional_groups_and_pair_scores(pairs):
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    groups = set()
    for a_t, a_j, b_t, b_j in zip(ts, tj, ps, pj):
        got = tcm._graph_functional_groups(b_t)
        assert got == jcm._graph_functional_groups(b_j)
        groups |= got
        got, want = tcm._pair_scores_graph(a_t, b_t), jcm._pair_scores_graph(a_j, b_j)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    assert len(groups) >= 5  # the set exercises the pattern rules


def test_exact_match_canonical_id_and_consensus(pairs):
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    for a_t, a_j, b_t, b_j in zip(ts, tj, ps, pj):
        assert tcm._exact_match(a_t, b_t) == jcm._exact_match(a_j, b_j, _cache={})
        assert tcm.canonical_id(b_t) == jcm.canonical_id(b_j)
    assert tcm._exact_match(None, ps[0]) is jcm._exact_match(None, pj[0]) is False
    assert tcm.canonical_id(None) is jcm.canonical_id(None) is None
    # groups of six draws per target: the target and its perturbations,
    # with repeats so that counts and ties both occur
    rng = np.random.default_rng(5)
    for start in range(0, len(ps) - 6, 6):
        idx = rng.integers(start, start + 6, size=8)
        got = tcm.consensus_rank([ps[i] for i in idx] + [None])
        assert got == jcm.consensus_rank([pj[i] for i in idx] + [None])


def test_top_k_exact_match(pairs):
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    rng = np.random.default_rng(6)
    for k in (1, 3):
        picks = [rng.integers(len(ps), size=k) for _ in ts]
        want = jcm.top_k_exact_match(tj + [None], [[pj[i] for i in p] for p in picks] + [[]])
        got = tcm.top_k_exact_match(ts + [None], [[ps[i] for i in p] for p in picks] + [[]])
        assert 0 < got < 1
        _close(got, want)


def _read_csv(path):
    with open(path, encoding="utf-8-sig", newline="") as f:
        return list(csv.reader(f))


def test_output_files_match_pandas(pairs, tmp_path):
    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    got = tcm.evaluate_jsonl_predictions((ts, [[p] for p in ps]), str(tmp_path / "port.csv"))
    df = jcm.evaluate_jsonl_predictions((tj, [[p] for p in pj]), str(tmp_path / "jax.csv"))
    assert got == dict(zip(df["Evaluation Metric"], df["Value"]))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()

    port, jax_rows = (_read_csv(tmp_path / f"{s}_detailed_scores.csv") for s in ("port", "jax"))
    assert port[0] == jax_rows[0] == tcm.METRIC_NAMES and len(port) == len(jax_rows) == len(ts) + 1
    for row_p, row_j in zip(port[1:], jax_rows[1:]):
        assert row_p[0] == row_j[0]  # True / False
        for a, b in zip(row_p[1:], row_j[1:]):
            assert (a == b == "") or abs(float(a) - float(b)) <= ATOL
    with open(tmp_path / "port_detailed_scores.json") as f:
        port_json = json.load(f)
    with open(tmp_path / "jax_detailed_scores.json") as f:
        jax_json = json.load(f)
    assert port_json.keys() == jax_json.keys()
    for k in jax_json:
        assert len(port_json[k]) == len(jax_json[k])
        for a, b in zip(port_json[k], jax_json[k]):
            _close(a, b)


def test_similarity_metrics_filter_and_log(pairs, tmp_path, caplog):
    """Invalid predictions are skipped the same way, and the logged lines
    are equal."""
    import logging

    ts, tj = _graphs([t for t, _ in pairs])
    ps, pj = _graphs([p for _, p in pairs])
    ps[3], pj[3] = None, None
    lines = {}
    for tag, mod, preds, targets in (("port", tcm, ps, ts), ("jax", jcm, pj, tj)):
        (tmp_path / tag).mkdir()
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.compute_similarity_metrics(preds, targets, str(tmp_path / tag), 7, "2D")
        lines[tag] = [r.getMessage() for r in caplog.records]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 8
    assert "Skipped: 0" not in lines["port"][0]
