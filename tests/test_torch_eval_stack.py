"""The rest of the eval stack against the JAX package, on the CPU: the set
fingerprints, scaffolds, fragments, descriptors and weights; SNN, internal
diversity and the Frechet distance; the graph filters; the moses metrics
(twice through one factory, its reference CSR cached); the MMD's kernel
sums against JAX's jitted float32 sums and its float64 numpy loop; the
geometry distributions and the sub-geometry MMDs with their statistics
file; the Hungarian RMSD; ChemNet from one ``.npz``; the offline rescoring
CLI; and the sweep with the original-QM9 reference sets and ``save_mols``.

Molecules are made from a numpy seed (the synthetic generator, ring-bearing
at fidelity 3, with perturbed copies for hits and misses, and a few built
by hand) and enter each package through its own ``from_decoded``.
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

from diffspectra_tpu.configs import base_qm9
from diffspectra_tpu.evaluation import base_metrics as jax_base_metrics
from diffspectra_tpu.evaluation import cal_geometry as jax_geo
from diffspectra_tpu.evaluation import chemnet as jax_chemnet
from diffspectra_tpu.evaluation import filters as jax_filters
from diffspectra_tpu.evaluation import fingerprints as jax_fp
from diffspectra_tpu.evaluation import mmd as jax_mmd
from diffspectra_tpu.evaluation import mose_metric as jax_mose
from diffspectra_tpu.evaluation import rmsd as jax_rmsd
from diffspectra_tpu.evaluation.molgraph import MolGraph as JaxMolGraph
from diffspectra_tpu.evaluation.molgraph import from_decoded as jax_from_decoded
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.evaluation import base_metrics, cal_geometry, chemnet, filters
from diffspectra_tpu_torch.evaluation import fingerprints as fp
from diffspectra_tpu_torch.evaluation import mmd, mose_metric, rmsd
from diffspectra_tpu_torch.evaluation.molgraph import MolGraph, from_decoded
from test_torch_harness import K, _configs, assert_lines_match, run_both_evals

torch.set_num_threads(2)

DECODER = ["H", "C", "N", "O", "F"]
INFO = get_dataset_info("qm9_second_half")
RTOL = 1e-9


def _decoded(seed, size, fidelity=3):
    raw = generate(seed=seed, size=size, max_n=16, fidelity=fidelity)
    out = []
    for i, n in enumerate(raw["num_atom"]):
        out.append((raw["pos"][i, :n].astype(np.float64), raw["atom_type"][i, :n],
                    raw["edge_type"][i, :n, :n], raw["fc"][i, :n]))
    return out


def _perturbed(mols, seed):
    """Copies of ``mols`` with seeded edits: jittered positions, and now and
    then an atom type, a bond order or a charge changed."""
    rng = np.random.default_rng(seed)
    out = []
    for pos, at, et, fc in mols:
        pos = pos + rng.normal(0, 0.05, pos.shape)
        at, et, fc = at.copy(), et.copy(), fc.copy()
        n = len(at)
        edit = rng.integers(4)
        if edit == 1:
            at[rng.integers(n)] = rng.integers(5)
        elif edit == 2:
            i, j = rng.integers(n, size=2)
            if i != j:
                et[i, j] = et[j, i] = rng.integers(4)
        elif edit == 3:
            fc[rng.integers(n)] = 1
        out.append((pos, at, et, fc))
    return out


def _ring(size, charge=0, sym="C"):
    """A ring of ``size`` atoms (``sym`` first), one bond order 1 each, with
    positions on a circle."""
    bo = np.zeros((size, size), np.int64)
    for i in range(size):
        bo[i, (i + 1) % size] = bo[(i + 1) % size, i] = 1
    angle = 2 * np.pi * np.arange(size) / size
    pos = np.stack([np.cos(angle), np.sin(angle), np.zeros(size)], 1) * 1.5
    fc = np.zeros(size, np.int64)
    fc[0] = charge
    return [sym] + ["C"] * (size - 1), fc, bo, pos


HAND_BUILT = [_ring(8), _ring(7), _ring(9), _ring(5, charge=1), _ring(6, sym="P"),
              ([], np.zeros(0, np.int64), np.zeros((0, 0), np.int64), np.zeros((0, 3)))]


def _both(decoded, hand=()):
    """The same molecules as the port's and as JAX's ``MolGraph``s."""
    port = [from_decoded(m, DECODER) for m in decoded] + [MolGraph(*h) for h in hand]
    jax = [jax_from_decoded(m, DECODER) for m in decoded] + [JaxMolGraph(*h) for h in hand]
    return port, jax


def _same(got: dict, want: dict):
    """Equal dicts, NaN equal to NaN."""
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), (k, got[k], v)


def _close(got, want, rtol=RTOL):
    """Dicts or scalars: the same keys, NaN in the same places, values within rtol."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], rtol)
        return
    if want is None or (isinstance(want, float) and np.isnan(want)):
        assert got is None if want is None else np.isnan(got), (got, want)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


TARGETS = _decoded(11, 40)
GEN = _perturbed(_decoded(11, 24), 5) + _decoded(12, 12)


def test_fingerprint_scaffold_fragment_descriptor_and_weight_are_jax_s():
    port, jax = _both(TARGETS + GEN, HAND_BUILT[:5])
    for p, j in zip(port, jax):
        assert fp.wl_fingerprint(p) == jax_fp.wl_fingerprint(j)
        assert fp.scaffold_hash(p) == jax_fp.scaffold_hash(j)
        assert fp.fragment_counts(p) == jax_fp.fragment_counts(j)
        assert fp.mol_weight(p) == jax_fp.mol_weight(j)
        np.testing.assert_array_equal(fp.descriptor_vector(p), jax_fp.descriptor_vector(j))
    # rings and their scaffolds, and an acyclic one pruned to nothing
    assert sum(bool(fp.scaffold_hash(p)) for p in port) > 10
    assert any(fp.scaffold_hash(p) == "" for p in port)


def test_set_similarities_and_frechet_distance_match_jax():
    (ref, gen), (jref, jgen) = zip(_both(TARGETS), _both(GEN))
    vocab, jvocab = {}, {}
    ref_mat = fp.counters_to_csr([fp.wl_fingerprint(m) for m in ref], vocab)
    jref_mat = jax_fp.counters_to_csr([jax_fp.wl_fingerprint(m) for m in jref], jvocab)
    gen_mat = fp.counters_to_csr([fp.wl_fingerprint(m) for m in gen], vocab)
    jgen_mat = jax_fp.counters_to_csr([jax_fp.wl_fingerprint(m) for m in jgen], jvocab)
    assert vocab == jvocab and len(vocab) > ref_mat.shape[1]  # the vocabulary grew
    ref_mat.resize((ref_mat.shape[0], gen_mat.shape[1]))
    jref_mat.resize((jref_mat.shape[0], jgen_mat.shape[1]))
    for block in (1024, 7):  # one block, and blocks with ragged edges
        _close(fp.snn_matrix(gen_mat, ref_mat, block), jax_fp.snn_matrix(jgen_mat, jref_mat, block))
        _close(fp.internal_diversity_matrix(gen_mat, block),
               jax_fp.internal_diversity_matrix(jgen_mat, block))
    assert np.isnan(fp.snn_matrix(gen_mat[:0], ref_mat))
    assert np.isnan(fp.internal_diversity_matrix(gen_mat[:1]))
    x = np.stack([fp.descriptor_vector(m) for m in gen])
    y = np.stack([fp.descriptor_vector(m) for m in ref])
    d = fp.frechet_distance(x, y)
    _close(d, jax_fp.frechet_distance(x, y))
    assert d > 0 and fp.frechet_distance(y, y) < 1e-4


def test_graph_filters_match_jax():
    port, jax = _both(TARGETS + GEN, HAND_BUILT)
    got = [filters.mol_passes_filters(p) for p in port] + [filters.mol_passes_filters(None)]
    want = [jax_filters.mol_passes_filters_graph(j) for j in jax] + [
        jax_filters.mol_passes_filters_graph(None)]
    assert got == want
    # the hand-built: an 8-ring and a 9-ring fail, a 7-ring passes, a charge,
    # phosphorus and an empty molecule fail
    assert got[-7:] == [False, True, False, False, False, False, False]
    for (syms, _, bo, _), size in zip(HAND_BUILT[:3], (8, 7, 9)):
        assert filters._shortest_cycle_through_edge(bo, 0, 1) == size \
            == jax_filters._shortest_cycle_through_edge(bo, 0, 1)
    assert True in got and False in got[:-7]


def test_moses_metrics_match_jax_across_calls():
    ref, jref = _both(TARGETS)
    port_metric, jax_metric = mose_metric.get_moses_metrics(ref), jax_mose.get_moses_metrics(jref)
    calls = [_decoded(13, 20), GEN[:1], GEN[:2], GEN]  # new features widen the vocabulary
    for decoded in calls:
        port, jax = _both(decoded)
        got, want = port_metric(port + [None]), jax_metric(jax)
        _close(got, want)
        assert set(got) == set(mose_metric.MOSES_KEYS)
        assert [k for k, v in got.items() if np.isnan(v)] == [
            k for k, v in want.items() if np.isnan(v)]
    assert np.isnan(got["FCD"]) and got["FCD_proxy"] >= 0 and got["weight"] > 0
    assert all(0 <= got[k] <= 1 for k in ("SNN", "IntDiv", "Filters"))
    # nothing valid: every key NaN
    empty = port_metric([MolGraph(*HAND_BUILT[-1]), None])
    assert set(empty) == set(mose_metric.MOSES_KEYS) and all(np.isnan(v) for v in empty.values())
    for decoded in (GEN, GEN[:1]):
        port, jax = _both(decoded)
        _close(mose_metric.get_fcd_metric(ref)(port), jax_mose.get_fcd_metric(jref)(jax))


SAMPLE_PAIRS = {  # name -> (source, target), 400 a side
    "identical": lambda rng: (rng.normal(1.4, 0.1, 400),) * 2,
    "shifted": lambda rng: (rng.normal(1.4, 0.1, 400), rng.normal(1.5, 0.1, 400)),
    "width": lambda rng: (rng.normal(110, 5, 400), rng.normal(110, 15, 300)),
}


@pytest.mark.parametrize("pair", list(SAMPLE_PAIRS))
def test_mmd_kernel_sums_match_jax(monkeypatch, pair):
    """The port's float32 row-block sums on the CPU device against JAX's
    jitted float32 sums and its float64 numpy loop (the port's plain
    version, the same code): each of xx/n^2, yy/m^2 and xy/nm within 1e-5
    relative, the MMD within 1e-5 x (xx/n^2 + yy/m^2)."""
    source, target = SAMPLE_PAIRS[pair](np.random.default_rng(3))
    source, target = source.astype(np.float32), target.astype(np.float32)
    n, m = len(source), len(target)
    total = np.concatenate([source, target])
    monkeypatch.setattr(mmd, "BLOCK_ELEMENTS", 5000)  # ragged blocks of 7 rows
    got = mmd.kernel_sums(torch.from_numpy(total), n)
    plain = mmd.kernel_sums_plain(total, n)
    _close(plain, jax_mmd._kernel_sums_numpy(total.astype(np.float64), n, 2.0, 5, 1000),
           rtol=1e-12)
    scale = np.array([n * n, m * m, n * m], dtype=np.float64)
    for want in (plain, [float(v) for v in jax_mmd._kernel_sums_jax(total, n, 2.0, 5)]):
        np.testing.assert_allclose(np.array(got) / scale, np.array(want) / scale, rtol=1e-5)
        bound = 1e-5 * (want[0] / n**2 + want[1] / m**2)
        assert abs(mmd.mmd_from_sums(*got, n, m) - mmd.mmd_from_sums(*want, n, m)) <= bound
    value = mmd.compute_mmd(source, target, device="cpu")
    assert abs(value - jax_mmd.compute_mmd(source, target)) <= \
        1e-5 * (plain[0] / n**2 + plain[1] / m**2)
    if pair == "identical":
        assert abs(value) < 1e-5
    else:
        assert value > 1e-3
    # the fixed bandwidth
    fixed = mmd.kernel_sums_plain(total, n, fix_sigma=0.5)
    assert abs(mmd.compute_mmd(source, target, fix_sigma=0.5, device="cpu")
               - jax_mmd.compute_mmd(source, target, fix_sigma=0.5)) <= \
        1e-5 * (fixed[0] / n**2 + fixed[1] / m**2)


def test_mmd_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mmd.compute_mmd([1.0, 2.0], [1.5])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cal_geometry.get_sub_geometry_metric([], INFO, "unused")


GEO_FNS = [(cal_geometry.cal_bond_distance, jax_geo.cal_bond_distance, "top_bond_sym"),
           (cal_geometry.cal_bond_angle, jax_geo.cal_bond_angle, "top_angle_sym"),
           (cal_geometry.cal_dihedral_angle, jax_geo.cal_dihedral_angle, "top_dihedral_sym")]


def test_geometry_distributions_are_jax_s():
    port, jax = _both(TARGETS + GEN, HAND_BUILT[:2])
    port.append(MolGraph(["C", "H"], np.zeros(2, np.int64), np.array([[0, 1], [1, 0]]), None))
    jax.append(JaxMolGraph(["C", "H"], np.zeros(2, np.int64), np.array([[0, 1], [1, 0]]), None))
    for port_fn, jax_fn, key in GEO_FNS:
        got, want = port_fn(port, INFO[key]), jax_fn(jax, INFO[key])
        assert got == want
        assert sum(len(v) for v in got.values()) > 50


def test_sub_geometry_metric_matches_jax_and_writes_its_statistics(tmp_path):
    ref, jref = _both(TARGETS)
    gen, jgen = _both(GEN)
    port_metric = cal_geometry.get_sub_geometry_metric(ref, INFO, str(tmp_path / "port"), "cpu")
    jax_metric = jax_geo.get_sub_geometry_metric(jref, INFO, str(tmp_path / "jax"))
    with open(tmp_path / "port" / "target_geometry_stat.pk", "rb") as f:
        written = pickle.load(f)
    with open(tmp_path / "jax" / "target_geometry_stat.pk", "rb") as f:
        assert written == pickle.load(f)
    got, want = port_metric(gen), jax_metric(jgen)
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert sum(np.isfinite(v) for v in got.values()) > 10
    # the file is read back where it exists: the same statistics from no molecules
    again = cal_geometry.get_sub_geometry_metric([], INFO, str(tmp_path / "port"), "cpu")
    _same(again(gen), got)


def test_geometry_cap_draws_from_the_seeded_generator(monkeypatch, tmp_path):
    """Over the cap each side is cut by ``random.Random(seed).sample``, the
    target side first, symbol by symbol (the JAX package draws from the
    global ``random``; no parity case crosses its cap of 10,000)."""
    ref, _ = _both(TARGETS)
    gen, _ = _both(GEN)
    monkeypatch.setattr(cal_geometry, "GEOMETRY_CAP", 12)
    metric = cal_geometry.get_sub_geometry_metric(ref, INFO, str(tmp_path), "cpu", seed=5)
    got = metric(gen)
    _same(metric(gen), got)
    tar = cal_geometry.load_target_geometry(ref, INFO, str(tmp_path))
    rng = random.Random(5)
    gen_bonds = cal_geometry.cal_bond_distance(gen, INFO["top_bond_sym"])
    crossed = 0
    for sym in INFO["top_bond_sym"]:
        t, g = tar[sym], gen_bonds[sym]
        if not t or not g:
            assert np.isnan(got[sym])
            continue
        crossed += len(t) > 12 or len(g) > 12
        t = rng.sample(list(t), 12) if len(t) > 12 else t
        g = rng.sample(list(g), 12) if len(g) > 12 else g
        assert got[sym] == mmd.compute_mmd(g, t, device="cpu")
    assert crossed


def test_hungarian_rmsd_matches_jax():
    base = _decoded(21, 10)
    rng = np.random.default_rng(4)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    moved = [(p @ rot + rng.normal(0, 0.1, p.shape) + 3.0, a, e, f) for p, a, e, f in base]
    port_ref, jax_ref = _both(base)
    port_prb, jax_prb = _both(moved[:4] + _perturbed(base[4:8], 9) + _decoded(22, 2))
    port_ref.append(None)
    jax_ref.append(None)
    port_prb.append(port_ref[0])
    jax_prb.append(jax_ref[0])
    got = rmsd.hungarian_rmsd_batch(port_ref, port_prb)
    want = jax_rmsd.hungarian_rmsd_batch(jax_ref, jax_prb)
    assert len(got[0]) == len(want[0]) == 11
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    # jittered in place: close; rotated and moved: the rough match's Kabsch
    # rotation leaves them farther (JAX's alignment, not a port fault)
    assert got[0][-1] is None and all(r < 0.5 for r in got[0][4:8])
    mapping, value, acc = rmsd.hungarian_atom_mapping(port_ref[0], port_prb[0])
    assert (mapping, value, acc)[0] == jax_rmsd.hungarian_atom_mapping(jax_ref[0], jax_prb[0])[0]


def test_chemnet_from_one_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    toks = ["C", "N", "O", "(", ")", "=", "1", "2", "Cl", "Br", "c", "n", "[", "]", "+", "#",
            "Si", "Z"]
    smiles = ["".join(rng.choice(toks, size=rng.integers(1, 90))) for _ in range(40)] + [""]
    for s in smiles[:10]:
        assert chemnet.tokenize(s, chemnet.DEFAULT_VOCAB) == jax_chemnet.tokenize(
            s, jax_chemnet.DEFAULT_VOCAB)
    np.testing.assert_array_equal(chemnet.one_hot_batch(smiles, chemnet.DEFAULT_VOCAB, 64),
                                  jax_chemnet.one_hot_batch(smiles, jax_chemnet.DEFAULT_VOCAB, 64))
    jax_net = jax_chemnet.random_chemnet(3)
    jax_net.save(str(tmp_path / "jax.npz"))
    net = chemnet.ChemNet.load(str(tmp_path / "jax.npz"))
    for k, v in chemnet.random_chemnet(3).params.items():
        np.testing.assert_array_equal(net.params[k], v)
    got = net.features(smiles, batch_size=16, device="cpu")
    want = jax_net.features(smiles, batch_size=16)
    assert got.shape == want.shape == (len(smiles), 24)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    net.save(str(tmp_path / "port.npz"))  # and the port's file serves JAX
    back = jax_chemnet.ChemNet.load(str(tmp_path / "port.npz"))
    assert back.manifest == jax_net.manifest
    for k, v in jax_net.params.items():
        np.testing.assert_array_equal(back.params[k], v)
    assert chemnet.default_weights_path() is None and np.isnan(
        chemnet.fcd_from_smiles(smiles, smiles, device="cpu"))


def _write_pickles(base, graphs_2d, graphs_3d, targets):
    os.makedirs(base)
    for name, mols in (("complete_rdmols_2d.pkl", graphs_2d), ("sample_rdmols_3d.pkl", graphs_3d),
                       ("groundtruth_rdmols.pkl", targets)):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(mols, f)


def test_rescoring_cli_matches_jax_and_jax_cannot_read_its_own_targets(tmp_path):
    targets = _decoded(31, 12)
    (t, j_t), (p2, j2), (p3, j3) = _both(targets), _both(_perturbed(targets, 1)), _both(
        _perturbed(targets, 2))
    _write_pickles(tmp_path / "port" / "molecules_ckpt_7", p2, p3, t)
    _write_pickles(tmp_path / "jax", j2, j3, j_t)
    tables = base_metrics.main(["--base_path", str(tmp_path / "port"), "--ckpt", "7"])
    jax_base_metrics.compute_metrics_for_saved_mols(str(tmp_path / "jax"),
                                                    str(tmp_path / "jax_out"))
    for version in ("2d", "3d"):
        assert tables[version] is not None
        for suffix in (".csv", "_detailed_scores.csv", "_detailed_scores.json"):
            name = f"similarity_metrics_{version}{suffix}"
            with open(tmp_path / "port" / "metrics_results" / name, "rb") as a, \
                    open(tmp_path / "jax_out" / name, "rb") as b:
                assert a.read() == b.read(), name
    assert base_metrics.compute_metrics_for_saved_mols(str(tmp_path / "none"),
                                                       str(tmp_path / "o")) == {}
    # the JAX sweep pickles its targets as decoded tuples; its rescoring
    # reads graphs, and fails on them
    _write_pickles(tmp_path / "jax_tuples", j2, j3, targets)
    with pytest.raises(AttributeError, match="tuple"):
        jax_base_metrics.compute_metrics_for_saved_mols(str(tmp_path / "jax_tuples"),
                                                        str(tmp_path / "jax_tuples_out"))


def _same_graphs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.atom_syms == w.atom_syms
        np.testing.assert_array_equal(g.formal_charges, w.formal_charges)
        np.testing.assert_array_equal(g.bond_orders, w.bond_orders)
        np.testing.assert_array_equal(g.positions, w.positions)


def test_sweep_with_original_qm9_references_and_saved_molecules_matches_jax(
        monkeypatch, tmp_path, caplog):
    jcfg, cfg = _configs(num_samples=6, batch_size=6, num_candidates=K, sub_geometry=True,
                         save_mols="true")
    jcfg.data.root, cfg.data.root = str(tmp_path / "jax_root"), str(tmp_path / "port_root")
    jax_original = base_qm9.get_config()
    for key in ("synthetic", "synthetic_size", "max_node", "root"):
        setattr(jax_original.data, key, getattr(jcfg.data, key))
    original = configs.original_qm9_config(cfg)
    assert (original.exp_type, original.data.info_name) == ("vpsde_edge_cond", "qm9_with_h")
    assert original.data.root == cfg.data.root and original.data.synthetic_size == 64
    want, got, figures, jax_dir, port_dir = run_both_evals(
        monkeypatch, tmp_path, caplog, jcfg, cfg, jax_original, original)
    assert_lines_match(got, want)
    assert len(got) == 5 + 4 + 7 + 2 * 9 + 1
    assert figures["reference_sets"] == "original-QM9"
    logged = [r.getMessage() for r in caplog.records]
    assert "metric reference sets: original-QM9 (--original-qm9)" in logged
    with open(tmp_path / "port_root" / "target_geometry_stat.pk", "rb") as a, \
            open(tmp_path / "jax_root" / "target_geometry_stat.pk", "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    assert set(figures["geometry"]) >= {"bond_length_mean", "bond_angle_mean",
                                        "dihedral_angle_mean"}

    saved = os.path.join(port_dir, "molecules_ckpt_1")
    assert figures["saved_mols"] == saved
    loaded = {}
    for name in ("sample_rdmols_3d.pkl", "complete_rdmols_2d.pkl", "groundtruth_rdmols.pkl"):
        with open(os.path.join(saved, name), "rb") as f:
            loaded[name] = pickle.load(f)
        with open(os.path.join(jax_dir, "molecules_ckpt_1", name), "rb") as f:
            jax_saved = pickle.load(f)
        if name == "groundtruth_rdmols.pkl":  # JAX's decoded tuples, the port's graphs
            jax_saved = [jax_from_decoded(m, DECODER) for m in jax_saved]
        _same_graphs(loaded[name], jax_saved)
    # the offline rescoring of the saved files gives the sweep's own tables
    tables = base_metrics.main(["--base_path", port_dir, "--ckpt", "1"])
    for version in ("2d", "3d"):
        with open(os.path.join(port_dir, "metrics_results", f"similarity_metrics_{version}.csv"),
                  "rb") as a, open(os.path.join(
                      port_dir, f"similarity_metrics_{version}_ckpt_1.csv"), "rb") as b:
            assert a.read() == b.read()
        _same({k: float(v) for k, v in tables[version].items()}, figures[f"similarity_{version}"])
    # the 3D samples against their targets
    rmsds, rate, mean, _ = rmsd.hungarian_rmsd_batch(loaded["groundtruth_rdmols.pkl"],
                                                     loaded["sample_rdmols_3d.pkl"])
    assert rate > 0 and np.isfinite(mean)


def test_enable_sampling_false_samples_nothing(tmp_path):
    _, cfg = _configs(num_samples=6, batch_size=6, sub_geometry=False, enable_sampling=False)
    figures = run_lib.diffspectra_evaluate(cfg, None, str(tmp_path), "cpu", "1")
    assert figures["sweeps"] == [] and "metric_2d" not in figures
    assert figures["reference_sets"] == "conditional-split"


def test_command_lines_take_the_original_qm9_references(monkeypatch, tmp_path, capsys):
    """``main.py --original-qm9`` hands ``run_lib`` the original-QM9 config
    of the main config's data (``--original-qm9-config`` sets its keys);
    ``tools/eval_sweep.py --original-qm9`` sweeps with those references."""
    import json

    from diffspectra_tpu_torch import main
    from diffspectra_tpu_torch.tools import eval_sweep

    seen = {}
    monkeypatch.setattr(run_lib, "evaluate_checkpoints",
                        lambda config, workdir, folder, device, original: seen.update(
                            config=config, original=original))
    main.main(["--mode", "eval", "--smoke", "--workdir", str(tmp_path / "w"), "--device", "cpu",
               "--config", "data.synthetic_size=96", "--original-qm9",
               "--original-qm9-config", "data.max_node=12"])
    original = seen["original"]
    assert (original.exp_type, original.data.info_name) == ("vpsde_edge_cond", "qm9_with_h")
    assert original.data.synthetic and original.data.synthetic_size == 96
    assert original.data.max_node == 12 and seen["config"].data.max_node == 16
    main.main(["--mode", "eval", "--smoke", "--workdir", str(tmp_path / "w"), "--device", "cpu"])
    assert seen["original"] is None

    argv = ["--smoke", "--random-weights", "--device", "cpu", "--steps", "2", "--num-samples",
            "4", "--synthetic-size", "64", "--workdir", str(tmp_path / "s"), "--original-qm9"]
    capsys.readouterr()
    assert eval_sweep.main(argv) == 0
    swept = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert swept["reference_sets"] == "original-QM9" and "geometry" in swept
    assert set(swept["moses_2d"]) == set(mose_metric.MOSES_KEYS)
