"""EDM stability metrics, 3D (bonds inferred from distances) and 2D (the
generated bond matrix), and the basic molecule metrics: the graph branch of
``diffspectra_tpu/evaluation/stability.py`` (the branch that runs without
RDKit, as on the card) with ``eval_molgraphs`` from
``diffspectra_tpu/evaluation/rdkit_metric.py`` kept here in this module.

Each check returns ``(mol_stable, n_stable_atoms, n_atoms, MolGraph)``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .bond_analyze import allowed_bonds, allowed_fc_bonds, get_bond_order
from .molgraph import MolGraph


def check_stability(positions, atom_type, dataset_info):
    """3D stability: bond orders from the pairwise distances (pairs i < j in
    order), each atom stable when its summed orders are allowed."""
    positions = np.asarray(positions)
    atom_type = np.asarray(atom_type)
    atom_decoder = dataset_info["atom_decoder"]
    if "QM9" not in dataset_info["name"]:
        raise ValueError(f"no bond table for dataset {dataset_info['name']!r}")
    n = len(atom_type)
    syms = [atom_decoder[int(a)] for a in atom_type]

    nr_bonds = np.zeros(n, dtype=np.int64)
    orders = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            dist = float(np.linalg.norm(positions[i] - positions[j]))
            order = get_bond_order(syms[i], syms[j], dist)
            orders[i, j] = orders[j, i] = order
            nr_bonds[i] += order
            nr_bonds[j] += order

    nr_stable = 0
    for sym, nb in zip(syms, nr_bonds):
        possible = allowed_bonds[sym]
        ok = possible == nb if isinstance(possible, int) else nb in possible
        nr_stable += int(ok)

    mol = MolGraph(syms, np.zeros(n, np.int64), orders, positions)
    return nr_stable == n, nr_stable, n, mol


def check_2D_stability(positions, atom_types, formal_charges, edge_types, dataset_info):
    """2D stability from the generated bond matrix with formal-charge-aware
    valences (aromatic bonds count 1.5)."""
    atom_types = np.asarray(atom_types)
    edge_types = np.asarray(edge_types)
    atom_decoder = dataset_info["atom_decoder"]
    n = len(atom_types)
    syms = [atom_decoder[int(a)] for a in atom_types]
    fc = (
        np.asarray(formal_charges).reshape(-1)[:n].astype(np.int64)
        if formal_charges is not None and np.asarray(formal_charges).size
        else np.zeros(n, np.int64)
    )

    mol = MolGraph(syms, fc, edge_types, positions)
    value = {0: 0.0, 1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}
    nr_bonds = np.zeros(n, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            o = value[int(edge_types[i, j])]
            nr_bonds[i] += o
            nr_bonds[j] += o

    if dataset_info["name"] not in ["GeomDrug", "QM9"]:
        return 0, 0, n, mol

    nr_stable = 0
    for sym, nb, f in zip(syms, nr_bonds, fc):
        possible = allowed_fc_bonds[sym]
        if isinstance(possible, int):
            ok = possible == nb
        elif isinstance(possible, dict):
            expected = possible.get(int(f), possible.get(0))
            ok = expected == nb if isinstance(expected, int) else nb in expected
        else:
            ok = nb in possible
        nr_stable += int(ok)

    return nr_stable == n, nr_stable, n, mol


def eval_molgraphs(mols: List[MolGraph], train_hashes: Optional[set] = None) -> dict:
    """Validity (valences hold), Complete (valid and one fragment), Unique
    (distinct complete WL hashes) and Novelty (unique hashes not in
    ``train_hashes``), each over all ``mols``."""
    results = {"Validity": 0.0, "Complete": 0.0, "Unique": 0.0, "Novelty": 0.0}
    n = len(mols)
    if n == 0:
        return results
    valid = []
    complete_hashes = []
    for m in mols:
        if m.n_atoms == 0:
            continue
        if not m.valence_ok():
            continue
        valid.append(m)
        if m.n_fragments() == 1:
            complete_hashes.append(m.wl_hash())
    results["Validity"] = len(valid) / n
    results["Complete"] = len(complete_hashes) / n
    unique = set(complete_hashes)
    results["Unique"] = len(unique) / n
    if train_hashes is not None:
        novel = [h for h in unique if h not in train_hashes]
        results["Novelty"] = len(novel) / n
    return results


def _metric_from_checks(processed_list, check_fn, train_hashes):
    molecule_stable = 0
    nr_stable_bonds = 0
    n_atoms = 0
    mols = []
    for mol in processed_list:
        res = check_fn(mol)
        molecule_stable += int(res[0])
        nr_stable_bonds += int(res[1])
        n_atoms += int(res[2])
        mols.append(res[3])
    stability_dict = {
        "mol_stable": molecule_stable / float(len(processed_list)),
        "atom_stable": nr_stable_bonds / float(max(n_atoms, 1)),
    }
    return stability_dict, eval_molgraphs(mols, train_hashes), mols


def get_edm_metric(dataset_info, train_mols=None):
    """``edm_metric(decoded tuples) -> (stability, basic metrics, MolGraphs)``
    with bonds from the 3D positions."""
    train_hashes = _train_references(train_mols)

    def edm_metric(processed_list):
        return _metric_from_checks(
            processed_list, lambda m: check_stability(m[0], m[1], dataset_info), train_hashes
        )

    return edm_metric


def get_2D_edm_metric(dataset_info, train_mols=None):
    """The same with the generated bond matrix and formal charges."""
    train_hashes = _train_references(train_mols)

    def edm_metric_2d(processed_list):
        return _metric_from_checks(
            processed_list,
            lambda m: check_2D_stability(m[0], m[1], m[3], m[2], dataset_info),
            train_hashes,
        )

    return edm_metric_2d


def _train_references(train_mols) -> Optional[set]:
    """The train molecules' WL hashes, the Novelty reference."""
    if train_mols and isinstance(train_mols[0], MolGraph):
        return {m.wl_hash() for m in train_mols}
    return None
