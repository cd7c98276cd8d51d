"""Hungarian atom-assignment RMSD with a two-stage alignment, the port of
``diffspectra_tpu/evaluation/rmsd.py`` over ``MolGraph``s: each molecule
cut to its largest fragment and centred; a rough Hungarian match (distance
plus an atom-type penalty) gives a Kabsch rotation (a principal-axes
rotation where fewer than ``min_atoms`` atoms match); a final match within
``max_distance`` gives the RMSD and the atom-type accuracy. scipy's
``linear_sum_assignment`` runs on the host, imported where it is used."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .molgraph import MolGraph


def _as_graph(mol) -> Optional[MolGraph]:
    """The molecule where it has positions, else None."""
    if mol is None or mol.positions is None:
        return None
    return mol


def _atom_type_penalty(s1: str, s2: str) -> float:
    if s1 == s2:
        return 0.0
    if s1 in ("C", "N", "O", "S") and s2 in ("C", "N", "O", "S"):
        return 2.0
    return 10.0


def _distance_matrix(ref: MolGraph, prb: MolGraph, ref_coords, prb_coords):
    spatial = np.linalg.norm(prb_coords[:, None, :] - ref_coords[None, :, :], axis=-1)
    penalty = np.array(
        [[_atom_type_penalty(sp, sr) for sr in ref.atom_syms] for sp in prb.atom_syms]
    )
    return spatial + penalty


def _hungarian_match(ref, prb, ref_coords, prb_coords, max_distance=np.inf):
    """{prb_idx: ref_idx}, pairs farther than ``max_distance`` dropped."""
    from scipy.optimize import linear_sum_assignment

    dist = _distance_matrix(ref, prb, ref_coords, prb_coords)
    if np.isfinite(max_distance):
        dist = dist.copy()
        dist[dist > max_distance] = 1000.0
    prb_idx, ref_idx = linear_sum_assignment(dist)
    return {int(p): int(r) for p, r in zip(prb_idx, ref_idx) if dist[p, r] <= max_distance}


def _kabsch_rotation(P, Q):
    """min ||P R - Q|| with det(R)=+1."""
    H = P.T @ Q
    U, _, Vt = np.linalg.svd(H)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        Vt[-1, :] *= -1
        R = U @ Vt
    return R


def _pca_alignment(P, Q):
    """Correspondence-free principal-axes alignment."""

    def axes(X):
        C = np.cov(X.T)
        w, V = np.linalg.eigh(C)
        return V[:, np.argsort(w)[::-1]]

    R = axes(P) @ axes(Q).T
    if np.linalg.det(R) < 0:
        R[:, -1] *= -1
    return R


def hungarian_atom_mapping(ref_mol, prb_mol, max_distance=5.0, min_atoms=3):
    """``(atom_map {prb: ref}, rmsd, atom_type_accuracy)``, or three Nones
    where a molecule has no positions or fewer than ``min_atoms`` atoms
    match."""
    ref = _as_graph(ref_mol)
    prb = _as_graph(prb_mol)
    if ref is None or prb is None:
        return None, None, None
    ref = ref.largest_fragment()
    prb = prb.largest_fragment()

    ref_c = ref.positions - ref.positions.mean(0, keepdims=True)
    prb_c = prb.positions - prb.positions.mean(0, keepdims=True)

    tmp_map = _hungarian_match(ref, prb, ref_c, prb_c, max_distance=np.inf)
    if not tmp_map or len(tmp_map) < min_atoms:
        R = _pca_alignment(prb_c, ref_c)
    else:
        P = prb_c[list(tmp_map.keys()), :]
        Q = ref_c[list(tmp_map.values()), :]
        R = _kabsch_rotation(P, Q)
    prb_aligned = prb_c @ R

    final_map = _hungarian_match(ref, prb, ref_c, prb_aligned, max_distance)
    if not final_map or len(final_map) < min_atoms:
        return None, None, None

    diffs2 = [np.sum((prb_aligned[p] - ref_c[r]) ** 2) for p, r in final_map.items()]
    rmsd = float(np.sqrt(np.mean(diffs2)))
    correct = sum(1 for p, r in final_map.items() if prb.atom_syms[p] == ref.atom_syms[r])
    return final_map, rmsd, correct / len(final_map)


def hungarian_rmsd_batch(ref_mols, prb_mols, max_distance=5.0, min_atoms=3):
    """``(rmsd_list, success_rate, mean_rmsd, mean_atom_type_accuracy)``
    over pairs; a pair whose mapping fails (None) or raises scores None."""
    assert len(ref_mols) == len(prb_mols)
    rmsd_list: List[Optional[float]] = []
    acc_list: List[Optional[float]] = []
    success = 0
    for ref, prb in zip(ref_mols, prb_mols):
        try:
            _, rmsd, acc = hungarian_atom_mapping(ref, prb, max_distance, min_atoms)
        except (ValueError, np.linalg.LinAlgError):
            rmsd = acc = None
        rmsd_list.append(rmsd)
        acc_list.append(acc)
        if rmsd is not None:
            success += 1
    valid = [r for r in rmsd_list if r is not None]
    accs = [a for a in acc_list if a is not None]
    return (
        rmsd_list,
        success / len(ref_mols) if ref_mols else 0.0,
        float(np.mean(valid)) if valid else None,
        float(np.mean(accs)) if accs else None,
    )
