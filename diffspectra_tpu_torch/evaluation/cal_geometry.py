"""Sub-geometry MMDs: the distributions of bond lengths, bond angles and
dihedral angles by symbol, generated against the reference statistics, the
port of ``diffspectra_tpu/evaluation/cal_geometry.py`` over ``MolGraph``s
(positions and dense bond orders). The reference's enumeration quirks are
kept: a bond pairs (for an angle) only with the bonds of its END atom,
bonds are oriented i < j, and a bond's symbol is ``str(int(BondType))``
(single 1, double 2, triple 3, aromatic 12).

The target statistics are cached at ``<root>/target_geometry_stat.pk``: read
where the file exists, else computed from the test molecules and written
there. Each MMD's kernel sums run on the device (``mmd.py``); a
distribution over 10,000 samples is first cut to 10,000 by a draw from
``random.Random(seed)`` (the JAX package draws from the global ``random``).
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from typing import Dict, List, Sequence

import numpy as np

from ..device import resolve_device
from .mmd import compute_mmd
from .molgraph import MolGraph

BOND_SYM = {1: "1", 2: "2", 3: "3", 4: "12"}  # aromatic == 12
GEOMETRY_CAP = 10000  # samples a side of each MMD


def _bonds(mol: MolGraph):
    """[(i, j, order_sym)] with i<j (matching RWMol bond orientation)."""
    out = []
    idx_i, idx_j = np.nonzero(np.triu(mol.bond_orders, 1))
    for i, j in zip(idx_i, idx_j):
        out.append((int(i), int(j), BOND_SYM[int(mol.bond_orders[i, j])]))
    return out


def _angle_deg(p0, p1, p2):
    v1, v2 = p0 - p1, p2 - p1
    cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12)
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def _dihedral_deg(p0, p1, p2, p3):
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1 = np.cross(b0, b1)
    n2 = np.cross(b1, b2)
    m1 = np.cross(n1, b1 / (np.linalg.norm(b1) + 1e-12))
    x = np.dot(n1, n2)
    y = np.dot(m1, n2)
    return float(np.degrees(np.arctan2(y, x)))


def cal_bond_distance(mol_list, top_bond_syms: Sequence[str]) -> Dict[str, List[float]]:
    """Bond lengths by symbol (either orientation) over the molecules with
    positions."""
    out = {s: [] for s in top_bond_syms}
    for m in mol_list:
        if m.positions is None:
            continue
        for i, j, o in _bonds(m):
            bt = f"{m.atom_syms[i]}{o}{m.atom_syms[j]}"
            rbt = f"{m.atom_syms[j]}{o}{m.atom_syms[i]}"
            d = float(np.linalg.norm(m.positions[i] - m.positions[j]))
            if bt in out:
                out[bt].append(d)
            elif rbt in out:
                out[rbt].append(d)
    return out


def _bond_pairs(bonds, incident):
    """Pairs (b0, b1) where b1 is incident to b0's END atom."""
    pairs = []
    for bi, (i, j, o) in enumerate(bonds):
        for bj in incident[j]:
            if bj == bi:
                continue
            pairs.append((bi, bj))
    return pairs


def _incident_map(bonds, n):
    incident = [[] for _ in range(n)]
    for bi, (i, j, o) in enumerate(bonds):
        incident[i].append(bi)
        incident[j].append(bi)
    return incident


def _pair_sym_ijk(m, bonds, b0, b1):
    """Angle symbol and its atom indices, as the reference's
    ``get_bond_pair_symbol`` writes them."""
    a00, a01, o0 = bonds[b0]
    a10, a11, o1 = bonds[b1]
    s = m.atom_syms
    if a00 == a10:
        return f"{s[a01]}{o0}{s[a00]}-{s[a10]}{o1}{s[a11]}", (a01, a00, a11)
    if a00 == a11:
        return f"{s[a01]}{o0}{s[a00]}-{s[a11]}{o1}{s[a10]}", (a01, a00, a10)
    if a01 == a10:
        return f"{s[a00]}{o0}{s[a01]}-{s[a10]}{o1}{s[a11]}", (a00, a01, a11)
    if a01 == a11:
        return f"{s[a00]}{o0}{s[a01]}-{s[a11]}{o1}{s[a10]}", (a00, a01, a10)
    raise ValueError("Bond pair error.")


def cal_bond_angle(mol_list, top_angle_syms: Sequence[str]) -> Dict[str, List[float]]:
    """Bond angles (degrees) by symbol over the molecules with positions."""
    out = {s: [] for s in top_angle_syms}
    for m in mol_list:
        if m.positions is None:
            continue
        bonds = _bonds(m)
        incident = _incident_map(bonds, m.n_atoms)
        for b0, b1 in _bond_pairs(bonds, incident):
            sym, (i, j, k) = _pair_sym_ijk(m, bonds, b0, b1)
            rsym, _ = _pair_sym_ijk(m, bonds, b1, b0)
            if sym in out:
                out[sym].append(_angle_deg(m.positions[i], m.positions[j], m.positions[k]))
            elif rsym in out:
                out[rsym].append(_angle_deg(m.positions[k], m.positions[j], m.positions[i]))
    return out


def _triple_sym_ijkl(m, bonds, bl, bm, br):
    """Dihedral symbol and its atom indices, as the reference's
    ``get_triple_bond_symbol`` writes them."""
    s = m.atom_syms
    a00, a01, ol = bonds[bl]
    a10, a11, om = bonds[bm]
    a20, a21, orr = bonds[br]
    if a00 == a10:
        sym = f"{s[a01]}{ol}{s[a00]}-{s[a10]}{om}{s[a11]}"
        last, ijk = a11, [a01, a00, a11]
    elif a00 == a11:
        sym = f"{s[a01]}{ol}{s[a00]}-{s[a11]}{om}{s[a10]}"
        last, ijk = a10, [a01, a00, a10]
    elif a01 == a10:
        sym = f"{s[a00]}{ol}{s[a01]}-{s[a10]}{om}{s[a11]}"
        last, ijk = a11, [a00, a01, a11]
    elif a01 == a11:
        sym = f"{s[a00]}{ol}{s[a01]}-{s[a11]}{om}{s[a10]}"
        last, ijk = a10, [a00, a01, a10]
    else:
        raise ValueError("Left and middle bonds error.")
    if a20 == last:
        sym = sym + f"-{s[a20]}{orr}{s[a21]}"
        ijk.append(a21)
    elif a21 == last:
        sym = sym + f"-{s[a21]}{orr}{s[a20]}"
        ijk.append(a20)
    else:
        raise ValueError("Right bond error.")
    return sym, ijk


def _bond_triples(bonds, incident):
    """[left, mid, right] triples, as the reference's ``get_triple_bonds``."""
    triples = []
    for bm, (u, v, o) in enumerate(bonds):
        lefts = [b for b in incident[u] if b != bm]
        if not lefts:
            continue
        for br in incident[v]:
            if br == bm:
                continue
            for bl in lefts:
                triples.append((bl, bm, br))
    return triples


def cal_dihedral_angle(mol_list, top_dihedral_syms: Sequence[str]) -> Dict[str, List[float]]:
    """Dihedral angles (degrees) by symbol over the molecules with
    positions."""
    out = {s: [] for s in top_dihedral_syms}
    for m in mol_list:
        if m.positions is None:
            continue
        bonds = _bonds(m)
        incident = _incident_map(bonds, m.n_atoms)
        for bl, bm, br in _bond_triples(bonds, incident):
            sym, (i, j, k, l) = _triple_sym_ijkl(m, bonds, bl, bm, br)
            rsym, _ = _triple_sym_ijkl(m, bonds, br, bm, bl)
            p = m.positions
            if sym in out:
                out[sym].append(_dihedral_deg(p[i], p[j], p[k], p[l]))
            elif rsym in out:
                out[rsym].append(_dihedral_deg(p[l], p[k], p[j], p[i]))
    return out


def load_target_geometry(mols, info, dataset_root: str) -> Dict[str, List[float]]:
    """The target distributions: ``<dataset_root>/target_geometry_stat.pk``
    where it exists, else computed from ``mols`` and written there."""
    file_path = os.path.join(dataset_root, "target_geometry_stat.pk")
    if os.path.exists(file_path):
        with open(file_path, "rb") as f:
            return pickle.load(f)
    bond = cal_bond_distance(mols, info["top_bond_sym"])
    angle = cal_bond_angle(mols, info["top_angle_sym"])
    dihedral = cal_dihedral_angle(mols, info["top_dihedral_sym"])
    geo = {**bond, **angle, **dihedral}
    try:
        os.makedirs(dataset_root, exist_ok=True)
        with open(file_path, "wb") as f:
            pickle.dump(geo, f)
    except OSError:
        logging.warning("could not cache geometry stats at %s", file_path)
    return geo


def compute_geo_mmd(gen_mols, tar_geo, cal_fn, top_geo_syms, mean_name: str, device,
                    rng: random.Random) -> Dict[str, float]:
    """Each symbol's MMD on ``device`` (NaN where a side is empty) and their
    NaN-mean under ``mean_name``; a side over ``GEOMETRY_CAP`` samples is cut
    to it by ``rng.sample``, the target side first."""
    res = {}
    gen_geo = cal_fn(gen_mols, top_geo_syms)
    for sym in top_geo_syms:
        tar = tar_geo[sym]
        gen = gen_geo[sym]
        if len(gen) == 0 or len(tar) == 0:
            res[sym] = float("nan")
            continue
        if len(tar) > GEOMETRY_CAP:
            tar = rng.sample(list(tar), GEOMETRY_CAP)
        if len(gen) > GEOMETRY_CAP:
            gen = rng.sample(list(gen), GEOMETRY_CAP)
        res[sym] = compute_mmd(gen, tar, device=device)
    values = np.asarray(list(res.values()), dtype=np.float64)
    # np.nanmean, without its warning when every symbol is NaN
    res[mean_name] = float(values[~np.isnan(values)].mean()) if (~np.isnan(values)).any() \
        else float("nan")
    return res


def get_sub_geometry_metric(test_mols, dataset_info, root_path: str, device=None,
                            seed: int = 42):
    """``sub_geometry_metric(gen_mols) -> {symbol: MMD, ..., the three
    means}`` against the target statistics of ``load_target_geometry``; the
    MMDs on ``device`` (``cuda`` unless ``device="cpu"``), each call's cap
    draws from ``random.Random(seed)``."""
    device = resolve_device(device)
    tar = load_target_geometry(test_mols, dataset_info, root_path)

    def sub_geometry_metric(gen_mols):
        rng = random.Random(seed)
        out = {}
        for cal_fn, syms, mean_name in (
                (cal_bond_distance, dataset_info["top_bond_sym"], "bond_length_mean"),
                (cal_bond_angle, dataset_info["top_angle_sym"], "bond_angle_mean"),
                (cal_dihedral_angle, dataset_info["top_dihedral_sym"], "dihedral_angle_mean")):
            out.update(compute_geo_mmd(gen_mols, tar, cal_fn, syms, mean_name, device, rng))
        return out

    return sub_geometry_metric
