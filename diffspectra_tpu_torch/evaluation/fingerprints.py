"""Structural fingerprints over ``MolGraph``s, the RDKit-free scorer of
``diffspectra_tpu/evaluation/fingerprints.py`` copied whole: Weisfeiler-Lehman
subtree fingerprints and their Tanimoto and cosine similarities; binary
Tanimoto over whole sets as blockwise sparse products (the moses SNN and
internal diversity); prune-based scaffolds, bond-environment fragments, the
molecular weight, and the descriptor vector whose Frechet distance is the
``FCD_proxy``. scipy (CSR products, ``sqrtm``) is imported inside the
functions that use it."""

from __future__ import annotations

import hashlib
from collections import Counter

import numpy as np

from .molgraph import MolGraph


def wl_fingerprint(mol: MolGraph, radius: int = 2) -> Counter:
    """Sparse {feature_hash: count} over WL iterations 0..radius."""
    n = mol.n_atoms
    feats: Counter = Counter()
    colors = [f"{s}|{int(c)}" for s, c in zip(mol.atom_syms, mol.formal_charges)]
    for c in colors:
        feats[hashlib.md5(c.encode()).hexdigest()[:12]] += 1
    for _ in range(radius):
        new_colors = []
        for i in range(n):
            nbrs = sorted(
                f"{int(mol.bond_orders[i, j])}:{colors[j]}"
                for j in np.nonzero(mol.bond_orders[i])[0]
            )
            sig = colors[i] + "|" + ",".join(nbrs)
            h = hashlib.md5(sig.encode()).hexdigest()[:12]
            new_colors.append(h)
            feats[h] += 1
        colors = new_colors
    return feats


def tanimoto(fp1: Counter, fp2: Counter) -> float:
    """Binary Tanimoto over present features."""
    s1, s2 = set(fp1), set(fp2)
    union = len(s1 | s2)
    return len(s1 & s2) / union if union else 0.0


def cosine(fp1: Counter, fp2: Counter) -> float:
    """Count-weighted cosine."""
    keys = set(fp1) | set(fp2)
    v1 = np.array([fp1.get(k, 0) for k in keys], dtype=np.float64)
    v2 = np.array([fp2.get(k, 0) for k in keys], dtype=np.float64)
    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(np.dot(v1, v2) / denom) if denom else 0.0


def counters_to_csr(fps, vocab: dict):
    """List of Counter fingerprints -> binary scipy CSR over ``vocab``
    (features absent from vocab are added in place)."""
    import scipy.sparse as sp

    rows, cols = [], []
    for r, fp in enumerate(fps):
        for k in fp:
            c = vocab.setdefault(k, len(vocab))
            rows.append(r)
            cols.append(c)
    return sp.csr_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)),
        shape=(len(fps), max(len(vocab), 1)),
    )


def _block_tanimoto(a, b, sa, sb):
    """Dense [a.rows, b.rows] binary-Tanimoto block from (sparse or dense)
    binary matrices with precomputed row sums."""
    inter = np.asarray((a @ b.T).todense() if hasattr(a, "todense") else a @ b.T,
                       dtype=np.float64)
    union = sa[:, None] + sb[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    return out


def snn_matrix(gen_mat, ref_mat, block: int = 1024) -> float:
    """moses SNNMetric: mean over GEN of the max Tanimoto to the reference
    set (one-way, full sets, blockwise so 10k x 13k fits in memory)."""
    if gen_mat.shape[0] == 0 or ref_mat.shape[0] == 0:
        return float("nan")
    sg = np.asarray(gen_mat.sum(axis=1)).reshape(-1)
    sr = np.asarray(ref_mat.sum(axis=1)).reshape(-1)
    maxima = np.full(gen_mat.shape[0], -np.inf)
    for i in range(0, gen_mat.shape[0], block):
        gi = gen_mat[i : i + block]
        for j in range(0, ref_mat.shape[0], block):
            t = _block_tanimoto(gi, ref_mat[j : j + block], sg[i : i + block],
                                sr[j : j + block])
            maxima[i : i + block] = np.maximum(maxima[i : i + block], t.max(1))
    return float(maxima.mean())


def internal_diversity_matrix(mat, block: int = 1024) -> float:
    """moses internal_diversity (p=1): 1 - mean pairwise Tanimoto over the
    full n x n grid INCLUDING the diagonal (moses average_agg_tanimoto
    aggregates each row over all stock vectors, itself included)."""
    n = mat.shape[0]
    if n < 2:
        return float("nan")
    s = np.asarray(mat.sum(axis=1)).reshape(-1)
    total = 0.0
    for i in range(0, n, block):
        for j in range(0, n, block):
            total += _block_tanimoto(
                mat[i : i + block], mat[j : j + block], s[i : i + block],
                s[j : j + block],
            ).sum()
    return float(1.0 - total / (n * n))


def scaffold_hash(mol: MolGraph) -> str:
    """Murcko-style scaffold: iteratively prune degree-1 atoms (keeps rings
    and linkers), then WL-hash the remainder. Empty scaffold -> ''."""
    keep = np.ones(mol.n_atoms, dtype=bool)
    orders = mol.bond_orders.copy()
    changed = True
    while changed:
        changed = False
        deg = (orders > 0).sum(axis=1)
        prune = keep & (deg <= 1)
        if prune.any():
            # only prune if something with degree >= 2 remains
            if (keep & ~prune).any():
                keep[prune] = False
                orders[prune, :] = 0
                orders[:, prune] = 0
                changed = True
            else:
                keep[:] = False
                break
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        return ""
    sub = MolGraph(
        [mol.atom_syms[i] for i in idx],
        mol.formal_charges[idx],
        mol.bond_orders[np.ix_(idx, idx)],
    )
    return sub.wl_hash()


def fragment_counts(mol: MolGraph) -> Counter:
    """Bond-environment fragment counts (stand-in for BRICS fragments in the
    moses Frag metric): each bond labelled by its WL-1 endpoint colors."""
    fp: Counter = Counter()
    colors = [f"{s}|{int(c)}" for s, c in zip(mol.atom_syms, mol.formal_charges)]
    refined = []
    for i in range(mol.n_atoms):
        nbrs = sorted(
            f"{int(mol.bond_orders[i, j])}:{colors[j]}"
            for j in np.nonzero(mol.bond_orders[i])[0]
        )
        refined.append(
            hashlib.md5((colors[i] + "|" + ",".join(nbrs)).encode()).hexdigest()[:12]
        )
    iu, ju = np.nonzero(np.triu(mol.bond_orders, 1))
    for i, j in zip(iu, ju):
        lab = "-".join(sorted([refined[i], refined[j]])) + f":{int(mol.bond_orders[i, j])}"
        fp[hashlib.md5(lab.encode()).hexdigest()[:12]] += 1
    return fp


ATOMIC_WEIGHTS = {"H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998}


def mol_weight(mol: MolGraph) -> float:
    return float(sum(ATOMIC_WEIGHTS.get(s, 0.0) for s in mol.atom_syms))


def descriptor_vector(mol: MolGraph) -> np.ndarray:
    """Simple descriptor vector for the Frechet-distance FCD proxy: element
    counts, bond-order counts, ring count (cyclomatic), weight, size."""
    elems = ["H", "C", "N", "O", "F"]
    e_counts = [mol.atom_syms.count(e) for e in elems]
    orders = mol.bond_orders
    n_bonds = [(np.triu(orders, 1) == o).sum() for o in (1, 2, 3, 4)]
    n_edge = sum(n_bonds)
    n_comp = mol.n_fragments()
    cyclomatic = n_edge - mol.n_atoms + n_comp
    return np.array(
        e_counts + n_bonds + [cyclomatic, mol_weight(mol) / 10.0, mol.n_atoms],
        dtype=np.float64,
    )


def frechet_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Frechet distance between Gaussians fit to descriptor rows (each
    covariance plus 1e-6 I; the real part of ``sqrtm``)."""
    import scipy.linalg

    mu1, mu2 = x.mean(0), y.mean(0)
    c1 = np.cov(x, rowvar=False) + 1e-6 * np.eye(x.shape[1])
    c2 = np.cov(y, rowvar=False) + 1e-6 * np.eye(y.shape[1])
    diff = mu1 - mu2
    covmean = np.real(scipy.linalg.sqrtm(c1 @ c2))
    return float(diff @ diff + np.trace(c1 + c2 - 2 * covmean))
