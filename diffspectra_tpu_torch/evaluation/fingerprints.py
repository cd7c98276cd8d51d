"""Weisfeiler-Lehman subtree fingerprints over ``MolGraph``s and their
Tanimoto and cosine similarities, a copy of ``wl_fingerprint``,
``tanimoto`` and ``cosine`` from ``diffspectra_tpu/evaluation/fingerprints.py``
(the scorer used without RDKit)."""

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
