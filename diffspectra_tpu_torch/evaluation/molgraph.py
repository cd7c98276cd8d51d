"""Decoded molecules as graphs, their Weisfeiler-Lehman hash, and consensus
ranking by that hash: the RDKit-free branch of
``diffspectra_tpu/evaluation/molgraph.py`` and of
``compute_metrics.canonical_id``/``consensus_rank``."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class MolGraph:
    """Atoms, formal charges and a dense bond-order matrix (0 none, 1-3,
    4 aromatic), with optional positions."""

    atom_syms: List[str]
    formal_charges: np.ndarray  # [n] int
    bond_orders: np.ndarray  # [n, n] int
    positions: Optional[np.ndarray] = None  # [n, 3]
    _wl_memo: Dict[int, str] = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_atoms(self) -> int:
        return len(self.atom_syms)

    def wl_hash(self, iters: int = 4) -> str:
        """Weisfeiler-Lehman hash over (symbol, charge, bond orders); equal to
        the JAX package's ``MolGraph.wl_hash`` for the same graph."""
        if iters in self._wl_memo:
            return self._wl_memo[iters]
        colors = [f"{s}|{int(c)}" for s, c in zip(self.atom_syms, self.formal_charges)]
        for _ in range(iters):
            new_colors = []
            for i in range(self.n_atoms):
                nbrs = sorted(
                    f"{int(self.bond_orders[i, j])}:{colors[j]}"
                    for j in np.nonzero(self.bond_orders[i])[0]
                )
                sig = colors[i] + "|" + ",".join(nbrs)
                new_colors.append(hashlib.md5(sig.encode()).hexdigest()[:16])
            colors = new_colors
        self._wl_memo[iters] = hashlib.md5(",".join(sorted(colors)).encode()).hexdigest()
        return self._wl_memo[iters]


def from_decoded(mol_tuple, atom_decoder: Sequence[str]) -> MolGraph:
    """From a decoded sampler tuple ``(pos, atom_type, edge_type, fc)``."""
    pos, atom_type, edge_type, fc = mol_tuple
    syms = [atom_decoder[int(a)] for a in np.asarray(atom_type)]
    fc_arr = np.asarray(fc, dtype=np.int64) if np.asarray(fc).size else np.zeros(len(syms), np.int64)
    p = np.asarray(pos, dtype=np.float64) if pos is not None else None
    return MolGraph(syms, fc_arr, np.asarray(edge_type, dtype=np.int64), p)


def canonical_id(mol: MolGraph) -> str:
    return "wl:" + mol.wl_hash()


def consensus_rank(candidates: Sequence[MolGraph]):
    """``[(canonical_id, count, first_index), ...]`` by descending count,
    ties broken by first appearance."""
    counts: dict = {}
    for i, m in enumerate(candidates):
        cid = canonical_id(m)
        if cid in counts:
            counts[cid][0] += 1
        else:
            counts[cid] = [1, i]
    return sorted(((cid, c, first) for cid, (c, first) in counts.items()),
                  key=lambda t: (-t[1], t[2]))
