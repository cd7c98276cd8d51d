"""Decoded molecules as graphs: connectivity, the formal-charge-aware
valence check, the Weisfeiler-Lehman hash, and consensus ranking by that
hash. The RDKit-free branch of ``diffspectra_tpu/evaluation/molgraph.py``
and of ``compute_metrics.canonical_id``/``consensus_rank`` (the port's only
copy of the last two; ``evaluation/compute_metrics.py`` imports them)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .bond_analyze import allowed_fc_bonds

BOND_ORDER_VALUE = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}  # 4 = aromatic


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

    def _components(self) -> List[List[int]]:
        """Connected components over nonzero bonds, each in visit order."""
        n = self.n_atoms
        adj = self.bond_orders > 0
        seen = np.zeros(n, dtype=bool)
        comps = []
        for s in range(n):
            if seen[s]:
                continue
            comp = [s]
            seen[s] = True
            stack = [s]
            while stack:
                u = stack.pop()
                for v in np.nonzero(adj[u])[0]:
                    if not seen[v]:
                        seen[v] = True
                        comp.append(int(v))
                        stack.append(int(v))
            comps.append(comp)
        return comps

    def n_fragments(self) -> int:
        """Connected components over nonzero bonds."""
        return len(self._components())

    def largest_fragment(self) -> "MolGraph":
        """The first largest connected component, atoms in index order."""
        best: List[int] = []
        for comp in self._components():
            if len(comp) > len(best):
                best = comp
        idx = np.asarray(sorted(best))
        return MolGraph(
            [self.atom_syms[i] for i in idx],
            self.formal_charges[idx],
            self.bond_orders[np.ix_(idx, idx)],
            None if self.positions is None else self.positions[idx],
        )

    def valence_ok(self) -> bool:
        """Formal-charge-aware valence check: each atom's summed bond orders
        (aromatic 1.5) must be one that ``allowed_fc_bonds`` allows for its
        element and charge."""
        orders = np.vectorize(lambda o: BOND_ORDER_VALUE.get(int(o), 0.0))(
            self.bond_orders
        ) if self.n_atoms else self.bond_orders
        val = orders.sum(axis=1) if self.n_atoms else np.zeros(0)
        for sym, fc, v in zip(self.atom_syms, self.formal_charges, val):
            allowed = allowed_fc_bonds.get(sym)
            if allowed is None:
                return False
            if isinstance(allowed, dict):
                exp = allowed.get(int(fc), allowed.get(0))
            else:
                exp = allowed
            if isinstance(exp, int):
                if v != exp:
                    return False
            else:
                if v not in exp:
                    return False
        return True

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


def canonical_id(mol: Optional[MolGraph]) -> Optional[str]:
    """The structure identity consensus groups by: ``"wl:"`` and the WL
    hash; None for no molecule."""
    return None if mol is None else "wl:" + mol.wl_hash()


def consensus_rank(candidates: Sequence[Optional[MolGraph]]):
    """``[(canonical_id, count, first_index), ...]`` by descending count,
    ties broken by first appearance; missing molecules are skipped."""
    counts: dict = {}
    for i, m in enumerate(candidates):
        cid = canonical_id(m)
        if cid is None:
            continue
        if cid in counts:
            counts[cid][0] += 1
        else:
            counts[cid] = [1, i]
    return sorted(((cid, c, first) for cid, (c, first) in counts.items()),
                  key=lambda t: (-t[1], t[2]))
