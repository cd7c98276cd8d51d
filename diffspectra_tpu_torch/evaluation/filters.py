"""The moses ``Filters`` pass rate on ``MolGraph``s: the graph half of
``diffspectra_tpu/evaluation/filters.py``, which the JAX package runs
without RDKit. moses' ``mol_passes_filters`` checks, in order, that the
molecule sanitises, has no ring of 8 or more atoms, carries no formal
charge, holds only C, N, S, O, F, Cl, Br and H, hits no MCF or PAINS
pattern, and writes a SMILES that parses again. On a graph the charge, the
element set and the ring size (the shortest cycle through each bond, by a
breadth-first search, standing in for the SSSR) are checked; the SMARTS
patterns, the SMILES round trip and the SA score need RDKit, which the port
does not use."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .molgraph import MolGraph

_ALLOWED_ATOMS = {"C", "N", "S", "O", "F", "Cl", "Br", "H"}


def _shortest_cycle_through_edge(bo: np.ndarray, i: int, j: int) -> Optional[int]:
    """Length of the shortest cycle containing edge (i, j): 1 + shortest
    i->j path avoiding the edge itself (BFS)."""
    n = bo.shape[0]
    dist = np.full(n, -1, dtype=np.int64)
    dist[i] = 0
    queue = [i]
    while queue:
        u = queue.pop(0)
        for v in np.nonzero(bo[u])[0]:
            v = int(v)
            if (u == i and v == j) or (u == j and v == i):
                continue
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                queue.append(v)
    return None if dist[j] < 0 else int(dist[j]) + 1


def mol_passes_filters_graph(mol: Optional[MolGraph]) -> bool:
    """Structural subset of the moses protocol on MolGraph (no SMARTS)."""
    if mol is None or mol.n_atoms == 0:
        return False
    if any(int(c) != 0 for c in mol.formal_charges):
        return False
    if any(s not in _ALLOWED_ATOMS for s in mol.atom_syms):
        return False
    bo = mol.bond_orders
    iu, ju = np.nonzero(np.triu(bo, 1))
    for i, j in zip(iu, ju):
        cyc = _shortest_cycle_through_edge(bo, int(i), int(j))
        if cyc is not None and cyc >= 8:
            return False
    return True


def mol_passes_filters(mol: Optional[MolGraph]) -> bool:
    """The JAX package's ``mol_passes_filters`` without RDKit: the graph
    branch."""
    return mol_passes_filters_graph(mol)
