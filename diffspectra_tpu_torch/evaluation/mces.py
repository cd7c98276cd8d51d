"""Exact MCES (maximum common edge subgraph) distance by branch-and-bound:
the Python search of ``diffspectra_tpu/evaluation/mces.py``, without its C++
twin (``native/mces.cc``; of ``native/`` the port builds only the batch
packer, ``data/native.py``).

    d(G1, G2) = |E1| + |E2| - 2 * |MCES(G1, G2)|

over the heavy-atom graphs (hydrogens excluded, as a SMILES-based protocol
does), where an edge pair may be matched only if both endpoint elements and
the bond order agree. The search runs over injective vertex mappings,
seeded by a greedy descent and branching high-gain candidates first. After
``_MAX_NODES`` search-tree nodes it stops with the incumbent (the distance
is then an upper bound on the exact one) and counts the pair in
``EXHAUSTED_PAIRS``.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from .molgraph import MolGraph

# B&B safety valve: max number of search-tree nodes before falling back.
_MAX_NODES = 2_000_000

# pairs whose search ran out of nodes; the eval log reports them, since a
# mean that mixes upper bounds with exact distances is an upper bound
EXHAUSTED_PAIRS = 0


def _heavy_graph(mol: MolGraph) -> Tuple[List[str], np.ndarray]:
    """Heavy-atom element list + bond-order matrix (H stripped)."""
    idx = [i for i, s in enumerate(mol.atom_syms) if s != "H"]
    syms = [mol.atom_syms[i] for i in idx]
    bo = mol.bond_orders[np.ix_(idx, idx)] if idx else np.zeros((0, 0), np.int64)
    return syms, np.asarray(bo, dtype=np.int64)


def _edge_count(bo: np.ndarray) -> int:
    return int(np.count_nonzero(np.triu(bo, 1)))


def _bfs_order(bo: np.ndarray) -> List[int]:
    """Vertex visit order: BFS from the max-degree vertex, components chained
    by decreasing size, so that the capacity bound bites early."""
    n = bo.shape[0]
    deg = (bo > 0).sum(axis=1)
    seen = np.zeros(n, dtype=bool)
    order: List[int] = []
    while len(order) < n:
        roots = [i for i in range(n) if not seen[i]]
        root = max(roots, key=lambda i: deg[i])
        queue = [root]
        seen[root] = True
        while queue:
            u = queue.pop(0)
            order.append(u)
            nbrs = sorted(
                (int(v) for v in np.nonzero(bo[u])[0] if not seen[v]),
                key=lambda v: -deg[v],
            )
            for v in nbrs:
                seen[v] = True
                queue.append(v)
    return order


def max_common_edges(
    syms1: List[str], bo1: np.ndarray, syms2: List[str], bo2: np.ndarray
) -> Tuple[int, bool]:
    """|MCES|: max #edges of a common subgraph under an injective vertex
    mapping that preserves element labels and bond orders.

    Returns ``(best, exact)``: ``best`` is the size of a realized common
    subgraph (a lower bound on |MCES|); ``exact`` is False when the node
    budget ran out before the search closed."""
    if len(syms1) > len(syms2) or (
        len(syms1) == len(syms2) and _edge_count(bo1) > _edge_count(bo2)
    ):
        syms1, bo1, syms2, bo2 = syms2, bo2, syms1, bo1
    n1, n2 = len(syms1), len(syms2)
    e1, e2 = _edge_count(bo1), _edge_count(bo2)
    if e1 == 0 or e2 == 0:
        return 0, True

    order = _bfs_order(bo1)
    # edges_closed[k]: #edges of G1 decided when placing order[k] (its other
    # endpoint already placed)
    placed_set: set = set()
    edges_closed = []
    for v in order:
        edges_closed.append(sum(1 for u in placed_set if bo1[v, u] > 0))
        placed_set.add(v)
    # suffix[k]: #G1-edges not yet decided after placing order[:k]
    suffix = np.cumsum(np.asarray(edges_closed[::-1]))[::-1]

    # candidate targets per G1 vertex (element-compatible)
    cand = {v: [u for u in range(n2) if syms2[u] == syms1[v]] for v in range(n1)}

    cap = min(e1, e2)  # no common subgraph can exceed the smaller edge set
    mapping = np.full(n1, -1, dtype=np.int64)
    used = np.zeros(n2, dtype=bool)

    # the greedy descent seeds the incumbent, so that the capacity bound
    # prunes from the first branch
    greedy = 0
    for k, v in enumerate(order):
        prev = [u for u in order[:k] if mapping[u] >= 0 and bo1[v, u] > 0]
        best_t, best_g = -1, -1
        for t in cand[v]:
            if used[t]:
                continue
            g = sum(1 for u in prev if bo2[t, mapping[u]] == bo1[v, u])
            if g > best_g:
                best_g, best_t = g, t
        if best_t >= 0:
            mapping[v] = best_t
            used[best_t] = True
            greedy += best_g
    best = greedy
    if best >= cap:
        return cap, True
    mapping[:] = -1
    used[:] = False

    nodes = 0
    done = False

    def bound(k: int, matched: int) -> int:
        rem1 = int(suffix[k]) if k < n1 else 0
        return matched + min(rem1, e2 - matched)

    def rec(k: int, matched: int) -> bool:
        """Returns False when the node budget is exhausted."""
        nonlocal best, nodes, done
        nodes += 1
        if nodes > _MAX_NODES:
            return False
        if matched > best:
            best = matched
            if best >= cap:  # perfect: nothing bigger exists
                done = True
        if done or k == n1 or bound(k, matched) <= best:
            return True
        v = order[k]
        prev = [u for u in order[:k] if mapping[u] >= 0 and bo1[v, u] > 0]
        # high-gain candidates first: the incumbent rises early and prunes
        # the siblings it dominates
        scored = sorted(
            (
                (sum(1 for u in prev if bo2[tgt, mapping[u]] == bo1[v, u]), tgt)
                for tgt in cand[v]
                if not used[tgt]
            ),
            key=lambda x: -x[0],
        )
        for gain, tgt in scored:
            mapping[v] = tgt
            used[tgt] = True
            ok = rec(k + 1, matched + gain)
            mapping[v] = -1
            used[tgt] = False
            if not ok:
                return False
            if done:
                return True
        # also branch on leaving v unmapped
        return rec(k + 1, matched)

    ok = rec(0, 0)
    return best, bool(ok)


def mces_distance(m1: MolGraph, m2: MolGraph) -> float:
    """Exact MCES distance |E1|+|E2|-2|MCES| over heavy-atom graphs; on
    budget exhaustion an upper bound, counted in ``EXHAUSTED_PAIRS``."""
    syms1, bo1 = _heavy_graph(m1)
    syms2, bo2 = _heavy_graph(m2)
    e1, e2 = _edge_count(bo1), _edge_count(bo2)
    common, exact = max_common_edges(syms1, bo1, syms2, bo2)
    if not exact:
        global EXHAUSTED_PAIRS
        EXHAUSTED_PAIRS += 1
        logging.warning(
            "mces_distance: B&B budget exhausted (%d vs %d heavy atoms); "
            "returning incumbent-bound distance (upper bound on exact)",
            len(syms1), len(syms2),
        )
    return float(e1 + e2 - 2 * common)
