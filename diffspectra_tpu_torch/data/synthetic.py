"""Synthetic QM9S-like molecules and spectra (numpy only).

A copy of ``diffspectra_tpu/data/synthetic.py``, its on-disk cache
included, so that the port can make real requests (spectra of known molecules, fidelity 4
being what ``artifacts/warm_qm9s_as.npz`` was tuned on) without importing the
JAX package. ``generate(seed, size, max_n, fidelity=...)`` returns the same
arrays from the same seed as the original.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .info import get_dataset_info

SPEC_LENS = {"uv": 701, "ir": 3501, "raman": 3501}

# covalent-ish single-bond lengths in Angstrom for H,C,N,O,F (symmetric)
_BOND_LEN = np.array(
    [
        [0.74, 1.09, 1.01, 0.96, 0.92],
        [1.09, 1.54, 1.47, 1.43, 1.35],
        [1.01, 1.47, 1.45, 1.40, 1.36],
        [0.96, 1.43, 1.40, 1.48, 1.42],
        [0.92, 1.35, 1.36, 1.42, 1.42],
    ]
)


def _sample_n_atoms(rng, info, size):
    hist = info["train_n_nodes"]
    ns = np.array(sorted(hist))
    probs = np.array([hist[n] for n in ns], dtype=np.float64)
    probs /= probs.sum()
    return rng.choice(ns, size=size, p=probs)


_VALENCE = np.array([1, 4, 3, 2, 1])  # H, C, N, O, F


def _random_tree_molecule(rng, n, max_n):
    """Build a random VALENCE-CORRECT molecule with plausible geometry.

    A heavy-atom tree is grown respecting remaining valences, bond orders are
    upgraded only where both endpoints have spare valence, and hydrogens fill
    every remaining slot — so the ground-truth set passes the same stability
    checks real QM9 molecules do (evaluation/bond_analyze.py valence rules)
    and validity/novelty/similarity metrics are meaningful on synthetic data.
    May return fewer than ``n`` atoms (valences bound the H count)."""
    n_heavy = max(1, int(round(n * rng.uniform(0.35, 0.5))))
    heavy_types = rng.choice([1, 2, 3, 4], size=n_heavy, p=[0.72, 0.12, 0.14, 0.02])
    free = _VALENCE[heavy_types].astype(np.int64)

    bonds = {}  # (i, j) -> order over heavy atoms
    order_in_tree = [0]
    for i in range(1, n_heavy):
        candidates = [j for j in order_in_tree if free[j] >= 1]
        if not candidates or free[i] < 1:
            # cannot attach more heavy atoms; stop growing
            n_heavy = i
            heavy_types = heavy_types[:n_heavy]
            free = free[:n_heavy]
            break
        p = int(rng.choice(candidates))
        bonds[(p, i)] = 1
        free[p] -= 1
        free[i] -= 1
        order_in_tree.append(i)

    # bond-order upgrades where both endpoints have spare valence
    for (a, b) in list(bonds):
        if rng.random() < 0.2:
            extra = int(rng.choice([1, 2], p=[0.85, 0.15]))
            extra = min(extra, free[a], free[b])
            if extra > 0:
                bonds[(a, b)] += extra
                free[a] -= extra
                free[b] -= extra

    # hydrogens MUST fill every remaining valence (validity); if the total
    # exceeds max_n, drop trailing heavy atoms (and their bonds) first
    def required_h(nh):
        return int(free[:nh].sum())

    while n_heavy > 1 and n_heavy + required_h(n_heavy) > max_n:
        # remove the last heavy atom: restore valence consumed by its bonds
        i = n_heavy - 1
        for (a, b) in [k for k in bonds if i in k]:
            o = bonds.pop((a, b))
            other = a if b == i else b
            free[other] += o
        n_heavy -= 1
        heavy_types = heavy_types[:n_heavy]
        free = free[:n_heavy]
    h_hosts = []
    for i in range(n_heavy):
        h_hosts += [i] * int(free[i])
    rng.shuffle(h_hosts)
    n_total = n_heavy + len(h_hosts)

    types = np.zeros(n_total, dtype=np.int64)
    types[:n_heavy] = heavy_types
    edge = np.zeros((max_n, max_n), dtype=np.int64)
    for (a, b), o in bonds.items():
        edge[a, b] = edge[b, a] = o
    for k, host in enumerate(h_hosts):
        i = n_heavy + k
        edge[i, host] = edge[host, i] = 1

    # geometry: place each atom near its (first) bonded parent
    pos = np.zeros((n_total, 3), dtype=np.float64)
    placed = {0}
    parent = np.full(n_total, -1, dtype=np.int64)
    for (a, b) in bonds:
        parent[b] = a if parent[b] < 0 else parent[b]
        parent[a] = parent[a]
    for k, host in enumerate(h_hosts):
        parent[n_heavy + k] = host
    # rejection-sample directions so non-bonded atoms keep their distance
    # (the 3D stability metric infers bonds from distances,
    # evaluation/bond_analyze.py:108-133 — clashes create spurious bonds)
    for i in range(1, n_total):
        p = parent[i] if parent[i] >= 0 else 0
        blen = _BOND_LEN[types[p], types[i]] * rng.uniform(0.97, 1.03)
        best, best_min = None, -1.0
        for _ in range(24):
            d = rng.normal(size=3)
            d /= np.linalg.norm(d) + 1e-9
            cand = pos[p] + d * blen
            others = np.delete(np.arange(i), p)
            min_dist = (
                np.min(np.linalg.norm(pos[others] - cand, axis=1))
                if len(others)
                else np.inf
            )
            if min_dist > best_min:
                best, best_min = cand, min_dist
            if min_dist > 1.8:
                break
        pos[i] = best
    pos -= pos.mean(0, keepdims=True)

    out_pos = np.zeros((max_n, 3), dtype=np.float32)
    out_pos[:n_total] = pos
    out_types = np.zeros(max_n, dtype=np.int64)
    out_types[:n_total] = types
    return out_types, out_pos, edge, n_total


def _cyclic_polygon_radius(sides):
    """Circumradius of a cyclic polygon with the given side lengths
    (bisection on R: sum of central angles 2*asin(s/(2R)) == 2*pi)."""
    import math

    lo = max(sides) / 2.0 + 1e-9
    hi = sum(sides)  # generous upper bound

    def angle_sum(R):
        return sum(2.0 * math.asin(min(1.0, s / (2.0 * R))) for s in sides)

    # angle_sum decreases with R; find R with angle_sum == 2*pi
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if angle_sum(mid) > 2.0 * math.pi:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _place_ring(sides, origin, rng):
    """3D coordinates of a planar cyclic polygon with given side lengths,
    random orientation, first vertex at ``origin``."""
    import math

    R = _cyclic_polygon_radius(sides)
    angles = [0.0]
    for s in sides[:-1]:
        angles.append(angles[-1] + 2.0 * math.asin(min(1.0, s / (2.0 * R))))
    pts2 = np.array(
        [[R * math.cos(a), R * math.sin(a)] for a in angles]
    )
    # random orthonormal plane basis
    b1 = rng.normal(size=3)
    b1 /= np.linalg.norm(b1)
    b2 = rng.normal(size=3)
    b2 -= b1 * (b2 @ b1)
    b2 /= np.linalg.norm(b2)
    pts = pts2[:, 0:1] * b1 + pts2[:, 1:2] * b2
    return pts - pts[0] + origin


# ring recipes: (size, aromatic) -> per-position (type choices, ring orders)
# orders are KEKULIZED (1/2/3 only): the reference protocol trains with
# include_aromatic=False on kekulized SDF bonds (ref qm9s_dataset.py:226-231
# reads with sanitize=False and would print 'meet aromatic bond!' otherwise;
# ref configs/diffspectra_qm9s.py:25), so benzene appears as alternating
# single/double exactly as in the real processed data.
def _ring_recipe(rng, size, aromatic):
    if aromatic and size == 6:
        orders = [1, 2, 1, 2, 1, 2]
        types, used = [], []
        n_nitrogen = int(rng.choice([0, 1, 2], p=[0.6, 0.3, 0.1]))
        nitro_pos = set(rng.choice(6, size=n_nitrogen, replace=False).tolist())
        for i in range(6):
            # each aromatic position uses 3 valence units (1+2)
            if i in nitro_pos:
                types.append(2)  # N: valence 3, no substituent slot
            else:
                types.append(1)  # C: one substituent slot
            used.append(3)
        return types, orders, used
    if aromatic and size == 5:
        # furan/pyrrole-like: heteroatom at position 0, two C=C
        orders = [1, 2, 1, 2, 1]
        het = int(rng.choice([2, 3], p=[0.5, 0.5]))  # N or O
        types = [het, 1, 1, 1, 1]
        used = [2, 3, 3, 3, 3]
        return types, orders, used
    # saturated ring: all single bonds, each atom uses 2
    orders = [1] * size
    types = [int(rng.choice([1, 2, 3], p=[0.80, 0.12, 0.08])) for _ in range(size)]
    used = [2] * size
    return types, orders, used


def _random_ring_molecule(rng, n, max_n):
    """Ring-bearing valence-correct molecule (fidelity>=3 structural mode).

    One ring (optionally two fused saturated rings) of 3-6 heavy atoms with
    kekulized aromatic patterns, substituent trees grown off free ring
    valences, bond-order upgrades on tree bonds, hydrogens filling every
    remaining slot. Geometry: planar cyclic-polygon rings with per-edge
    kekulized bond lengths (alternating 1.34/1.54-class sides for aromatic
    systems, so the 3D distance->order inference of
    evaluation/bond_analyze.py agrees with the declared kekulized orders),
    substituents via the same clash-rejection placement as the tree
    generator. Exercises Scaf (Murcko scaffolds), the kekulize path of
    evaluation/stability.py, and ring geometry MMD — the chemistry the
    acyclic fidelity-1/2 sets left untrained (VERDICT r2 weak-3)."""
    size = int(rng.choice([3, 4, 5, 6], p=[0.05, 0.10, 0.40, 0.45]))
    aromatic = size in (5, 6) and rng.random() < (0.55 if size == 6 else 0.3)
    types_r, orders_r, used_r = _ring_recipe(rng, size, aromatic)

    # optionally fuse a second saturated ring on a single-bond edge
    fuse = rng.random() < 0.25
    fuse_size = int(rng.choice([5, 6], p=[0.5, 0.5])) if fuse else 0

    heavy_types = list(types_r)
    bonds = {}
    free = []
    for i, (t, u) in enumerate(zip(types_r, used_r)):
        free.append(int(_VALENCE[t]) - u)
    for i in range(size):
        j = (i + 1) % size
        bonds[(min(i, j), max(i, j))] = orders_r[i]

    ring_atoms = set(range(size))
    fused_atoms = []
    if fuse:
        # shared edge must be a single bond with both endpoints having
        # spare valence (each gains one more ring bond)
        cand = [
            (a, b) for (a, b), o in bonds.items()
            if o == 1 and free[a] >= 1 and free[b] >= 1
        ]
        if cand:
            a, b = cand[int(rng.choice(len(cand)))]
            new_idx = list(range(size, size + fuse_size - 2))
            chain = [a] + new_idx + [b]
            for t_i in new_idx:
                t = int(rng.choice([1, 2, 3], p=[0.85, 0.10, 0.05]))
                heavy_types.append(t)
                free.append(int(_VALENCE[t]) - 2)
            for u_, v_ in zip(chain[:-1], chain[1:]):
                key = (min(u_, v_), max(u_, v_))
                if key not in bonds:
                    bonds[key] = 1
            free[a] -= 1
            free[b] -= 1
            ring_atoms |= set(new_idx)
            fused_atoms = new_idx

    n_scaffold = len(heavy_types)
    # scaffold + its required hydrogens must fit; else fall back to tree
    if n_scaffold + sum(max(0, f) for f in free) > max_n:
        return _random_tree_molecule(rng, n, max_n)

    # grow substituent tree atoms off free valences up to ~n*0.45 heavy
    n_heavy_target = max(n_scaffold, int(round(n * rng.uniform(0.35, 0.5))))
    heavy_types = list(heavy_types)
    i = n_scaffold
    order_in_tree = [k for k in range(n_scaffold) if free[k] >= 1]
    while i < n_heavy_target and order_in_tree:
        t = int(rng.choice([1, 2, 3, 4], p=[0.72, 0.12, 0.14, 0.02]))
        p = int(rng.choice(order_in_tree))
        heavy_types.append(t)
        free.append(int(_VALENCE[t]) - 1)
        bonds[(min(p, i), max(p, i))] = 1
        free[p] -= 1
        order_in_tree = [k for k in range(i + 1) if free[k] >= 1]
        i += 1
    n_heavy = len(heavy_types)

    # bond-order upgrades on NON-RING bonds only (ring orders are fixed by
    # the recipe; upgrading one would break kekulization/valence)
    for (a, b) in list(bonds):
        if a in ring_atoms and b in ring_atoms:
            continue
        if rng.random() < 0.2:
            extra = int(rng.choice([1, 2], p=[0.85, 0.15]))
            extra = min(extra, free[a], free[b])
            if extra > 0:
                bonds[(a, b)] += extra
                free[a] -= extra
                free[b] -= extra

    free = np.asarray(free, dtype=np.int64)

    # hydrogens fill every remaining valence; trim TREE atoms (never ring
    # atoms) if the total exceeds max_n
    def required_h(nh):
        return int(free[:nh].sum())

    while n_heavy > n_scaffold and n_heavy + required_h(n_heavy) > max_n:
        idx = n_heavy - 1
        for key in [k for k in bonds if idx in k]:
            o = bonds.pop(key)
            other = key[0] if key[1] == idx else key[1]
            free[other] += o
        n_heavy -= 1
        heavy_types = heavy_types[:n_heavy]
        free = free[:n_heavy]
    if n_heavy + required_h(n_heavy) > max_n:
        return _random_tree_molecule(rng, n, max_n)

    h_hosts = []
    for k in range(n_heavy):
        h_hosts += [k] * int(free[k])
    rng.shuffle(h_hosts)
    n_total = n_heavy + len(h_hosts)

    types = np.zeros(n_total, dtype=np.int64)
    types[:n_heavy] = heavy_types
    edge = np.zeros((max_n, max_n), dtype=np.int64)
    for (a, b), o in bonds.items():
        edge[a, b] = edge[b, a] = o
    for k, host in enumerate(h_hosts):
        idx = n_heavy + k
        edge[idx, host] = edge[host, idx] = 1

    # ---- geometry ----
    pos = np.zeros((n_total, 3), dtype=np.float64)

    def blen(a, b, order):
        # kekulized bond lengths: double ~13% and triple ~22% shorter than
        # the single-bond table, matching the 3D distance->order inference
        # bands of evaluation/bond_analyze.py
        base = _BOND_LEN[types[a], types[b]]
        return base * {1: 1.0, 2: 0.87, 3: 0.78}[min(int(order), 3)]

    sides = [blen(i, (i + 1) % size, orders_r[i]) for i in range(size)]
    pos[:size] = _place_ring(sides, np.zeros(3), rng)
    placed = set(range(size))

    if fused_atoms:
        # place the fused ring IN PLANE on the far side of the shared edge
        # so its closing bond distance is exact (the clash-rejection walk
        # below cannot honor ring closure). The shared-edge endpoints are
        # the two primary-ring atoms bonded to fused-chain atoms.
        ends = [
            x for x in range(size)
            if any((min(x, c), max(x, c)) in bonds for c in fused_atoms)
        ]
        a, b = ends[0], ends[1]
        chain = [a] + fused_atoms + [b]
        # ensure chain order is bond-consecutive (fused_atoms were appended
        # in chain order at construction)
        side_list = [
            blen(u_, v_, bonds[(min(u_, v_), max(u_, v_))])
            for u_, v_ in zip(chain[:-1], chain[1:])
        ] + [float(np.linalg.norm(pos[b] - pos[a]))]
        pts2 = None
        try:
            R = _cyclic_polygon_radius(side_list)
            import math as _m

            angs = [0.0]
            for s in side_list[:-1]:
                angs.append(angs[-1] + 2.0 * _m.asin(min(1.0, s / (2.0 * R))))
            pts2 = np.array(
                [[R * _m.cos(t), R * _m.sin(t)] for t in angs]
            )
        except Exception:
            pts2 = None
        if pts2 is not None:
            # rigid-map the 2D polygon (v0=a ... v_last=b) into the primary
            # ring's plane, on the side of edge a-b away from ring A
            q = pts2[-1] - pts2[0]
            qn = np.linalg.norm(q) + 1e-12
            qh = q / qn
            qp = np.array([-qh[1], qh[0]])
            e3 = pos[b] - pos[a]
            u3 = e3 / (np.linalg.norm(e3) + 1e-12)
            nrm = np.cross(pos[1] - pos[0], pos[2] - pos[0])
            nrm /= np.linalg.norm(nrm) + 1e-12
            w3 = np.cross(nrm, u3)
            centroid_a = pos[:size].mean(0)
            if w3 @ (centroid_a - pos[a]) > 0:
                w3 = -w3
            loc = pts2 - pts2[0]
            xs = loc @ qh
            ys = loc @ qp
            cand1 = pos[a] + xs[:, None] * u3 + ys[:, None] * w3
            cand2 = pos[a] + xs[:, None] * u3 - ys[:, None] * w3
            # pick the mirror whose centroid is farther from ring A
            pick = cand1 if (
                np.linalg.norm(cand1.mean(0) - centroid_a)
                >= np.linalg.norm(cand2.mean(0) - centroid_a)
            ) else cand2
            for t_i, p3 in zip(chain[1:-1], pick[1:-1]):
                pos[t_i] = p3
                placed.add(t_i)

    # remaining atoms (tree, H): parent-based clash-rejection placement
    parent = np.full(n_total, -1, dtype=np.int64)
    for (a, b) in sorted(bonds, key=lambda kv: max(kv)):
        hi_ = max(a, b)
        if parent[hi_] < 0:
            parent[hi_] = min(a, b)
    for k, host in enumerate(h_hosts):
        parent[n_heavy + k] = host
    for idx in range(n_total):
        if idx in placed:
            continue
        p = int(parent[idx]) if parent[idx] >= 0 else 0
        o = int(edge[p, idx]) if edge[p, idx] > 0 else 1
        length = blen(p, idx, o) * rng.uniform(0.97, 1.03)
        best, best_min = None, -1.0
        others = np.array(
            [j for j in range(n_total) if j in placed and j != p], dtype=np.int64
        )
        for _ in range(24):
            d = rng.normal(size=3)
            d /= np.linalg.norm(d) + 1e-9
            cand = pos[p] + d * length
            min_dist = (
                float(np.min(np.linalg.norm(pos[others] - cand, axis=1)))
                if len(others) else np.inf
            )
            if min_dist > best_min:
                best, best_min = cand, min_dist
            if min_dist > 1.8:
                break
        pos[idx] = best
        placed.add(idx)
    pos -= pos.mean(0, keepdims=True)

    out_pos = np.zeros((max_n, 3), dtype=np.float32)
    out_pos[:n_total] = pos
    out_types = np.zeros(max_n, dtype=np.int64)
    out_types[:n_total] = types
    return out_types, out_pos, edge, n_total


def _wl_environments(atom_types, edge_type, n_atoms):
    """Per-atom WL-1 and WL-2 local-environment labels (stable hashes).

    WL-1: (own type, sorted multiset of (neighbor type, bond order)).
    WL-2: (own WL-1 label, sorted multiset of neighbor WL-1 labels).
    Real vibrational modes are functions of the local bonding environment;
    these labels are the graph-theoretic analogue, and their multiset is
    near-injective over isomorphism classes of QM9-sized molecules (see
    tools/ceiling_analysis.py)."""
    import hashlib

    def h64(obj) -> int:
        return int.from_bytes(
            hashlib.md5(repr(obj).encode()).digest()[:8], "little"
        )

    nbrs = [
        [(int(atom_types[j]), int(edge_type[i, j]))
         for j in np.nonzero(edge_type[i, :n_atoms])[0]]
        for i in range(n_atoms)
    ]
    wl1 = [h64((int(atom_types[i]), tuple(sorted(nbrs[i]))))
           for i in range(n_atoms)]
    wl2 = [
        h64((wl1[i], tuple(sorted(
            wl1[j] for j in np.nonzero(edge_type[i, :n_atoms])[0]
        ))))
        for i in range(n_atoms)
    ]
    return wl1, wl2


# ---------------------------------------------------------------------------
# Fidelity-4: CONTINUOUS-in-structure spectra (the interventional test of the
# Top-10 information-ceiling claim, VERDICT r3 next-1).
#
# Fidelity-2 keys its local-environment peaks on WL HASHES: an environment
# never seen in training contributes peaks at positions carrying NO
# generalizable information, capping unseen-target Top-10 at the train
# WL-coverage fraction (~0.82, tools/unseen_env_analysis.py). Real DFT
# spectra are CONTINUOUS functions of local structure: similar environments
# produce similar frequencies (a C=O stretch shifts smoothly with
# conjugation), so a model interpolates to unseen environments. Fidelity-4
# reproduces that property: peak POSITIONS are smooth functions of
# continuous local descriptors (bond-order-weighted neighbor
# electronegativity / mass sums and their 2-hop composites — the continuous
# analogue of the WL-1/WL-2 neighborhoods), so an unseen environment whose
# composition is close to seen ones produces *near*-seen peaks. If the
# ceiling claim is right, unseen-target Top-10 on fidelity-4 should climb
# toward the reference's real-data 99.49% (ref README.md:15).
# ---------------------------------------------------------------------------

_ELEM_MASS = np.array([1.008, 12.011, 14.007, 15.999, 18.998])  # H C N O F
_ELEM_EN = np.array([2.20, 2.55, 3.04, 3.44, 3.98])  # Pauling

# standardization constants for the 9 atom descriptors / 5 bond descriptors,
# measured once over 3000 generator molecules (fixed: they are part of the
# spectrum definition, not fit to any particular dataset)
_F4_ATOM_MU = np.array(
    [2.4155, 1.9708, 4.9842, 1.7638, 5.3775, 12.8143, 5.6542, 14.1021, 4.4054]
)
_F4_ATOM_SD = np.array(
    [0.3566, 1.3305, 3.2531, 1.0223, 4.1341, 8.4219, 2.9796, 7.6689, 3.4002]
)
_F4_BOND_MU = np.array([1.0372, 0.8124, 5.0501, 5.6674, 14.1105])
_F4_BOND_SD = np.array([0.1999, 0.3050, 0.4512, 1.3338, 3.5021])
# measured std of each unit-norm projection's output over the standardized
# descriptors (descriptor components are correlated); the per-band gain
# 1.6/sd makes sigmoid(gain*z) fill its band without saturating
_F4_ATOM_ZSD = np.array(
    [[1.3356, 1.0640], [1.4086, 0.9088], [0.8260, 0.4958]]
)
_F4_BOND_ZSD = np.array([0.9185, 1.2400, 0.6805])

# fixed random projection directions (deterministic: part of the spectrum
# definition). Two independent projections per channel for atoms — a
# collision of DISTINCT environments requires both to coincide — plus one
# per channel for bonds.
_f4_wrng = np.random.default_rng(20260820)
_F4_W = _f4_wrng.normal(size=(3, 2, 9))
_F4_W /= np.linalg.norm(_F4_W, axis=-1, keepdims=True)
_F4_WB = _f4_wrng.normal(size=(3, 5))
_F4_WB /= np.linalg.norm(_F4_WB, axis=-1, keepdims=True)
del _f4_wrng

# spectral band layout (fractions of the channel length): two atom bands,
# one bond band — mirroring how real IR separates fingerprint/functional
# regions. Element-count baseline peaks (discrete but over a fully-seen
# 5-symbol vocabulary) reuse the fidelity-1 formula.
_F4_BANDS = ((0.02, 0.34), (0.36, 0.68))
_F4_BOND_BAND = (0.70, 0.97)
_F4_WIDTH = 0.004


def _continuous_descriptors(atom_types, edge_type, n_atoms):
    """[n, 9] continuous local-environment descriptors per atom.

    Columns: own electronegativity; total bond order (degree); 1-hop
    order-weighted neighbor electronegativity / mass / order^2-weighted
    electronegativity / electronegativity^2; 2-hop composites of degree,
    electronegativity and mass. Together these near-determine the WL-2
    neighborhood (a moment-style encoding of the neighbor multiset) while
    being CONTINUOUS under graph edits — the injectivity is measured, not
    assumed (tools/ceiling_analysis.py fidelity=4)."""
    t = np.asarray(atom_types[:n_atoms])
    o = np.asarray(edge_type[:n_atoms, :n_atoms], dtype=np.float64)
    chi = _ELEM_EN[t]
    m = _ELEM_MASS[t] / 10.0
    deg = o.sum(1)
    s_chi = o @ chi
    s_m = o @ m
    s_o2chi = (o ** 2) @ chi
    s_chi2 = o @ (chi ** 2)
    s2_deg = o @ deg
    s2_chi = o @ s_chi
    s2_m = o @ s_m
    return np.stack(
        [chi, deg, s_chi, s_m, s_o2chi, s_chi2, s2_deg, s2_chi, s2_m], axis=1
    )


def _f4_peak_fracs(atom_types, edge_type, n_atoms, channel, desc=None):
    """Continuous peak positions for one channel: (atom_fracs [n,2],
    bond_fracs [n_bonds], bond_amp_scale [n_bonds]).

    Shared by the generator and the identifiability-ceiling analysis so the
    two can never diverge."""
    if desc is None:
        desc = _continuous_descriptors(atom_types, edge_type, n_atoms)
    d = (desc - _F4_ATOM_MU) / _F4_ATOM_SD
    atom_fracs = np.empty((n_atoms, 2))
    for band in range(2):
        gain = 1.6 / _F4_ATOM_ZSD[channel, band]
        z = d @ _F4_W[channel, band] * gain
        lo, hi = _F4_BANDS[band]
        atom_fracs[:, band] = lo + (hi - lo) / (1.0 + np.exp(-z))

    t = np.asarray(atom_types[:n_atoms])
    o = np.asarray(edge_type[:n_atoms, :n_atoms], dtype=np.float64)
    chi = _ELEM_EN[t]
    m = _ELEM_MASS[t]
    deg = o.sum(1)
    s_chi = o @ chi
    iu, ju = np.nonzero(np.triu(o, 1))
    if len(iu) == 0:
        return atom_fracs, np.empty((0,)), np.empty((0,))
    mu = m[iu] * m[ju] / (m[iu] + m[ju])
    y = np.stack(
        [
            o[iu, ju],
            1.0 / np.sqrt(mu),  # harmonic-oscillator reduced-mass factor
            chi[iu] + chi[ju],
            deg[iu] + deg[ju],
            s_chi[iu] + s_chi[ju],  # environment shift (conjugation analogue)
        ],
        axis=1,
    )
    yn = (y - _F4_BOND_MU) / _F4_BOND_SD
    gain = 1.6 / _F4_BOND_ZSD[channel]
    zb = yn @ _F4_WB[channel] * gain
    lo, hi = _F4_BOND_BAND
    bond_fracs = lo + (hi - lo) / (1.0 + np.exp(-zb))
    # amplitude carries the bond order (an extra continuous coordinate)
    bond_amps = 4.0 + 2.0 * o[iu, ju]
    return atom_fracs, bond_fracs, bond_amps


def _structure_spectrum(
    rng, length, atom_types, edge_type, n_atoms, channel, fidelity=1,
    wl_envs=None, f4_desc=None,
):
    """Deterministic structure -> spectrum mapping (+ small noise).

    Each (atom_a, atom_b, bond_order) pattern contributes a Gaussian peak at
    a fixed pattern-specific frequency with amplitude proportional to its
    count, plus element-count baseline peaks — so the conditional model can
    actually recover structure from the spectrum (real QM9S spectra are DFT
    functions of the structure; random spectra would make conditioning
    uninformative).

    ``fidelity=2`` adds peaks keyed on per-atom WL-1/WL-2 local-environment
    labels. The bond-pattern-count fingerprint of fidelity=1 identifies only
    ~17% of molecules uniquely (Top-1 identifiability ceiling measured by
    tools/ceiling_analysis.py) — isomers with equal bond multisets share a
    spectrum. WL-2 environment multisets are near-injective over QM9-sized
    isomorphism classes, lifting the ceiling to ~1.0, which is the regime
    real DFT spectra live in (distinct isomers have distinct IR spectra).

    ``fidelity>=4`` replaces the hash-positioned environment peaks with
    CONTINUOUS-descriptor peaks (see the fidelity-4 block above): both
    near-injective AND generalizable — similar environments produce
    similar peak positions, like real DFT spectra and unlike hashes."""
    x = np.arange(length, dtype=np.float64)
    y = np.zeros(length)

    def peak(center_frac, width_frac, amp):
        c = center_frac * (length - 1)
        w = max(width_frac * length, 2.0)
        return amp * np.exp(-0.5 * ((x - c) / w) ** 2)

    if fidelity >= 4:
        # continuous-in-structure spectra: per-atom environment peaks (two
        # bands, independent projections) + per-bond reduced-mass peaks +
        # the element-count baseline. No hash-positioned peaks at all.
        atom_fracs, bond_fracs, bond_amps = _f4_peak_fracs(
            atom_types, edge_type, n_atoms, channel, desc=f4_desc
        )
        fracs = np.concatenate([atom_fracs.reshape(-1), bond_fracs])
        amps = np.concatenate(
            [np.full(2 * n_atoms, 6.0), bond_amps]
        )
        centers = fracs * (length - 1)
        w = max(_F4_WIDTH * length, 2.0)
        y += (
            amps[:, None]
            * np.exp(-0.5 * ((x[None, :] - centers[:, None]) / w) ** 2)
        ).sum(0)
        for elem in range(5):
            n_e = int(np.sum(atom_types[:n_atoms] == elem))
            if n_e:
                h = (elem * 17 + channel * 29) % 23
                y += peak(0.1 + 0.8 * h / 23.0, 0.03, 3.0 * n_e)
        y += np.abs(rng.normal(0, 0.1, size=length))
        return y.astype(np.float32)

    # bond-pattern peaks: fixed frequency per (min(a,b), max(a,b), order, ch)
    iu, ju = np.nonzero(np.triu(edge_type[:n_atoms, :n_atoms], 1))
    from collections import Counter

    counts = Counter()
    for i, j in zip(iu, ju):
        a, b = sorted((int(atom_types[i]), int(atom_types[j])))
        counts[(a, b, int(edge_type[i, j]))] += 1
    for (a, b, o), cnt in counts.items():
        h = (a * 131 + b * 31 + o * 7 + channel * 61) % 97
        y += peak(0.05 + 0.9 * h / 97.0, 0.01, 8.0 * cnt)
    # element-count baseline peaks
    for elem in range(5):
        n_e = int(np.sum(atom_types[:n_atoms] == elem))
        if n_e:
            h = (elem * 17 + channel * 29) % 23
            y += peak(0.1 + 0.8 * h / 23.0, 0.03, 3.0 * n_e)
    if fidelity >= 2:
        # local-environment peaks: one narrow Gaussian per distinct WL
        # label, amplitude ~ its atom count. Two levels at two different
        # hash moduli; P chosen prime and large enough that the ~25-atom
        # label sets rarely collide within one spectrum.
        from collections import Counter

        # wl_envs: channel-independent, so generate() computes them once
        # per molecule rather than once per spectral channel
        wl1, wl2 = wl_envs or _wl_environments(atom_types, edge_type, n_atoms)
        for level, labels, amp in ((1, wl1, 6.0), (2, wl2, 4.0)):
            P = 1009 if level == 1 else 2003
            for lab, cnt in Counter(labels).items():
                frac = ((lab + channel * 7919) % P) / P
                y += peak(0.03 + 0.94 * frac, 0.004, amp * cnt)
    # small stochastic background so spectra aren't exactly degenerate
    y += np.abs(rng.normal(0, 0.1, size=length))
    return y.astype(np.float32)


def generate(
    seed: int,
    size: int,
    max_n: int,
    info_name: str = "qm9_second_half",
    fidelity: int = 1,
    cache_dir: str = "",
) -> Dict[str, np.ndarray]:
    """Generate a raw synthetic dataset with the QM9S schema:
    atom_type [M, N], pos [M, N, 3], edge_type [M, N, N] (bond orders),
    num_atom [M], fc [M, N], uv/ir/raman [M, L].

    ``cache_dir``: keep the arrays in
    ``synth_<seed>_<size>_<max_n>_<info>_f<fidelity>.npz`` there (the JAX
    package's file name and layout) and read them back on the next call."""
    cache_path = None
    if cache_dir:
        cache_path = os.path.join(
            cache_dir, f"synth_{seed}_{size}_{max_n}_{info_name}_f{fidelity}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                return {k: z[k] for k in z.files}
    rng = np.random.default_rng(seed)
    info = get_dataset_info(info_name)
    n_atoms = np.minimum(_sample_n_atoms(rng, info, size), max_n)

    atom_type = np.zeros((size, max_n), dtype=np.int64)
    pos = np.zeros((size, max_n, 3), dtype=np.float32)
    edge_type = np.zeros((size, max_n, max_n), dtype=np.int64)
    fc = np.zeros((size, max_n), dtype=np.int64)
    # fidelity 3/5: majority ring-bearing structures (real QM9 is majority
    # ring-bearing; the acyclic tree generator left the entire ring/
    # kekulization/scaffold chemistry untrained — VERDICT r2 weak-3).
    # fidelity 4 keeps the fidelity-2 TREE structure distribution so the
    # continuous-spectra intervention changes ONLY the spectrum keying.
    ring_prob = 0.75 if fidelity in (3, 5) else 0.0
    for m in range(size):
        gen_one = (
            _random_ring_molecule
            if (ring_prob and rng.random() < ring_prob and n_atoms[m] >= 8)
            else _random_tree_molecule
        )
        t, p, e, n_total = gen_one(rng, int(n_atoms[m]), max_n)
        atom_type[m, : len(t)] = t
        pos[m, : len(p)] = p
        edge_type[m] = e
        n_atoms[m] = n_total
        # formal charges stay zero: the generator builds neutral
        # valence-saturated molecules (charged species would need different
        # bond counts per allowed_fc_bonds)

    # channel-independent per-molecule caches, computed once per molecule
    # rather than once per spectral channel
    wl_cache = (
        [
            _wl_environments(atom_type[m], edge_type[m], int(n_atoms[m]))
            for m in range(size)
        ]
        if fidelity in (2, 3)
        else [None] * size
    )
    f4_cache = (
        [
            _continuous_descriptors(atom_type[m], edge_type[m], int(n_atoms[m]))
            for m in range(size)
        ]
        if fidelity >= 4
        else [None] * size
    )
    spectra = {
        k: np.stack(
            [
                _structure_spectrum(
                    rng, L, atom_type[m], edge_type[m], int(n_atoms[m]), ch,
                    fidelity=fidelity, wl_envs=wl_cache[m],
                    f4_desc=f4_cache[m],
                )
                for m in range(size)
            ]
        )
        for ch, (k, L) in enumerate(SPEC_LENS.items())
    }
    out = dict(
        atom_type=atom_type,
        pos=pos,
        edge_type=edge_type,
        fc=fc,
        num_atom=n_atoms.astype(np.int64),
        **spectra,
    )
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        # a file of each writer's own, renamed into place whole
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"
        np.savez(tmp, **out)
        os.replace(tmp, cache_path)
    return out
