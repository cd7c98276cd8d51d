"""Continuity of the fidelity-4 spectra (the port's counterpart of
``tools/f4_continuity.py``, with a flag in place of its argument).

The information-ceiling claim rested on fidelity-2 peaks being hash
functions of local environments: a one-atom edit anywhere in an atom's WL-2
neighbourhood moves its peaks to unrelated positions, so unseen
environments carry no generalizable signal. Fidelity 4 keys peaks on
continuous descriptors instead. For random single-atom element
substitutions this tool measures the IR peak-position shift of every other
atom against its graph distance from the edit, under both keyings.

Expected: fidelity-2 shifts spread over the whole spectrum (hash jumps) at
distance <= 2 and are zero beyond; fidelity-4 shifts are small (a few peak
widths), fall with distance and are zero beyond 2 hops, the Lipschitz
property real DFT spectra have and a model needs to generalize to unseen
environments:

    python -m diffspectra_tpu_torch.tools.f4_continuity --n-molecules 300

Host-only (numpy): it runs no model and uses no device.
"""

from __future__ import annotations

import argparse
import collections
from collections import defaultdict

import numpy as np

from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.data.synthetic import (
    _f4_peak_fracs,
    _random_tree_molecule,
    _sample_n_atoms,
    _wl_environments,
)

IR_LEN = 3501
PEAK_W_BINS = 0.004 * IR_LEN  # fidelity-4 peak width in IR bins


def _graph_distances(edge, n):
    """All-pairs hop distances by BFS (99 where unreachable)."""
    adj = [np.nonzero(edge[i, :n])[0] for i in range(n)]
    dist = np.full((n, n), 99, dtype=np.int64)
    for s in range(n):
        dist[s, s] = 0
        dq = collections.deque([s])
        while dq:
            u = dq.popleft()
            for v in adj[u]:
                if dist[s, v] > dist[s, u] + 1:
                    dist[s, v] = dist[s, u] + 1
                    dq.append(v)
    return dist


def _wl_peak_bins(types, edge, n, atom):
    """The fidelity-2 IR peak positions (WL-1, WL-2) of one atom, in bins."""
    wl1, wl2 = _wl_environments(types, edge, n)
    out = []
    for level, labels in ((1, wl1), (2, wl2)):
        P = 1009 if level == 1 else 2003
        frac = 0.03 + 0.94 * (((labels[atom] + 1 * 7919) % P) / P)
        out.append(frac * (IR_LEN - 1))
    return np.asarray(out)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-molecules", type=int, default=300, help="molecules edited")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    n_mols = parse_args(argv).n_molecules
    rng = np.random.default_rng(5)
    info = get_dataset_info("qm9_second_half")
    n_atoms = np.minimum(_sample_n_atoms(rng, info, n_mols), 29)

    shifts_f4 = defaultdict(list)  # hop distance -> peak shifts (bins)
    shifts_f2 = defaultdict(list)
    for m in range(n_mols):
        t, p, e, n = _random_tree_molecule(rng, int(n_atoms[m]), 29)
        heavy = [i for i in range(n) if t[i] != 0]
        # substitute one heavy atom with an element whose valence holds the
        # atom's bonds
        used = e[:n, :n].sum(1)
        cands = [(i, new) for i in heavy for new in (1, 2, 3, 4)
                 if new != t[i] and used[i] <= [1, 4, 3, 2, 1][new]]
        if not cands:
            continue
        i, new = cands[int(rng.integers(len(cands)))]
        t2 = t.copy()
        t2[i] = new

        dist = _graph_distances(e, n)
        a1, _, _ = _f4_peak_fracs(t, e, n, channel=1)
        a2, _, _ = _f4_peak_fracs(t2, e, n, channel=1)
        for j in range(n):
            d = int(dist[i, j])
            if d > 4:
                continue
            shifts_f4[d].append(np.abs(a1[j] - a2[j]).max() * (IR_LEN - 1))
            shifts_f2[d].append(np.abs(_wl_peak_bins(t, e, n, j)
                                       - _wl_peak_bins(t2, e, n, j)).max())

    print(f"IR peak width ~{PEAK_W_BINS:.0f} bins; shifts in bins "
          f"(median / p90) by hop distance from a single-atom edit:")
    print(f"{'hops':>4} {'f4 med':>8} {'f4 p90':>8} {'f2 med':>8} {'f2 p90':>8} {'n':>6}")
    for d in sorted(shifts_f4):
        s4, s2 = np.asarray(shifts_f4[d]), np.asarray(shifts_f2[d])
        print(f"{d:>4} {np.median(s4):>8.1f} {np.percentile(s4, 90):>8.1f} "
              f"{np.median(s2):>8.1f} {np.percentile(s2, 90):>8.1f} {len(s4):>6}")
    return {"f4": dict(shifts_f4), "f2": dict(shifts_f2)}


if __name__ == "__main__":
    main()
