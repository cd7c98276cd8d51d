"""Identifiability ceiling of the synthetic spectra (the port's counterpart
of ``tools/ceiling_analysis.py``, with flags in place of its variables).

The synthetic spectrum (``data/synthetic.py::_structure_spectrum``) is a
deterministic function of only (a) the multiset of (atom_a, atom_b, order)
bond patterns and (b) the per-element atom counts, so all molecules sharing
that fingerprint produce the same spectrum (up to a small non-informative
noise floor). A conditional model can do no better at exact structure
recovery than answering the most likely member of the target's fingerprint
class:

    Top-1 ceiling  = E_target[ p(modal isomer | class(target)) ]
    Top-K ceiling  = E_target[ sum of top-K isomer probs | class ]

This tool Monte-Carlo estimates those ceilings from the generator itself
(structure only, spectra skipped), at increasing sample sizes so that the
upward bias of singleton classes shows, and reports the class sizes:

    python -m diffspectra_tpu_torch.tools.ceiling_analysis 32768 131072
    python -m diffspectra_tpu_torch.tools.ceiling_analysis --fidelity 4 --f4-bin 8 4096

Host-only (numpy): it runs no model and uses no device.
"""

from __future__ import annotations

import argparse
from collections import Counter, defaultdict

import numpy as np

from diffspectra_tpu_torch.data.info import get_dataset_info
from diffspectra_tpu_torch.data.synthetic import (
    _f4_peak_fracs,
    _random_tree_molecule,
    _sample_n_atoms,
    _wl_environments,
)
from diffspectra_tpu_torch.evaluation.molgraph import MolGraph

MAX_N = 29
SYMBOLS = ["H", "C", "N", "O", "F"]
IR_LEN = 3501


def _wl_hash(types, edge, n_total) -> str:
    """The isomorphism-class key: the WL hash of the heavy-and-hydrogen
    graph, charges zero."""
    return MolGraph([SYMBOLS[int(t)] for t in types[:n_total]],
                    np.zeros(n_total, dtype=np.int64),
                    np.asarray(edge[:n_total, :n_total])).wl_hash()


def fingerprint_and_hash(types, pos, edge, n_total, fidelity=1, f4_bin=1):
    """``(spectrum-equivalence class key, isomorphism-class key)``.

    ``fidelity >= 4``: the key is what the IR channel alone resolves (the
    campaigns condition on IR): per-band multisets of quantized continuous
    peak positions (not per-atom (band0, band1) pairs: the spectrum is a sum
    and the pairing is unobservable), the bond-peak (position, amplitude)
    multiset and the element counts. ``f4_bin`` is the quantization in IR
    bins: 1 optimistic (any sub-bin shift resolvable), 8 about half a peak
    width, conservative. ``pos`` is unused: the class depends on the graph."""
    elem = tuple(int((types[:n_total] == e).sum()) for e in range(5))
    if fidelity >= 4:
        atom_fracs, bond_fracs, bond_amps = _f4_peak_fracs(types, edge, n_total, channel=1)

        def q(fracs):
            return tuple(sorted(int(round(f * (IR_LEN - 1))) // f4_bin for f in fracs))

        class_key = (
            q(atom_fracs[:, 0]),
            q(atom_fracs[:, 1]),
            tuple(sorted(zip((int(round(f * (IR_LEN - 1))) // f4_bin for f in bond_fracs),
                             (float(a) for a in bond_amps)))),
            elem,
        )
        return class_key, _wl_hash(types, edge, n_total)
    pats = Counter()
    iu, ju = np.nonzero(np.triu(edge[:n_total, :n_total], 1))
    for i, j in zip(iu, ju):
        a, b = sorted((int(types[i]), int(types[j])))
        pats[(a, b, int(edge[i, j]))] += 1
    class_key = (tuple(sorted(pats.items())), elem)
    if fidelity >= 2:
        wl1, wl2 = _wl_environments(types, edge, n_total)
        class_key = class_key + (tuple(sorted(Counter(wl1).items())),
                                 tuple(sorted(Counter(wl2).items())))
    return class_key, _wl_hash(types, edge, n_total)


def estimate(n_samples, seed=123, fidelity=1, f4_bin=1) -> dict:
    """The ceilings over ``n_samples`` tree molecules drawn from ``seed``:
    ``n``, ``n_classes``, ``top1_ceiling``, ``top10_ceiling``,
    ``singleton_class_frac``, ``mean_class_size``, ``singleton_struct_frac``."""
    rng = np.random.default_rng(seed)
    info = get_dataset_info("qm9_second_half")
    n_atoms = np.minimum(_sample_n_atoms(rng, info, n_samples), MAX_N)
    classes = defaultdict(Counter)  # class_key -> Counter(wl_hash)
    for m in range(n_samples):
        t, p, e, n_total = _random_tree_molecule(rng, int(n_atoms[m]), MAX_N)
        ck, h = fingerprint_and_hash(t, p, e, n_total, fidelity=fidelity, f4_bin=f4_bin)
        classes[ck][h] += 1

    top1 = top10 = 0.0
    sizes = []
    singleton_structs = 0
    for ctr in classes.values():
        freqs = sorted(ctr.values(), reverse=True)
        sizes.append(sum(freqs))
        # every member of the class is a potential target; the optimal
        # decoder answers the modal isomer: correct with p = f_modal / size,
        # weighted by the class's target probability size / total
        top1 += freqs[0] / n_samples
        top10 += sum(freqs[:10]) / n_samples
        singleton_structs += sum(1 for f in freqs if f == 1)
    sizes = np.asarray(sizes)
    return dict(n=n_samples, n_classes=len(classes), top1_ceiling=top1, top10_ceiling=top10,
                singleton_class_frac=float((sizes == 1).mean()),
                mean_class_size=float(sizes.mean()),
                singleton_struct_frac=singleton_structs / n_samples)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_samples", type=int, nargs="*", default=[32768, 131072, 524288],
                   help="sample sizes")
    p.add_argument("--fidelity", type=int, default=1, help="spectrum fidelity")
    p.add_argument("--f4-bin", type=int, default=1,
                   help="fidelity 4: quantization of the peak positions in IR bins")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    print(f"fidelity={args.fidelity} f4_bin={args.f4_bin}")
    print(f"{'N':>8} {'classes':>8} {'Top-1 ceil':>10} {'Top-10 ceil':>11} "
          f"{'1-mol classes':>13} {'mean size':>9}")
    rows = []
    for n in args.n_samples:
        r = estimate(n, fidelity=args.fidelity, f4_bin=args.f4_bin)
        rows.append(r)
        print(f"{r['n']:>8} {r['n_classes']:>8} {r['top1_ceiling']:>10.4f} "
              f"{r['top10_ceiling']:>11.4f} {r['singleton_class_frac']:>13.3f} "
              f"{r['mean_class_size']:>9.2f}")
    return rows


if __name__ == "__main__":
    main()
