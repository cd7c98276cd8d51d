"""Exact identifiability ceiling of the quality runs' protocol (the port's
counterpart of ``tools/protocol_ceiling.py``, with flags in place of its
arguments).

``ceiling_analysis`` estimates the generator's asymptotic ceiling; this
tool computes the ceiling of the finite-dataset protocol the quality runs
use: the model trains on the train split of the synthetic set and is
evaluated on test-split targets, conditioned on the target's spectrum and
true atom count. Since the fidelity-1 spectrum is a function of only the
bond-pattern and element counts, the best any model can do is learn the
train split's empirical map from class to structures and answer its mode:

  Top-1 ceiling  = P_test[ target == modal train structure of its class ]
  Top-K ceiling  = P_test[ target among top-K train structures of class ]

Targets whose class never occurs in train count as misses (the model has
nothing beyond the generator's prior for an unseen spectrum):

    python -m diffspectra_tpu_torch.tools.protocol_ceiling --size 32768 --fidelity 1

Host-only (numpy): it runs no model and uses no device. ``--cache-dir``
keeps the generated set (none by default).
"""

from __future__ import annotations

import argparse
from collections import Counter, defaultdict

import numpy as np

from diffspectra_tpu_torch.data.pipeline import _conditional_splits
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.tools.ceiling_analysis import fingerprint_and_hash

SEED = 42  # config.seed of the quality runs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=32768, help="synthetic set size")
    p.add_argument("--fidelity", type=int, default=1, help="spectrum fidelity")
    p.add_argument("--cache-dir", default="", help="a directory to keep the generated set in")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    size, fidelity = args.size, args.fidelity
    raw = generate(SEED, size, 29, fidelity=fidelity, cache_dir=args.cache_dir)
    first, second, _val, test = _conditional_splits(np.random.default_rng(SEED), size)
    train = np.concatenate([first, second])

    keys, hashes = [], []
    for m in range(size):
        ck, h = fingerprint_and_hash(raw["atom_type"][m], raw["pos"][m], raw["edge_type"][m],
                                     int(raw["num_atom"][m]), fidelity=fidelity)
        keys.append(ck)
        hashes.append(h)

    train_classes = defaultdict(Counter)
    for m in train:
        train_classes[keys[m]][hashes[m]] += 1

    hits1 = hits10 = seen = 0
    for m in test:
        ctr = train_classes.get(keys[m])
        if ctr is None:
            continue
        seen += 1
        ranked = [h for h, _ in ctr.most_common()]
        hits1 += hashes[m] == ranked[0]
        hits10 += hashes[m] in ranked[:10]

    n_test = len(test)
    out = {"size": size, "fidelity": fidelity, "test": n_test, "seen": seen / n_test,
           "top1_ceiling": hits1 / n_test, "top10_ceiling": hits10 / n_test}
    print(f"size={size} fidelity={fidelity} test={n_test} "
          f"class-seen-in-train={out['seen']:.3f}\n"
          f"Top-1 ceiling={out['top1_ceiling']:.4f} Top-10 ceiling={out['top10_ceiling']:.4f}")
    return out


if __name__ == "__main__":
    main()
