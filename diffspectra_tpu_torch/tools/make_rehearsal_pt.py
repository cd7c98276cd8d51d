"""Write an at-scale stand-in for QM9S's processed file (the port's
counterpart of ``tools/make_rehearsal_pt.py``, with flags in place of its
arguments).

``--size`` ring-bearing fidelity-3 molecules of ``generate(seed=11)`` with
full-size spectra, in the PyG-collate layout of the reference's processed
file, and the conditional split dict in the reference's format, so that
``diffspectra_tpu_torch/scripts/real_data.sh`` runs its pack, train and
eval end to end with no manual step while QM9S itself is absent:

    python -m diffspectra_tpu_torch.tools.make_rehearsal_pt --size 2048
    DATA_ROOT=data/QM9S_rehearsal EVAL_CKPT=1 \\
        TRAIN_FLAGS="--config training.n_iters=8 --config training.snapshot_freq=8" \\
        bash diffspectra_tpu_torch/scripts/real_data.sh

The split takes ``max(64, size // 8)`` test and ``max(64, size // 16)``
validation molecules of a ``default_rng(17)`` permutation and halves the
rest into the two train splits, so below 130 molecules the train splits are
empty. Host-only (numpy and ``torch.save``): it uses no device.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffspectra_tpu_torch.data.qm9s import PROCESSED, SPLIT_FILE, write_processed_from_raw
from diffspectra_tpu_torch.data.synthetic import generate


def rehearsal_splits(size: int):
    """``(first_train, second_train, valid, test)`` of the rehearsal file."""
    perm = np.random.default_rng(17).permutation(size)
    n_test = max(64, size // 8)
    n_val = max(64, size // 16)
    n_train = size - n_test - n_val
    return (perm[:n_train // 2], perm[n_train // 2:n_train], perm[n_train:n_train + n_val],
            perm[n_train + n_val:])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=2048, help="molecules")
    p.add_argument("--root", default="data/QM9S_rehearsal", help="the dataset's root")
    return p.parse_args(argv)


def main(argv=None) -> tuple:
    args = parse_args(argv)
    raw = generate(seed=11, size=args.size, max_n=29, fidelity=3)
    splits = rehearsal_splits(args.size)
    write_processed_from_raw(args.root, raw, splits)
    first, second, val, test = map(len, splits)
    print(f"wrote {args.size} fidelity-3 molecules to {args.root}/{PROCESSED} + {SPLIT_FILE} "
          f"({first + second}/{val}/{test})")
    return splits


if __name__ == "__main__":
    main()
