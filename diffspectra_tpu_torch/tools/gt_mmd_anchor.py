"""The geometry MMDs of ground truth against ground truth (the port's
counterpart of ``tools/gt_mmd_anchor.py``, with flags in place of its
variables).

The eval's ``Metric-Align`` line gives bond, angle and dihedral MMDs with
no scale: nothing says what a perfect model would score. This computes
that floor, with the eval's own machinery (``cal_geometry``'s
top-symbol distributions and the multi-kernel Gaussian MMD, its sums on the
device): ``--n-gen`` ground-truth molecules of the test split of
``generate(seed=42, size, fidelity)`` stand for a perfect model's draws and
are scored against (a) the statistics of the whole test split, as the eval
scores, and (b) those of as many molecules drawn for the train anchor. A
model's MMD is bad only as far as it exceeds this floor at the same sample
size:

    python -m diffspectra_tpu_torch.tools.gt_mmd_anchor --size 32768 --n-gen 1000

Prints the figures as one JSON line, then ``GT_MMD_ANCHOR OK``. Runs on
``cuda`` unless ``--device cpu`` is given. ``--cache-dir`` keeps the
generated set (none by default).
"""

from __future__ import annotations

import argparse
import json
import logging
import random

import numpy as np

MEANS = ("bond_length_mean", "bond_angle_mean", "dihedral_angle_mean")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=32768, help="synthetic set size")
    p.add_argument("--fidelity", type=int, default=3, help="spectrum fidelity")
    p.add_argument("--n-gen", type=int, default=1000, help="ground-truth draws scored")
    p.add_argument("--cache-dir", default="", help="a directory to keep the generated set in")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    from diffspectra_tpu_torch.data.info import get_dataset_info
    from diffspectra_tpu_torch.data.pipeline import _conditional_splits
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.device import resolve_device
    from diffspectra_tpu_torch.evaluation.cal_geometry import (
        cal_bond_angle,
        cal_bond_distance,
        cal_dihedral_angle,
        compute_geo_mmd,
    )
    from diffspectra_tpu_torch.evaluation.molgraph import from_decoded

    device = resolve_device(args.device)
    size, fidelity, n_gen = args.size, args.fidelity, args.n_gen
    raw = generate(seed=42, size=size, max_n=29, fidelity=fidelity, cache_dir=args.cache_dir)
    first, second, _val, test = _conditional_splits(np.random.default_rng(42), size)
    train = np.concatenate([first, second])
    info = get_dataset_info("qm9_second_half")

    def graphs(idx):
        out = []
        for m in idx:
            n = int(raw["num_atom"][m])
            out.append(from_decoded((raw["pos"][m, :n], raw["atom_type"][m, :n],
                                     raw["edge_type"][m, :n, :n], raw["fc"][m, :n]),
                                    info["atom_decoder"]))
        return out

    test_graphs = graphs(test)
    gen_idx = np.random.default_rng(5).permutation(len(test))[:n_gen]
    gt_draw = [test_graphs[i] for i in gen_idx]
    # the train anchor's statistics at the test split's size: an MMD between
    # finite samples depends on their size. As in the JAX tool, the draw's
    # positions in the train split are taken as molecule indices, so the
    # draw is of the whole set, not of the train split alone.
    tr_idx = np.random.default_rng(6).permutation(len(train))[:len(test)]
    train_graphs = graphs(tr_idx)
    kinds = ((cal_bond_distance, "top_bond_sym", MEANS[0]),
             (cal_bond_angle, "top_angle_sym", MEANS[1]),
             (cal_dihedral_angle, "top_dihedral_sym", MEANS[2]))

    def anchor(target_graphs, label):
        tar = {}
        for cal_fn, syms, _ in kinds:
            tar.update(cal_fn(target_graphs, info[syms]))
        rng = random.Random(42)  # draws only where a side exceeds the 10,000 cap
        res = {}
        for cal_fn, syms, mean_name in kinds:
            res.update(compute_geo_mmd(gt_draw, tar, cal_fn, info[syms], mean_name, device, rng))
        means = {k: float(res[k]) for k in MEANS}
        logging.info("%s anchor: %s", label, means)
        return means

    out = {"size": size, "fidelity": fidelity, "n_gen": n_gen,
           # the same-pool floor: the eval's own target statistics (the test split)
           "gt_vs_test_stats": anchor(test_graphs, "test-pool"),
           # the other draw's floor
           "gt_vs_train_stats": anchor(train_graphs, "train-pool")}
    print(json.dumps(out))
    print("GT_MMD_ANCHOR OK")
    return out


if __name__ == "__main__":
    main()
