"""Re-score saved molecule pickles offline, the port of
``diffspectra_tpu/evaluation/base_metrics.py``: load the 2D, 3D and
ground-truth molecules that the sweep writes with ``eval.save_mols="true"``
(``<eval_dir>/molecules_ckpt_<ckpt>/{complete_rdmols_2d,sample_rdmols_3d,
groundtruth_rdmols}.pkl``, ``MolGraph`` lists), keep the valid pairs, and
write the similarity tables again without sampling
(``<base_path>/metrics_results/similarity_metrics_{2d,3d}.csv`` and their
detailed scores, through ``compute_metrics.evaluate_jsonl_predictions``).

    python -m diffspectra_tpu_torch.evaluation.base_metrics --base_path exp/run/eval --ckpt 40

The pickles are unpickled: read only files this program wrote.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

from .compute_metrics import evaluate_jsonl_predictions

FILES = {"2d": "complete_rdmols_2d.pkl", "3d": "sample_rdmols_3d.pkl",
         "ground_truth": "groundtruth_rdmols.pkl"}


def validate_and_prepare_mols(pred_mols, true_mols):
    """``(true, [[pred]], skipped)`` over the pairs where both are present
    and the prediction is non-empty with its valences holding."""
    out_true, out_pred, skipped = [], [], 0
    for p, t in zip(pred_mols, true_mols):
        if p is None or t is None or p.n_atoms == 0 or not p.valence_ok():
            skipped += 1
            continue
        out_true.append(t)
        out_pred.append([p])
    return out_true, out_pred, skipped


def compute_metrics_for_saved_mols(base_path: str, output_path: str) -> dict:
    """Score the pickles under ``base_path`` into ``output_path``; returns
    ``{"2d": table, "3d": table}`` (a table None where no pair is valid), or
    ``{}`` where a file is missing."""
    mols = {}
    for name, file in FILES.items():
        path = os.path.join(base_path, file)
        if not os.path.exists(path):
            logging.error("File not found: %s", path)
            return {}
        with open(path, "rb") as f:
            mols[name] = pickle.load(f)
        logging.info("Loaded %d molecules from %s", len(mols[name]), name)

    os.makedirs(output_path, exist_ok=True)
    tables = {}
    for version in ("2d", "3d"):
        true_v, pred_v, skipped = validate_and_prepare_mols(mols[version], mols["ground_truth"])
        logging.info("%s molecule pair statistics - Input: %d, Valid: %d, Skipped: %d",
                     version.upper(), len(mols[version]), len(true_v), skipped)
        tables[version] = None
        if true_v:
            tables[version] = evaluate_jsonl_predictions(
                (true_v, pred_v), os.path.join(output_path, f"similarity_metrics_{version}.csv"))
            for metric, value in tables[version].items():
                logging.info("%s %s: %s", version.upper(), metric, value)
    return tables


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Compute metrics for saved molecules")
    parser.add_argument("--base_path", type=str, required=True,
                        help="the sweep's eval directory")
    parser.add_argument("--ckpt", type=str, default="40",
                        help="the checkpoint name of molecules_ckpt_<ckpt>")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return compute_metrics_for_saved_mols(
        os.path.join(args.base_path, f"molecules_ckpt_{args.ckpt}"),
        os.path.join(args.base_path, "metrics_results"),
    )


if __name__ == "__main__":
    main()
