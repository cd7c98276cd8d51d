"""Structure-recovery metrics between predicted and true molecules: the
graph mode of ``diffspectra_tpu/evaluation/compute_metrics.py``, the mode
that runs without RDKit (as on the card).

Exact match by Weisfeiler-Lehman hash (the stand-in for InChIKey), WL
fingerprints for Tanimoto and cosine, graph-pattern functional groups, the
exact MCES distance of ``mces.py``; MACCS and Fraggle are RDKit-only and read
NaN. ``evaluate_jsonl_predictions`` writes the same three files with the
same rows as the JAX package, through ``csv`` and ``json``.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
from typing import Dict, List, Optional

import numpy as np

from . import fingerprints as FP
from . import mces as _mces_mod
from .molgraph import MolGraph, canonical_id, consensus_rank  # noqa: F401

METRIC_NAMES = [
    "Top-1 Accuracy",
    "MCES",
    "Tanimoto Similarity (Morgan)",
    "Cosine Similarity (Morgan)",
    "Tanimoto Similarity (MACCS)",
    "Fraggle Similarity",
    "Functional Group Similarity",
]
# the per-pair score behind each metric, in METRIC_NAMES' order
_SCORE_KEYS = ("inchikey_match", "mces", "tanimoto", "cosine", "tanimoto_maccs", "fraggle",
               "fg")


def _graph_functional_groups(mol: MolGraph) -> set:
    """Pattern detection of the common functional groups on the H, C, N,
    O, F vocabulary."""
    groups = set()
    syms = mol.atom_syms
    bo = mol.bond_orders
    n = mol.n_atoms
    deg_h = [sum(1 for j in np.nonzero(bo[i])[0] if syms[j] == "H") for i in range(n)]
    for i in range(n):
        si = syms[i]
        nbrs = np.nonzero(bo[i])[0]
        if si == "C":
            if all(bo[i, j] == 1 for j in nbrs):
                groups.add("alkane")
            for j in nbrs:
                if syms[j] == "C" and bo[i, j] == 2:
                    groups.add("alkene")
                if syms[j] == "C" and bo[i, j] == 3:
                    groups.add("alkyne")
                if syms[j] == "C" and bo[i, j] == 4:
                    groups.add("arene")
                if syms[j] == "F" and bo[i, j] == 1:
                    groups.add("haloalkane")
                if syms[j] == "O" and bo[i, j] == 2:
                    heavy = [k for k in nbrs if syms[k] != "H" and k != j]
                    if deg_h[i] >= 1 and any(syms[k] == "C" for k in heavy):
                        groups.add("aldehyde")
                    c_nbrs = [k for k in heavy if syms[k] == "C"]
                    o_single = [k for k in heavy if syms[k] == "O" and bo[i, k] == 1]
                    if len(c_nbrs) >= 2:
                        groups.add("ketone")
                    for k in o_single:
                        if deg_h[k] >= 1:
                            groups.add("carboxylic acid")
                        elif any(syms[l] == "C" for l in np.nonzero(bo[k])[0] if l != i):
                            groups.add("ester")
                if syms[j] == "N" and bo[i, j] == 3:
                    groups.add("nitrile")
        elif si == "O":
            c_nbrs = [j for j in nbrs if syms[j] == "C" and bo[i, j] == 1]
            if deg_h[i] >= 1 and c_nbrs:
                groups.add("alcohol")
            if len(c_nbrs) >= 2:
                groups.add("ether")
        elif si == "N":
            has_acyl = any(
                syms[j] == "C"
                and any(syms[k] == "O" and bo[j, k] == 2 for k in np.nonzero(bo[j])[0])
                for j in nbrs
            )
            if has_acyl:
                groups.add("amide")
            elif nbrs.size:
                groups.add("amine")
    return groups


def _mces_exact(m1: MolGraph, m2: MolGraph) -> float:
    """Exact MCES distance (``mces.py``)."""
    return _mces_mod.mces_distance(m1, m2)


def _pair_scores_graph(true_mol: MolGraph, pred_mol: MolGraph) -> dict:
    fp_t = FP.wl_fingerprint(true_mol)
    fp_p = FP.wl_fingerprint(pred_mol)
    fg1 = _graph_functional_groups(true_mol)
    fg2 = _graph_functional_groups(pred_mol)
    all_g = fg1 | fg2
    return {
        "inchikey_match": true_mol.wl_hash() == pred_mol.wl_hash(),
        "mces": _mces_exact(true_mol, pred_mol),
        "tanimoto": FP.tanimoto(fp_t, fp_p),
        "tanimoto_maccs": float("nan"),  # RDKit-only
        "cosine": FP.cosine(fp_t, fp_p),
        "fraggle": float("nan"),  # RDKit-only
        "fg": len(fg1 & fg2) / len(all_g) if all_g else 1.0,
    }


def _exact_match(true_mol: Optional[MolGraph], pred_mol: Optional[MolGraph]) -> bool:
    """Graph identity: equal WL hashes; False when either is missing."""
    if true_mol is None or pred_mol is None:
        return False
    return true_mol.wl_hash() == pred_mol.wl_hash()


def top_k_exact_match(true_mols, pred_lists) -> float:
    """Top-K structure recovery: the share of present targets that ANY of
    their K candidates matches exactly."""
    hits, n = 0, 0
    for t, preds in zip(true_mols, pred_lists):
        if t is None:
            continue
        n += 1
        if any(_exact_match(t, p) for p in preds):
            hits += 1
    return hits / max(n, 1)


def _nanmean(xs) -> float:
    """Mean over the non-NaN entries; NaN when there are none (the
    RDKit-only columns)."""
    arr = np.asarray(xs, dtype=np.float64)
    return arr[~np.isnan(arr)].mean() if (~np.isnan(arr)).any() else float("nan")


def _csv_cell(x) -> str:
    """A detailed-score cell as pandas writes it: NaN empty, floats by
    ``repr``, booleans ``True``/``False``."""
    if isinstance(x, float):
        return "" if math.isnan(x) else repr(x)
    return str(x)


def evaluate_jsonl_predictions(input_data, output_csv: str) -> Optional[Dict[str, str]]:
    """Score ``(true_mols, pred_mols)`` pairs, where a ``pred_mols`` entry is
    a molecule or a list of candidates (only the first is scored). Writes
    ``output_csv`` (the seven means, four decimals), its
    ``_detailed_scores.csv`` and ``_detailed_scores.json`` (one score a
    pair), and returns ``{metric name: value}`` as written. The JAX
    package's JSONL mode takes SMILES and needs RDKit; it is not ported."""
    true_mols, pred_mols = input_data
    if not true_mols:
        logging.error("No valid mol objects available for evaluation!")
        return None

    rows: Dict[str, List] = {k: [] for k in _SCORE_KEYS}
    mces_exhausted_before = _mces_mod.EXHAUSTED_PAIRS
    for true_mol, pred_entry in zip(true_mols, pred_mols):
        pred_mol = pred_entry[0] if isinstance(pred_entry, list) else pred_entry
        for k, v in _pair_scores_graph(true_mol, pred_mol).items():
            rows[k].append(v)

    exhausted = _mces_mod.EXHAUSTED_PAIRS - mces_exhausted_before
    if exhausted:
        logging.warning(
            "MCES: %d/%d pairs hit the B&B budget — their distances are "
            "incumbent upper bounds, the reported mean is an upper bound",
            exhausted, len(true_mols),
        )

    n = len(true_mols)
    matches = [b for b in rows["inchikey_match"] if b is not None]
    values = [f"{sum(matches) / n:.4f}"] + [f"{_nanmean(rows[k]):.4f}" for k in _SCORE_KEYS[1:]]
    # utf-8-sig and "\n" line ends, as pandas' to_csv writes them
    with open(output_csv, "w", encoding="utf-8-sig", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["Evaluation Metric", "Value"])
        writer.writerows(zip(METRIC_NAMES, values))

    detailed = {name: rows[k] for name, k in zip(METRIC_NAMES, _SCORE_KEYS)}
    with open(output_csv.replace(".csv", "_detailed_scores.csv"), "w", encoding="utf-8-sig",
              newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(METRIC_NAMES)
        writer.writerows([_csv_cell(x) for x in row] for row in zip(*detailed.values()))
    with open(output_csv.replace(".csv", "_detailed_scores.json"), "w") as f:
        json.dump(detailed, f, indent=2)
    return dict(zip(METRIC_NAMES, values))


def compute_similarity_metrics(pred_mols, true_mols, eval_dir, ckpt,
                               version_name) -> Optional[Dict[str, str]]:
    """Score the valid pairs (both present, the prediction non-empty with
    its valences holding), write
    ``similarity_metrics_<version>_ckpt_<ckpt>.csv`` and its detailed files,
    log each metric, and return them (None without a valid pair). Unlike
    the JAX package, an error raises instead of being logged."""
    valid_true, valid_pred = [], []
    skipped = 0
    for t, p in zip(true_mols, pred_mols):
        if t is None or p is None:
            skipped += 1
            continue
        if p.n_atoms == 0 or not p.valence_ok():
            skipped += 1
            continue
        valid_true.append(t)
        valid_pred.append([p])
    logging.info(
        "%s molecule pair statistics - Input: %d, Valid: %d, Skipped: %d",
        version_name, min(len(pred_mols), len(true_mols)), len(valid_true), skipped,
    )
    if not valid_true:
        logging.warning("No valid %s molecule pairs found for similarity computation",
                        version_name)
        return None
    csv_path = os.path.join(eval_dir, f"similarity_metrics_{version_name.lower()}_ckpt_{ckpt}.csv")
    table = evaluate_jsonl_predictions((valid_true, valid_pred), csv_path)
    for name, value in table.items():
        logging.info("%s %s: %s", version_name, name, value)
    return table
