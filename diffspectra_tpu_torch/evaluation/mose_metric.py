"""MOSES-style distribution metrics over ``MolGraph``s, the graph mode of
``diffspectra_tpu/evaluation/mose_metric.py`` (the JAX package's path
without RDKit): the generated set, deduplicated by WL hash, against the
reference (test) set.

- ``FCD_proxy``: the Frechet distance between Gaussians fit to structural
  descriptor vectors (``fingerprints.descriptor_vector``);
- ``SNN`` and ``IntDiv``: binary Tanimoto over WL-subtree fingerprints on the
  full sets, as blockwise sparse products (the reference side's CSR and
  vocabulary built once and kept across calls);
- ``Frag`` and ``Scaf``: cosine of summed bond-environment fragment and
  scaffold counts;
- ``Filters``: the graph filters' pass rate (``filters.py``); ``weight``: the
  mean molecular weight.

``FCD`` is the real ChemNet metric: it needs canonical SMILES, which need
RDKit, so it is NaN here, as are ``QED``, ``SA`` and ``logP``, as in the JAX
package without RDKit. The NaNs keep the keys of the JAX package's output.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np

from . import fingerprints as FP
from .chemnet import fcd_from_smiles, load_default
from .filters import mol_passes_filters_graph
from .molgraph import MolGraph

MOSES_KEYS = ("FCD", "FCD_proxy", "SNN", "Frag", "Scaf", "IntDiv", "Filters", "QED", "SA",
              "logP", "weight")


def _sanitize_graphs(mols) -> List[MolGraph]:
    """Valid molecules, deduplicated by WL hash (the last of equal hashes
    kept, in the order each hash first appears)."""
    out = {}
    for m in mols:
        if m is None or m.n_atoms == 0 or not m.valence_ok():
            continue
        out[m.wl_hash()] = m
    return list(out.values())


def _descriptors(mols: List[MolGraph]) -> np.ndarray:
    return np.stack([FP.descriptor_vector(m) for m in mols]) if mols else np.zeros((0, 12))


def _precalc(mols: List[MolGraph]) -> dict:
    frag = Counter()
    for m in mols:
        frag.update(FP.fragment_counts(m))
    return {
        "fps": [FP.wl_fingerprint(m) for m in mols],
        "frag": frag,
        "scaf": Counter(s for s in (FP.scaffold_hash(m) for m in mols) if s),
        "desc": _descriptors(mols),
    }


def _cos_counters(c1, c2) -> float:
    keys = set(c1) | set(c2)
    if not keys:
        return float("nan")
    v1 = np.array([c1.get(k, 0) for k in keys], dtype=np.float64)
    v2 = np.array([c2.get(k, 0) for k in keys], dtype=np.float64)
    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(np.dot(v1, v2) / denom) if denom else 0.0


def _frechet_or_nan(x: np.ndarray, y: np.ndarray) -> float:
    """``frechet_distance``, NaN where it cannot be formed (a set too small
    for a covariance: ``sqrtm`` refuses the NaNs, as the JAX package's
    ``except`` turns into NaN)."""
    try:
        return FP.frechet_distance(x, y)
    except (ValueError, np.linalg.LinAlgError):
        return float("nan")


def _chemnet_fcd(ref_smiles: List[str], gen_smiles: List[str], device=None) -> float:
    """The real ChemNet FCD; NaN unless both sets have SMILES and ChemNet's
    weights are installed (``chemnet.py``)."""
    if not ref_smiles or not gen_smiles or load_default() is None:
        return float("nan")
    return fcd_from_smiles(gen_smiles, ref_smiles, device)


def get_moses_metrics(test_mols):
    """``moses_metrics(gen_mols) -> {MOSES_KEYS: value}`` against the
    reference molecules ``test_mols``, whose statistics are computed
    once."""
    ptest = _precalc(_sanitize_graphs(test_mols))

    def moses_metrics(gen_mols):
        gen_graphs = _sanitize_graphs(gen_mols)
        if not gen_graphs:
            return {k: float("nan") for k in MOSES_KEYS}
        pgen = _precalc(gen_graphs)
        # canonical SMILES need RDKit: without them the real FCD is NaN
        metrics = {"FCD_proxy": _frechet_or_nan(pgen["desc"], ptest["desc"]),
                   "FCD": _chemnet_fcd([], [])}
        # the reference side's CSR and vocabulary, built on the first call;
        # the vocabulary grows append-only with unseen generated features, so
        # the cached columns stay valid and a copy is only widened
        if "wl_csr" not in ptest:
            ptest["wl_vocab"] = {}
            ptest["wl_csr"] = FP.counters_to_csr(ptest["fps"], ptest["wl_vocab"])
        gen_mat = FP.counters_to_csr(pgen["fps"], ptest["wl_vocab"])
        ref_mat = ptest["wl_csr"]
        if ref_mat.shape[1] != gen_mat.shape[1]:
            ref_mat = ref_mat.copy()
            ref_mat.resize((ref_mat.shape[0], gen_mat.shape[1]))
        metrics["SNN"] = FP.snn_matrix(gen_mat, ref_mat)
        metrics["IntDiv"] = FP.internal_diversity_matrix(gen_mat)
        metrics["Frag"] = _cos_counters(pgen["frag"], ptest["frag"])
        metrics["Scaf"] = _cos_counters(pgen["scaf"], ptest["scaf"])
        metrics["Filters"] = float(np.mean([mol_passes_filters_graph(m) for m in gen_graphs]))
        metrics.update(QED=float("nan"), SA=float("nan"), logP=float("nan"))
        metrics["weight"] = float(np.mean([FP.mol_weight(m) for m in gen_graphs]))
        return metrics

    return moses_metrics


def get_fcd_metric(test_mols):
    """``fcd_metric(gen_mols) -> {"FCD", "FCD_proxy"}``: the real FCD (NaN
    without SMILES and weights) and the descriptor proxy."""
    ref_desc = _descriptors(_sanitize_graphs(test_mols))

    def fcd_metric(gen_mols):
        gen = _sanitize_graphs(gen_mols)
        return {"FCD": _chemnet_fcd([], []),
                "FCD_proxy": _frechet_or_nan(_descriptors(gen), ref_desc) if gen
                else float("nan")}

    return fcd_metric
