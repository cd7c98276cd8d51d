"""The evaluation sweep (port of ``diffspectra_tpu/run_lib.py``'s
``diffspectra_evaluate``, graph mode, one device).

    from diffspectra_tpu_torch import configs, run_lib
    figures = run_lib.evaluate(configs.get_config(), "artifacts/warm_qm9s_as.npz", "eval")

Samples ``eval.num_samples`` test targets of the synthetic split with the
seed-42 harness, scores the 3D and 2D stability and validity, repeats the
sweep ``eval.num_candidates`` times for Top-K and the consensus vote
(ties to the first draw), splits each hit rate by whether the target's graph
is in the train split, and scores the valid pairs' similarity (Top-1 over
valid pairs, MCES, WL Tanimoto and cosine, functional groups). The log
lines are the JAX package's, text and figures; ``evaluate`` returns the
figures as a dict.

The weights come from a warm-state export: checkpoint loading is training
work (``ROADMAP.md`` queue 1, item 6). Left out: the moses metrics, the
sub-geometry MMDs, ``save_mols``, the original-QM9 reference sets, the mesh
and the checkpoint loop.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .api import load_dmt
from .data.pipeline import get_dataset
from .device import resolve_device
from .diffusion.schedule import NoiseScheduleVP
from .evaluation import compute_metrics as cm
from .evaluation.molgraph import from_decoded
from .evaluation.stability import get_2D_edm_metric, get_edm_metric
from .sampling.harness import make_cond_sampling_fn
from .utils.scalers import get_data_inverse_scaler


def _rows_to_molgraphs(rows, atom_decoder):
    """MolGraphs of dataset rows (positions and charges ``[M, N, 1]``)."""
    out = []
    for i in range(len(rows["num_atom"])):
        n = int(rows["num_atom"][i])
        out.append(from_decoded(
            (rows["positions"][i][:n], rows["atom_type"][i][:n], rows["edge_type"][i][:n, :n],
             rows["formal_charges"][i][:n, 0].astype(np.int64)),
            atom_decoder,
        ))
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def diffspectra_evaluate(config, model, eval_dir: str, device, ckpt: str = "warm") -> dict:
    """The sweep with ``model`` (a DMT in eval mode on ``device``); files go
    to ``eval_dir`` under the name ``ckpt``. Returns the figures: each log
    line's values, the rounds (draws, ``n_pad``), each sweep's wall time
    and decoded targets, and the phase times."""
    device = resolve_device(device)
    os.makedirs(eval_dir, exist_ok=True)
    _, train_ds, _, test_ds, dataset_info = get_dataset(config)
    n_samples, batch_size = int(config.eval.num_samples), int(config.eval.batch_size)
    sampling_fn = make_cond_sampling_fn(
        config, model, NoiseScheduleVP(config.sde.schedule), batch_size, n_samples,
        get_data_inverse_scaler(config), test_ds, device,
        sampling_temperature=config.eval.sampling_temperature,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(config.seed))

    atom_decoder = dataset_info["atom_decoder"]
    logging.info("metric reference sets: conditional-split dataset")
    logging.info("loading training mols")
    train_graphs = _rows_to_molgraphs(train_ds.take(np.arange(len(train_ds))), atom_decoder)
    edm_metric = get_edm_metric(dataset_info, train_graphs)
    edm_metric_2d = get_2D_edm_metric(dataset_info, train_graphs)
    train_hashes = {g.wl_hash() for g in train_graphs}

    figures = {"targets": n_samples, "rounds": sampling_fn.rounds, "sweeps": [],
               "phase_seconds": {}}
    phase_t = [time.monotonic()]

    def tick(name):
        now = time.monotonic()
        logging.info("phase-time || %s: %.1fs", name, now - phase_t[0])
        figures["phase_seconds"][name] = now - phase_t[0]
        phase_t[0] = now

    def sweep():
        _sync(device)
        t0 = time.monotonic()
        processed, gt_pos, gt_mols = sampling_fn(generator)
        _sync(device)
        seconds = time.monotonic() - t0
        sampling_s, decode_s = (sum(r) for r in zip(*sampling_fn.round_seconds))
        logging.info("phase-time || sweep %d: %.1fs, of which sampling %.1fs and decode %.2fs "
                     "over %d rounds", len(figures["sweeps"]) + 1, seconds, sampling_s, decode_s,
                     len(sampling_fn.round_seconds))
        figures["sweeps"].append({"seconds": seconds,
                                  "decoded": sum(m is not None for m in processed),
                                  "round_seconds": sampling_fn.round_seconds})
        return processed, gt_mols

    logging.info("load checkpoint: %s", ckpt)
    logging.info("Sampling -- ckpt: %s", ckpt)
    processed_mols, gt_mols = sweep()
    logging.info("Sampling accomplished")
    tick("sampling+decode")

    stability_res, rdkit_res, sample_mols = edm_metric(processed_mols)
    logging.info(
        "Metric-3D || atom stability: %.4f, mol stability: %.4f, "
        "validity: %.4f, complete: %.4f,",
        stability_res["atom_stable"], stability_res["mol_stable"],
        rdkit_res["Validity"], rdkit_res["Complete"],
    )
    figures["metric_3d"] = {**stability_res, **rdkit_res}
    tick("metrics-3d")

    stability_res, rdkit_res, complete_mols = edm_metric_2d(processed_mols)
    logging.info(
        "Metric-2D || atom stability: %.4f, mol stability: %.4f, "
        "validity: %.4f, complete: %.4f, unique & valid: %.4f, "
        "unique & valid & novelty: %.4f",
        stability_res["atom_stable"], stability_res["mol_stable"],
        rdkit_res["Validity"], rdkit_res["Complete"], rdkit_res["Unique"],
        rdkit_res["Novelty"],
    )
    figures["metric_2d"] = {**stability_res, **rdkit_res}
    tick("metrics-2d")

    gt_graphs = [from_decoded(m, atom_decoder) for m in gt_mols]
    num_candidates = int(config.eval.num_candidates)
    # consensus: per target, the count of each structure over the K draws;
    # the mode is the answer, ties going to the earliest-drawn structure
    cons_2d = [{} for _ in gt_graphs]
    cons_3d = [{} for _ in gt_graphs]

    def cons_add(cons, mols):
        for slot, m in zip(cons, mols):
            cid = cm.canonical_id(m)
            if cid is not None:
                slot[cid] = slot.get(cid, 0) + 1

    def cons_hits(cons):
        hits = []
        for t, slot in zip(gt_graphs, cons):
            tid = cm.canonical_id(t)
            # max() is stable over insertion order: ties go to the first draw
            hits.append(bool(slot) and tid is not None
                        and max(slot.items(), key=lambda kv: kv[1])[0] == tid)
        return hits

    hit_3d = [cm._exact_match(t, m) for t, m in zip(gt_graphs, sample_mols)]
    hit_2d = [cm._exact_match(t, m) for t, m in zip(gt_graphs, complete_mols)]
    top1_3d, top1_2d = list(hit_3d), list(hit_2d)
    n_valid = max(sum(1 for t in gt_graphs if t is not None), 1)
    figures["top1_3d"], figures["top1_2d"] = sum(top1_3d) / n_valid, sum(top1_2d) / n_valid
    splits = [("Top-1 2D", top1_2d), ("Top-1 3D", top1_3d)]
    if num_candidates > 1:
        cons_add(cons_2d, complete_mols)
        cons_add(cons_3d, sample_mols)
        for extra in range(num_candidates - 1):
            logging.info("Top-K candidate sweep %d/%d", extra + 2, num_candidates)
            extra_processed, _ = sweep()
            _, _, extra_3d = edm_metric(extra_processed)
            hit_3d = [h or cm._exact_match(t, m) for h, t, m in zip(hit_3d, gt_graphs, extra_3d)]
            cons_add(cons_3d, extra_3d)
            _, _, extra_2d = edm_metric_2d(extra_processed)
            hit_2d = [h or cm._exact_match(t, m) for h, t, m in zip(hit_2d, gt_graphs, extra_2d)]
            cons_add(cons_2d, extra_2d)
        logging.info("Top-%d accuracy || 3D: %.4f", num_candidates, sum(hit_3d) / n_valid)
        logging.info("Top-%d accuracy || 2D: %.4f", num_candidates, sum(hit_2d) / n_valid)
        cons_hit_2d, cons_hit_3d = cons_hits(cons_2d), cons_hits(cons_3d)
        logging.info("Consensus Top-1 (mode of %d draws) || 3D: %.4f",
                     num_candidates, sum(cons_hit_3d) / n_valid)
        logging.info("Consensus Top-1 (mode of %d draws) || 2D: %.4f",
                     num_candidates, sum(cons_hit_2d) / n_valid)
        figures.update(topk_3d=sum(hit_3d) / n_valid, topk_2d=sum(hit_2d) / n_valid,
                       consensus_3d=sum(cons_hit_3d) / n_valid,
                       consensus_2d=sum(cons_hit_2d) / n_valid)
        splits = [("Top-1 2D", top1_2d), ("Top-1 3D", top1_3d),
                  (f"Top-{num_candidates} 2D", hit_2d), (f"Top-{num_candidates} 3D", hit_3d),
                  ("Consensus 2D", cons_hit_2d), ("Consensus 3D", cons_hit_3d)]
        tick(f"topk-extra-sweeps(x{num_candidates - 1})")

    # seen/unseen targets: a pure memorizer scores 0 on targets whose exact
    # graph is not in the model's train split
    gt_hashes = [None if g is None else g.wl_hash() for g in gt_graphs]
    n_seen = sum(1 for h in gt_hashes if h is not None and h in train_hashes)
    n_tot = sum(1 for h in gt_hashes if h is not None)
    logging.info(
        "Generalization || train split counted against: the second train half of the "
        "synthetic set (seed %d, size %d, fidelity %d), %d molecules",
        config.seed, config.data.synthetic_size, config.data.synthetic_fidelity, len(train_ds),
    )
    logging.info(
        "Generalization || memorization bound: %.4f of targets "
        "(%d/%d) have their exact graph in the train set",
        n_seen / max(n_tot, 1), n_seen, n_tot,
    )
    figures["generalization"] = {"seen": n_seen, "targets": n_tot}
    for tag, hits in splits:
        sh = st = uh = ut = 0
        for hit, h in zip(hits, gt_hashes):
            if h is None:
                continue
            if h in train_hashes:
                st += 1
                sh += bool(hit)
            else:
                ut += 1
                uh += bool(hit)
        logging.info(
            "Generalization || %s exact match: seen-target %.4f "
            "(%d/%d), unseen-target %.4f (%d/%d)",
            tag, sh / max(st, 1), sh, st, uh / max(ut, 1), uh, ut,
        )
        figures["generalization"][tag] = {"seen": sh / max(st, 1), "unseen": uh / max(ut, 1)}

    for mols, name in ((sample_mols, "3D"), (complete_mols, "2D")):
        table = cm.compute_similarity_metrics(mols, gt_graphs, eval_dir, ckpt, name)
        figures[f"similarity_{name.lower()}"] = (
            None if table is None else {k: float(v) for k, v in table.items()})
    tick("similarity")
    return figures


def evaluate(config, warm_state: str, eval_dir: str, device=None) -> dict:
    """The sweep with the EMA weights of the warm-state export
    ``warm_state``, on ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    model = load_dmt(warm_state, config, device)
    ckpt = os.path.splitext(os.path.basename(warm_state))[0]
    return diffspectra_evaluate(config, model, eval_dir, device, ckpt)
