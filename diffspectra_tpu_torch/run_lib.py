"""Training and the evaluation sweep (port of ``diffspectra_tpu/run_lib.py``'s
``diffspectra_train`` and ``diffspectra_evaluate``, graph mode).

    from diffspectra_tpu_torch import configs, run_lib
    state = run_lib.train(configs.get_config(), "exp/train")
    figures = run_lib.evaluate(configs.get_config(), "artifacts/warm_qm9s_as.npz", "eval")
    figures = run_lib.evaluate_workdir(configs.get_config(), "exp/train", "exp/train/eval")

``train`` trains on the second train half of QM9S (``data.root``) or of
the synthetic set in bucketed batches, augmented by a random rotation and
translation, with the loss, optimizer and EMA of ``training/``; the model
is ``model.name``'s (``utils/registry.py``: the DMT, DMT_WO_EQ, or CDGS on
the 2-D path of ``only_2D``, not augmented, its snapshot and sweep scoring
the 2-D figures alone and writing no sample xyz files). The split
sits on the device and each batch is gathered there from an index vector
(``data/device_store.py``) when ``data.device_resident`` is set and the
split fits ``data.device_store_max_bytes``; else the host iterator
collates each batch on a background thread and copies it over. It logs the
loss and graphs/s every ``training.log_freq`` steps and stops on a
non-finite loss; writes the preemption and numbered checkpoints
(``checkpoint.py``) and resumes from them, or warm-starts from
``training.warm_start`` (whole, or with ``training.warm_start_partial``
the leaves that match, ``warm_start_zero_fresh`` zeroing fresh ones);
merges ``model.pretrained_specformer_path`` into a fresh model before its
train state is built; with ``training.profile`` writes a
``torch.profiler`` trace of steps ``[init+10, init+15)`` under
``<workdir>/profile``; and at each snapshot samples
``training.eval_samples`` validation targets from the EMA weights through
``sampling/harness.py`` (the serving kernels) and logs their stability
figures (also to ``<workdir>/samples/iter_<step>.json``), and writes the
xyz files of up to 16 sampled molecules and of their targets to
``<workdir>/samples/iter_<step>`` and ``iter_<step>_gt``
(``visualize.py``; the JAX package's grid image needs RDKit). It exports
the last state as ``<workdir>/warm_state.npz``
(``warm_state.export_warm_state``).

In a process group (``parallel.init_distributed``: ``torchrun``, one
process a device) ``train`` is data parallel: the batch sizes resolve as
the JAX package's do (``configs.resolve_runtime_config``: 0 means
``base_batch_size`` x the ranks), the world size divides
``training.batch_size``, each rank trains on its rows of every batch (its
shard of the device store, or its rows of the host iterator's batch) with
draws of its own (``parallel.rank_seed``: rank 0's are one process's), and
the step averages the gradients, loss and batch statistics over the ranks
(``training/step.py``). Rank 0 alone logs the step lines and writes the
checkpoints, the profile, the snapshot's files and the export, a barrier
after each; the snapshot fans its draws out over the ranks.

Samples ``eval.num_samples`` test targets with the seed-42 harness, scores
the 3D and 2D stability and validity and the moses metrics (FCD and its
descriptor proxy, SNN, Frag, Scaf, IntDiv, Filters, weight; the RDKit
ones NaN), with ``eval.sub_geometry`` the sub-geometry MMDs of the 2D
molecules (their kernel sums on the device), repeats the sweep
``eval.num_candidates`` times for Top-K and the consensus vote (ties to the
first draw), splits each hit rate by whether the target's graph is in the
model's own train split, scores the valid pairs' similarity (Top-1 over
valid pairs, MCES, WL Tanimoto and cosine, functional groups), and with
``eval.save_mols="true"`` pickles the molecules for
``evaluation/base_metrics.py``. The metric reference sets (novelty's train
molecules, the moses and geometry test molecules) come from the
original-QM9 split of ``configs.original_qm9_config`` where it is passed
(``--original-qm9``), else from the config's own split. The log lines are
the JAX package's, text and figures; ``evaluate`` returns the figures as a
dict. Without ``eval.enable_sampling`` nothing is sampled.

The weights come from a warm-state export (``evaluate``), from each of a
train workdir's numbered checkpoints that ``eval.ckpts`` (or
``eval.begin_ckpt`` ... ``eval.end_ckpt``) names, one sweep and one set of
figures a checkpoint, the references built once (``evaluate_checkpoints``,
``--mode eval``), or from its latest resumable checkpoint, as
``Elucidator.from_workdir`` restores it (``evaluate_workdir``). All build
the schedule of ``config.sde`` (``NoiseScheduleVP.from_config``) and run
any of the config's model variants. In a process group the sweep fans out
over the ranks (``sampling/harness.py``), each rank returns the same
figures, and rank 0 alone writes the tables, pickles and figure files.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import checkpoint as ckpt_lib
from .api import load_model, restore_model
from .configs import resolve_runtime_config
from .data import device_store
from .data.pipeline import (
    augment_positions,
    get_batch_iterator,
    get_dataset,
    inf_iterator,
    prefetch,
)
from .device import resolve_device
from .diffusion.schedule import NoiseScheduleVP
from .evaluation import compute_metrics as cm
from .evaluation.cal_geometry import get_sub_geometry_metric
from .evaluation.molgraph import from_decoded
from .evaluation.mose_metric import get_moses_metrics
from .evaluation.stability import get_2D_edm_metric, get_edm_metric
from .models.layers import refresh_casts
from .models.pretrained import load_pretrained_specformer
from .parallel import (create_mesh, make_parallel_store_step, make_parallel_train_step,
                       rank_seed, replicate)
from .parallel.mesh import barrier
from .sampling.harness import make_cond_sampling_fn, sampling_world
from .training.losses import draw
from .training.optim import get_optimizer
from .training.step import get_step_fn, load_ema_weights
from .training.train_state import create_train_state
from .utils.registry import create_model
from .utils.scalers import get_data_inverse_scaler, get_data_scaler
from .visualize import visualize_mols
from .warm_state import export_warm_state, init_variables, load_model_state, warm_start


def _rows_to_molgraphs(rows, atom_decoder):
    """MolGraphs of dataset rows: transformed (``positions``, charges
    ``[M, N, 1]``) or raw (``pos``, ``fc [M, N]``, as
    ``get_dataset(transform=False)`` gives the reference sets)."""
    pos = rows["positions"] if "positions" in rows else rows["pos"]
    fc = rows["formal_charges"][..., 0] if "formal_charges" in rows else rows["fc"]
    out = []
    for i in range(len(rows["num_atom"])):
        n = int(rows["num_atom"][i])
        out.append(from_decoded(
            (pos[i][:n], rows["atom_type"][i][:n], rows["edge_type"][i][:n, :n],
             fc[i][:n].astype(np.int64)),
            atom_decoder,
        ))
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_graphs(ds, atom_decoder):
    return _rows_to_molgraphs(ds.take(np.arange(len(ds))), atom_decoder)


def eval_references(config, device, config_original_qm9=None) -> dict:
    """The sweep's datasets and metrics, built once for every checkpoint:
    the splits of ``config``; the metric reference sets (train molecules
    for novelty, test molecules for the moses statistics and the target
    geometry) from ``config_original_qm9``'s original-QM9 split
    (``configs.original_qm9_config``) where given, else from ``config``'s
    own; the stability, moses and (with ``eval.sub_geometry``) sub-geometry
    metrics, the last on ``device``; and the WL hashes of the model's own
    second train split, which the seen/unseen split always counts
    against."""
    device = resolve_device(device)
    mesh = create_mesh(config.training.num_devices, device)
    if mesh.rank > 0:  # rank 0 writes the geometry statistics first where they are missing
        barrier(mesh)
    references = _eval_references(config, device, config_original_qm9)
    if mesh.rank == 0:
        barrier(mesh)
    return references


def _eval_references(config, device, config_original_qm9):
    _, train_ds, _, test_ds, dataset_info = get_dataset(config)
    atom_decoder = dataset_info["atom_decoder"]
    if config_original_qm9 is not None:
        logging.info("metric reference sets: original-QM9 (--original-qm9)")
        # the raw arrays: the reference molecules need no one-hots or spectra
        _, ref_train_ds, _, ref_test_ds, _ = get_dataset(config_original_qm9, transform=False)
    else:
        logging.info("metric reference sets: conditional-split dataset "
                     "(no --original-qm9 given)")
        ref_train_ds, ref_test_ds = train_ds, test_ds
    logging.info("loading training mols")
    train_graphs = _all_graphs(ref_train_ds, atom_decoder)
    logging.info("loading test mols")
    test_graphs = _all_graphs(ref_test_ds, atom_decoder)
    model_train = train_graphs if config_original_qm9 is None else \
        _all_graphs(train_ds, atom_decoder)
    return {
        "train_ds": train_ds, "test_ds": test_ds, "dataset_info": dataset_info,
        "reference_sets": "conditional-split" if config_original_qm9 is None else "original-QM9",
        "edm_metric": get_edm_metric(dataset_info, train_graphs),
        "edm_metric_2d": get_2D_edm_metric(dataset_info, train_graphs),
        "mose_metric": get_moses_metrics(test_graphs),
        "sub_geo_metric": get_sub_geometry_metric(
            test_graphs, dataset_info, config.data.root, device, config.seed)
        if config.eval.sub_geometry else None,
        "train_hashes": {g.wl_hash() for g in model_train},
    }


def save_molecules(eval_dir: str, ckpt: str, sample_mols, complete_mols, gt_graphs) -> str:
    """Pickle the sweep's 3D and 2D molecules and its targets (all
    ``MolGraph`` lists) to ``<eval_dir>/molecules_ckpt_<ckpt>``, the files
    ``evaluation/base_metrics.py`` rescores; returns the directory. The JAX
    package pickles its targets as decoded tuples, which its own rescoring
    cannot read; the port pickles them as graphs."""
    analysis_dir = os.path.join(eval_dir, f"molecules_ckpt_{ckpt}")
    os.makedirs(analysis_dir, exist_ok=True)
    for name, mols in (("sample_rdmols_3d.pkl", sample_mols),
                       ("complete_rdmols_2d.pkl", complete_mols),
                       ("groundtruth_rdmols.pkl", gt_graphs)):
        with open(os.path.join(analysis_dir, name), "wb") as f:
            pickle.dump(mols, f)
    return analysis_dir


def diffspectra_evaluate(config, model, eval_dir: str, device, ckpt: str = "warm",
                         config_original_qm9=None, references=None) -> dict:
    """The sweep with ``model`` (the config's model in eval mode on
    ``device``); files go
    to ``eval_dir`` under the name ``ckpt``. ``references`` are
    ``eval_references``' (built here from ``config_original_qm9`` when not
    given). Returns the figures: each log line's values, the rounds (draws,
    ``n_pad``), each sweep's wall time and decoded targets, and the phase
    times; nothing is sampled without ``eval.enable_sampling``. In a process
    group the sweep fans out over the ranks (``sampling_world``), every rank
    returns the same figures and rank 0 alone writes the files."""
    device = resolve_device(device)
    mesh = create_mesh(config.training.num_devices, device)
    config = resolve_runtime_config(config, mesh.world)
    os.makedirs(eval_dir, exist_ok=True)
    if references is None:
        references = eval_references(config, device, config_original_qm9)
    train_ds, test_ds = references["train_ds"], references["test_ds"]
    atom_decoder = references["dataset_info"]["atom_decoder"]
    edm_metric, edm_metric_2d = references["edm_metric"], references["edm_metric_2d"]
    mose_metric, train_hashes = references["mose_metric"], references["train_hashes"]

    figures = {"reference_sets": references["reference_sets"], "sweeps": [],
               "phase_seconds": {}}
    logging.info("load checkpoint: %s", ckpt)
    if not config.eval.enable_sampling:
        return figures
    n_samples = int(config.eval.num_samples)
    fan, batch_size = sampling_world(mesh.world, int(config.eval.batch_size))
    sampling_fn = make_cond_sampling_fn(
        config, model, NoiseScheduleVP.from_config(config), batch_size, n_samples,
        get_data_inverse_scaler(config), test_ds, device,
        sampling_temperature=config.eval.sampling_temperature,
        rank=mesh.rank if fan > 1 else 0, world=fan,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(config.seed))
    figures.update(targets=n_samples, rounds=sampling_fn.rounds)
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

    logging.info("Sampling -- ckpt: %s", ckpt)
    processed_mols, gt_mols = sweep()
    logging.info("Sampling accomplished")
    tick("sampling+decode")

    only_2d = bool(config.only_2D)  # no positions: the 2-D figures alone
    sample_mols = []
    if not only_2d:
        stability_res, rdkit_res, sample_mols = edm_metric(processed_mols)
        logging.info(
            "Metric-3D || atom stability: %.4f, mol stability: %.4f, "
            "validity: %.4f, complete: %.4f,",
            stability_res["atom_stable"], stability_res["mol_stable"],
            rdkit_res["Validity"], rdkit_res["Complete"],
        )
        figures["metric_3d"] = {**stability_res, **rdkit_res}
        mose_res = mose_metric(sample_mols)
        logging.info("Metric-3D || FCD: %.4f (FCD_proxy: %.4f)", mose_res["FCD"],
                     mose_res["FCD_proxy"])
        figures["moses_3d"] = mose_res
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
    mose_res = mose_metric(complete_mols)
    logging.info(
        "Metric-2D || FCD: %.4f (FCD_proxy: %.4f), SNN: %.4f, "
        "Frag: %.4f, Scaf: %.4f, IntDiv: %.4f",
        mose_res["FCD"], mose_res["FCD_proxy"], mose_res["SNN"],
        mose_res["Frag"], mose_res["Scaf"], mose_res["IntDiv"],
    )
    logging.info(
        "Metric-2D || Filters: %.4f, QED: %.4f, SA: %.4f, "
        "logP: %.4f, weight: %.4f",
        mose_res["Filters"], mose_res["QED"], mose_res["SA"],
        mose_res["logP"], mose_res["weight"],
    )
    figures["moses_2d"] = mose_res
    tick("metrics-2d")

    if references["sub_geo_metric"] is not None:
        sub_geo_res = references["sub_geo_metric"](complete_mols)
        logging.info(
            "Metric-Align || Bond Length MMD: %.4f, Bond Angle MMD: "
            "%.4f, Dihedral Angle MMD: %.6f",
            sub_geo_res["bond_length_mean"], sub_geo_res["bond_angle_mean"],
            sub_geo_res["dihedral_angle_mean"],
        )
        figures["geometry"] = sub_geo_res
        tick("geometry")

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
    figures["top1_2d"] = sum(top1_2d) / n_valid
    if not only_2d:
        figures["top1_3d"] = sum(top1_3d) / n_valid
    splits = [("Top-1 2D", top1_2d), ("Top-1 3D", top1_3d)]
    if num_candidates > 1:
        cons_add(cons_2d, complete_mols)
        cons_add(cons_3d, sample_mols)
        for extra in range(num_candidates - 1):
            logging.info("Top-K candidate sweep %d/%d", extra + 2, num_candidates)
            extra_processed, _ = sweep()
            if not only_2d:
                _, _, extra_3d = edm_metric(extra_processed)
                hit_3d = [h or cm._exact_match(t, m)
                          for h, t, m in zip(hit_3d, gt_graphs, extra_3d)]
                cons_add(cons_3d, extra_3d)
            _, _, extra_2d = edm_metric_2d(extra_processed)
            hit_2d = [h or cm._exact_match(t, m) for h, t, m in zip(hit_2d, gt_graphs, extra_2d)]
            cons_add(cons_2d, extra_2d)
        if not only_2d:
            logging.info("Top-%d accuracy || 3D: %.4f", num_candidates, sum(hit_3d) / n_valid)
        logging.info("Top-%d accuracy || 2D: %.4f", num_candidates, sum(hit_2d) / n_valid)
        cons_hit_2d, cons_hit_3d = cons_hits(cons_2d), cons_hits(cons_3d)
        if not only_2d:
            logging.info("Consensus Top-1 (mode of %d draws) || 3D: %.4f",
                         num_candidates, sum(cons_hit_3d) / n_valid)
            figures.update(topk_3d=sum(hit_3d) / n_valid,
                           consensus_3d=sum(cons_hit_3d) / n_valid)
        logging.info("Consensus Top-1 (mode of %d draws) || 2D: %.4f",
                     num_candidates, sum(cons_hit_2d) / n_valid)
        figures.update(topk_2d=sum(hit_2d) / n_valid, consensus_2d=sum(cons_hit_2d) / n_valid)
        splits = [("Top-1 2D", top1_2d), ("Top-1 3D", top1_3d),
                  (f"Top-{num_candidates} 2D", hit_2d), (f"Top-{num_candidates} 3D", hit_3d),
                  ("Consensus 2D", cons_hit_2d), ("Consensus 3D", cons_hit_3d)]
        tick(f"topk-extra-sweeps(x{num_candidates - 1})")
    if only_2d:
        splits = [(tag, hits) for tag, hits in splits if not tag.endswith("3D")]

    # seen/unseen targets: a pure memorizer scores 0 on targets whose exact
    # graph is not in the model's train split
    gt_hashes = [None if g is None else g.wl_hash() for g in gt_graphs]
    n_seen = sum(1 for h in gt_hashes if h is not None and h in train_hashes)
    n_tot = sum(1 for h in gt_hashes if h is not None)
    source = (f"synthetic set (seed {config.seed}, size {config.data.synthetic_size}, "
              f"fidelity {config.data.synthetic_fidelity})" if config.data.synthetic
              else f"QM9S at {config.data.root}")
    logging.info("Generalization || train split counted against: the second train half of the "
                 "%s, %d molecules", source, len(train_ds))
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

    scored = [(complete_mols, "2D")]
    if not only_2d:
        scored.insert(0, (sample_mols, "3D"))
    with tempfile.TemporaryDirectory() as scratch:
        # the other ranks score the same pairs into files of their own, thrown away
        tables_dir = eval_dir if mesh.rank == 0 else scratch
        for mols, name in scored:
            table = cm.compute_similarity_metrics(mols, gt_graphs, tables_dir, ckpt, name)
            figures[f"similarity_{name.lower()}"] = (
                None if table is None else {k: float(v) for k, v in table.items()})
    tick("similarity")

    if str(config.eval.save_mols).lower() == "true":
        figures["saved_mols"] = os.path.join(eval_dir, f"molecules_ckpt_{ckpt}")
        if mesh.rank == 0:
            save_molecules(eval_dir, ckpt, sample_mols, complete_mols, gt_graphs)
    return figures


def evaluate(config, warm_state: str, eval_dir: str, device=None,
             config_original_qm9=None) -> dict:
    """The sweep with the EMA weights of the warm-state export
    ``warm_state``, on ``cuda`` unless ``device="cpu"``, its metric
    reference sets from ``config_original_qm9`` where given."""
    device = resolve_device(device)
    model = load_model(warm_state, config, device)
    ckpt = os.path.splitext(os.path.basename(warm_state))[0]
    return diffspectra_evaluate(config, model, eval_dir, device, ckpt, config_original_qm9)


def checkpoints_to_evaluate(config) -> list:
    """``eval.ckpts`` (``"1,2"``), or ``eval.begin_ckpt`` ...
    ``eval.end_ckpt``."""
    if config.eval.ckpts != "":
        return [int(c) for c in str(config.eval.ckpts).split(",")]
    return list(range(config.eval.begin_ckpt, config.eval.end_ckpt + 1))


def evaluate_checkpoints(config, workdir: str, eval_folder: str = "eval", device=None,
                         config_original_qm9=None) -> dict:
    """The sweep with the EMA weights of each numbered checkpoint
    ``checkpoints/checkpoint_<N>`` of ``workdir`` that
    ``checkpoints_to_evaluate`` names, in turn, on ``cuda`` unless
    ``device="cpu"``; each one's tables and ``figures_ckpt_<N>.json`` go to
    ``<workdir>/<eval_folder>``. Returns ``{N: figures}``; a missing
    checkpoint raises ``FileNotFoundError`` when its turn comes."""
    device = resolve_device(device)
    eval_dir = os.path.join(workdir, eval_folder)
    references = eval_references(config, device, config_original_qm9)
    out = {}
    for ckpt in checkpoints_to_evaluate(config):
        path = ckpt_lib.numbered_checkpoint_dir(workdir, ckpt)
        if not os.path.exists(path):
            raise FileNotFoundError("Checkpoint path error: " + path)
        model, _ = restore_model(workdir, config, device, ckpt=ckpt)
        out[ckpt] = diffspectra_evaluate(config, model, eval_dir, device, str(ckpt),
                                         references=references)
        if create_mesh(config.training.num_devices, device).rank == 0:
            with open(os.path.join(eval_dir, f"figures_ckpt_{ckpt}.json"), "w") as f:
                json.dump(out[ckpt], f)
    return out


def evaluate_workdir(config, workdir: str, eval_dir: str, device=None,
                     config_original_qm9=None) -> dict:
    """The sweep with the EMA weights of a train workdir's latest resumable
    checkpoint (``api.restore_model``), on ``cuda`` unless ``device="cpu"``;
    ``FileNotFoundError`` when the workdir holds none."""
    device = resolve_device(device)
    model, step = restore_model(workdir, config, device)
    return diffspectra_evaluate(config, model, eval_dir, device, f"step_{step}",
                                config_original_qm9)


def batch_to_device(batch, device) -> dict:
    """A collated numpy batch as tensors on ``device`` (``num_atom``
    dropped, ``context`` a tuple)."""
    out = {k: torch.from_numpy(v).to(device, non_blocking=True)
           for k, v in batch.items() if k not in ("context", "num_atom")}
    out["context"] = tuple(torch.from_numpy(c).to(device, non_blocking=True)
                           for c in batch["context"])
    return out


# the models trained with a random rotation and translation of each batch
AUGMENTED = ("DMT", "DMT_WO_EQ")


def init_train_state(config, device):
    """A fresh model of ``model.name`` (flax's initializers, from
    ``config.seed``; SpecFormer from ``model.pretrained_specformer_path``
    where set) in training mode on ``device``, its optimizer and train
    state."""
    model = create_model(config)
    load_model_state(model, init_variables(model, config.seed))
    if config.model.pretrained_specformer_path:
        logging.info("Load pretrained SpecFormer")
        load_pretrained_specformer(model, config.model.pretrained_specformer_path,
                                   config.data.spectra_version)
        refresh_casts(model)
    else:
        logging.info("Train SpecFormer from scratch")
    model.to(device).train()
    tx = get_optimizer(config)
    state = create_train_state(model, tx, config.model.ema_decay)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("model size: %.1fMB", n_params * 4 / 2**20)
    return tx, state


def train(config, workdir: str, device=None):
    """The training loop (``diffspectra_train``) on ``cuda`` unless
    ``device="cpu"``; returns the final train state. In a process group
    (``parallel.init_distributed``) every rank runs it on its own device,
    data parallel."""
    device = resolve_device(device)
    mesh = create_mesh(config.training.num_devices, device)
    config = resolve_runtime_config(config, mesh.world)
    lead = mesh.rank == 0
    sample_dir = os.path.join(workdir, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    _, train_ds, val_ds, test_ds, dataset_info = get_dataset(config)
    logging.info("datasets: train %d val %d test %d", len(train_ds), len(val_ds), len(test_ds))
    t = config.training
    spectra_version, batch_size = config.data.spectra_version, t.batch_size
    if batch_size % mesh.world:
        raise ValueError(f"training.batch_size {batch_size} must divide over {mesh.world} ranks")
    bucket_sizes = tuple(config.data.bucket_sizes)

    tx, state = init_train_state(config, device)
    noise_scheduler = NoiseScheduleVP.from_config(config)
    state = ckpt_lib.restore_for_resume(workdir, state)
    initial_step = state.step
    if initial_step == 0 and t.warm_start:
        # only when the workdir has no checkpoint of its own: a resume wins
        zero_fresh = tuple(p for p in str(t.warm_start_zero_fresh).split(",") if p)
        state = warm_start(state, t.warm_start, partial=t.warm_start_partial,
                           zero_fresh=zero_fresh)
        initial_step = state.step
    if initial_step == 0:
        logging.info("%s", config)
    parallel = mesh.world > 1
    state = replicate(state, mesh)
    step_fn = get_step_fn(noise_scheduler, tx, get_data_scaler(config), config,
                          mesh=mesh if parallel else None)
    # each rank's own draws (rank 0's those of one process): the noise on the
    # device; the coins, dropout seeds and sampling seeds on the host
    seed = rank_seed(config.seed, mesh.rank)
    generator = torch.Generator(device=device).manual_seed(seed)
    host_generator = torch.Generator().manual_seed(seed)
    n_layers = len(state.model.blocks)
    augment = config.model.name in AUGMENTED

    def prepare(batch):
        batch["positions"] = augment_positions(
            generator, batch["positions"], batch["atom_mask"], augment, augment,
            config.data.aug_translation_scale)
        return batch, draw(generator, host_generator, batch, n_layers,
                           config.model.include_fc_charge, config.only_2D, config.pred_edge)

    # a rank holds its shard of the split: the budget is a rank's share
    store_bytes = device_store.estimate_bytes(train_ds, spectra_version)
    if (config.data.device_resident
            and store_bytes // mesh.world <= config.data.device_store_max_bytes):
        store = device_store.DeviceStore(train_ds, spectra_version, device, mesh.rank, mesh.world)
        per_rank = batch_size // mesh.world
        if not parallel:
            make_idx_iter = lambda epoch: device_store.index_iterator(  # noqa: E731
                len(store), batch_size, shuffle=True, seed=config.seed + epoch,
                drop_last=True, bucket_sizes=bucket_sizes, num_atom=store.host_num_atom)
        elif bucket_sizes:
            make_idx_iter = lambda epoch: device_store.sharded_bucket_index_iterator(  # noqa
                store.host_num_atom, store.shard_size, mesh.world, per_rank, bucket_sizes,
                shuffle=True, seed=config.seed + epoch)
        else:
            make_idx_iter = lambda epoch: ((0, idx) for idx in  # noqa: E731
                                           device_store.sharded_index_iterator(
                store.shard_size, mesh.world, per_rank, shuffle=True, seed=config.seed + epoch))
        idx_iter = inf_iterator(make_idx_iter)
        store_step = make_parallel_store_step(
            step_fn, mesh, store.arrays, atom_types=config.data.atom_types,
            include_aromatic=config.data.include_aromatic, spectra_keys=store.spectra_keys)

        def train_step(state):
            n_pad, idx = next(idx_iter)
            return store_step(state, idx, n_pad, prepare)

        logging.info("device-resident dataset: %.0f MB on %s%s", store_bytes / 2**20, device,
                     f" ({mesh.world}-way row-sharded)" if parallel else "")
    else:
        # every rank runs the same seeded iterator and keeps its own rows
        train_iter = prefetch(inf_iterator(lambda epoch: get_batch_iterator(
            train_ds, batch_size, spectra_version, shuffle=True, seed=config.seed + epoch,
            drop_last=True, bucket_sizes=bucket_sizes)), size=2)
        host_step = make_parallel_train_step(step_fn, mesh)

        def train_step(state):
            return host_step(state, next(train_iter),
                             lambda shard: prepare(batch_to_device(shard, device)))

        logging.info("host input pipeline: the split's %.0f MB %s", store_bytes / 2**20,
                     "over data.device_store_max_bytes" if config.data.device_resident
                     else "kept on the host (data.device_resident off)")

    if t.snapshot_sampling:
        eval_model = create_model(config).to(device).eval()
        fan, snap_batch = sampling_world(mesh.world, t.eval_batch_size)
        snapshot_sampling_fn = make_cond_sampling_fn(
            config, eval_model, noise_scheduler, snap_batch, t.eval_samples,
            get_data_inverse_scaler(config), val_ds, device,
            rank=mesh.rank if fan > 1 else 0, world=fan)
        metrics = [("2D", get_2D_edm_metric(dataset_info))]
        if not config.only_2D:  # no positions: the 2-D figures alone
            metrics.insert(0, ("3D", get_edm_metric(dataset_info)))

    # rank 0 alone logs the step lines and writes files; a barrier follows each write
    log_step = logging.info if lead else logging.debug
    profiler = None
    t_last, step_last = time.time(), initial_step
    for step in range(initial_step, t.n_iters + 1):
        if lead and t.profile and step == initial_step + 10:
            profiler = start_profile(device)
        if profiler is not None and step == initial_step + 15:
            stop_profile(profiler, device, os.path.join(workdir, "profile"), step)
            profiler = None
        state, loss = train_step(state)

        if step % t.log_freq == 0:
            loss_val = float(loss)  # the ranks' mean: every rank stops at the same step
            dt = time.time() - t_last
            tput = (step - step_last) * batch_size / dt if dt > 0 else 0
            t_last, step_last = time.time(), step
            log_step("step: %d, training_loss: %.5e, graphs/sec: %.1f", step, loss_val, tput)
            if not math.isfinite(loss_val):
                logging.error("NON-FINITE training loss %r at step %d -- aborting (checkpoints "
                              "on disk keep the last finite state)", loss_val, step)
                raise FloatingPointError(f"non-finite training loss at step {step}")

        if step != 0 and step % t.snapshot_freq_for_preemption == 0:
            if lead:
                ckpt_lib.save_checkpoint_if_finite(ckpt_lib.meta_checkpoint_dir(workdir), state)
            barrier(mesh)

        if step != 0 and (step % t.snapshot_freq == 0 or step == t.n_iters):
            if lead:
                ckpt_lib.save_checkpoint_if_finite(
                    ckpt_lib.numbered_checkpoint_dir(workdir, step // t.snapshot_freq), state)
            barrier(mesh)
            if t.snapshot_sampling:
                figures = snapshot(step, state, eval_model, snapshot_sampling_fn, metrics,
                                   host_generator, device, sample_dir,
                                   dataset_info["atom_decoder"], mesh)
                if lead:
                    with open(os.path.join(sample_dir, f"iter_{step}.json"), "w") as f:
                        json.dump(figures, f)
                barrier(mesh)
    if profiler is not None:  # the run ended inside the window
        stop_profile(profiler, device, os.path.join(workdir, "profile"), t.n_iters + 1)

    if lead:
        export_warm_state(state, os.path.join(workdir, "warm_state.npz"),
                          meta={"step": state.step,
                                "source": "diffspectra_tpu_torch.run_lib.train"})
    barrier(mesh)
    return state


def start_profile(device):
    """A ``torch.profiler`` recording host ops, and the device's kernels on cuda."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.__enter__()
    return profiler


def stop_profile(profiler, device, profile_dir: str, step: int) -> str:
    """End ``profiler`` once ``device`` is done and write its Chrome trace
    to ``<profile_dir>/trace_step_<step>.json``; returns the path."""
    _sync(device)
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_step_{step}.json")
    profiler.export_chrome_trace(path)
    logging.info("profile of the steps before %d written to %s", step, path)
    return path


def snapshot(step, state, eval_model, sampling_fn, metrics, host_generator, device,
             sample_dir: str, atom_decoder, mesh=None) -> dict:
    """Sample from the EMA weights, log the stability figures of each
    ``(dim, metric)`` of ``metrics`` ("3D" and "2D", or "2D" alone on the
    2-D path), and write ``mol_<i>.xyz`` of up to 16 of the 3D metric's
    molecules to ``<sample_dir>/iter_<step>`` (the 2D metric's, where it has
    none: none without positions) and of their targets to ``iter_<step>_gt``
    (``visualize.visualize_mols``). Over several ranks (``mesh``) the
    sampling seed is rank 0's, and rank 0 alone writes the files."""
    load_ema_weights(state, eval_model)
    seed = [int(torch.randint(0, 2**62, (), generator=host_generator))]
    if mesh is not None and mesh.world > 1:
        dist.broadcast_object_list(seed, src=0)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed[0])
    processed_mols, _, gt_mols = sampling_fn(generator)
    figures, scored = {}, {"3D": []}
    for dim, metric in metrics:
        stability_res, rdkit_res, scored[dim] = metric(processed_mols)
        logging.info(
            "step: %d, n_mol: %d, %s atom stability: %.4f, mol stability: %.4f, validity: "
            "%.4f, complete: %.4f, unique & valid: %.4f", step, len(scored[dim]), dim,
            stability_res["atom_stable"], stability_res["mol_stable"], rdkit_res["Validity"],
            rdkit_res["Complete"], rdkit_res["Unique"])
        figures[dim] = {k: float(v) for k, v in {**stability_res, **rdkit_res}.items()}
    if mesh is None or mesh.rank == 0:
        visualize_mols(scored["3D"] or scored["2D"], os.path.join(sample_dir, f"iter_{step}"))
        visualize_mols([from_decoded(m, atom_decoder) for m in gt_mols],
                       os.path.join(sample_dir, f"iter_{step}_gt"))
    return figures
