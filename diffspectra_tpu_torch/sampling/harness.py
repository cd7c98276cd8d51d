"""The conditional sampling harness of the evaluation sweep: draw real
spectra and true atom counts from a dataset split, run the reverse
diffusion, decode the molecules (port of
``diffspectra_tpu/sampling/harness.py``'s ``make_cond_sampling_fn``, on one
device).

The draw order is the JAX package's: a permutation of the split from seed
42, wrapped around to whole rounds, sorted (stably) by atom count and cut
into ``ceil(n_samples / batch_size)`` rounds, each padded to the smallest
bucket that holds its largest molecule. The draws fill every round, so
the JAX harness's padding of a short last round and its skipping of the
padding's duplicates never run, and are left out. A round is
``sample_round``, which ``api.Elucidator`` serves with too, and the
bucket policy (``bucket_sizes_of``, ``bucket_for``) is the one serving
uses. Rounds run and decode one after the other; the JAX harness decodes a
round while the next one runs. Each call records its rounds' seconds of
sampling and of decoding, so the cost of the serial decode can be read.
"""

from __future__ import annotations

import logging
import math
import time
from typing import List, Tuple

import numpy as np
import torch

from ..data.pipeline import SPECTRA_KEYS
from ..utils import masks as M
from ..utils.scalers import get_self_cond_fn
from .ancestral import AncestralSampler, make_time_steps
from .decode import mol_process, post_process
from .dpm_solver import DPMSolverPP

# the eval sweep's fixed target permutation, as in the JAX harness and the
# reference (independent of config.seed)
EVAL_PERMUTATION_SEED = 42


def make_sampler(config, noise_scheduler, sampling_temperature: float = 1.0):
    """The sampler of ``config.sampling.method``, as the JAX round builds it."""
    method = config.sampling.method
    kwargs = dict(self_cond=config.model.self_cond, cond_process_fn=get_self_cond_fn(config),
                  sampling_temperature=sampling_temperature)
    time_steps = make_time_steps(noise_scheduler, config.sampling.steps, 1e-3)
    if method == "ancestral":
        return AncestralSampler(noise_scheduler, time_steps, config.model.pred_data, **kwargs)
    if method in ("dpm_solver", "dpm_solver_sde"):
        return DPMSolverPP(noise_scheduler, time_steps, config.model.pred_data,
                           stochastic=method == "dpm_solver_sde", **kwargs)
    raise ValueError(f"unknown sampling.method {method!r}")


@torch.no_grad()
def sample_round(model, sampler, config, inverse_scaler, specs, n_nodes: torch.Tensor,
                 n_pad: int, generator):
    """One batched reverse diffusion: draw ``d`` conditioned on row ``d`` of
    the spectra ``specs`` (``[B, L]`` tensors in the order uv, ir, raman,
    those the model reads) at ``n_nodes[d]`` atoms, padded to ``n_pad``.
    Returns ``post_process``'s ``(pos, one_hot, fc, edge_types)`` on the
    device."""
    batch = n_nodes.shape[0]
    node_mask, edge_mask = M.build_masks(n_nodes, n_pad)
    node_nf = config.data.atom_types + 1  # atom types, formal charge
    z = M.sample_combined_position_feature_noise(generator, batch, n_pad, node_nf, node_mask)
    edge_z = M.sample_symmetric_edge_feature_noise(
        generator, batch, n_pad, config.model.edge_ch, edge_mask
    )
    ctx = model.encode_context(specs)
    x, edge_x = sampler.sampling(model, generator, z, node_mask, edge_mask, edge_z, ctx)
    return post_process(x, config.data.atom_types, node_mask, inverse_scaler, edge_x, edge_mask)


def bucket_sizes_of(config, pad_to_max: bool = False) -> Tuple[int, ...]:
    """``eval.bucket_sizes`` sorted, or ``(data.max_node,)`` without buckets.
    The largest must cover ``data.max_node`` (the sweep, as the JAX
    harness); with ``pad_to_max`` (serving, as the JAX ``Elucidator``)
    ``data.max_node`` is the fallback pad of counts past the largest."""
    max_n = int(config.data.max_node)
    buckets = tuple(sorted(int(b) for b in config.eval.bucket_sizes)) or (max_n,)
    if buckets[-1] < max_n:
        if pad_to_max:
            return buckets + (max_n,)
        raise ValueError(f"eval.bucket_sizes {buckets} must cover data.max_node {max_n} "
                         "(largest bucket is the fallback pad)")
    return buckets


def bucket_for(bucket_sizes, n_atoms: int) -> int:
    """The smallest of the sorted ``bucket_sizes`` that holds ``n_atoms``."""
    return int(bucket_sizes[int(np.searchsorted(bucket_sizes, n_atoms))])


def plan_rounds(ds, n_samples: int, batch_size: int, bucket_sizes) -> Tuple[np.ndarray, List]:
    """``(drawn, [(sel, n_pad), ...])``: ``drawn[p]`` is the split row of
    draw position ``p``; each round holds ``batch_size`` positions ``sel``
    at ``n_pad``."""
    n = len(ds)
    perm = np.random.default_rng(EVAL_PERMUTATION_SEED).permutation(n)
    total = int(math.ceil(n_samples / batch_size)) * batch_size
    drawn = perm[np.arange(total) % n]
    drawn_sizes = ds.arrays["num_atom"][ds.indices[drawn]]
    order = np.argsort(drawn_sizes, kind="stable")
    rounds = []
    for start in range(0, total, batch_size):
        sel = order[start : start + batch_size]
        rounds.append((sel, bucket_for(bucket_sizes, drawn_sizes[sel].max())))
    return drawn, rounds


def make_cond_sampling_fn(config, model, noise_scheduler, batch_size: int, n_samples: int,
                          inverse_scaler, ds, device, sampling_temperature: float = 1.0):
    """Returns ``sampling_fn(generator) -> (pred_mols, gt_pos, gt_mols)``,
    each in draw order: decoded ``(pos, atom_type, edge_type, fc)`` tuples,
    the targets' positions and their ground-truth tuples. The round plan
    (the same every call) is ``sampling_fn.rounds``, ``[(draws, n_pad),
    ...]``; the last call's seconds a round, ``[(sampling, decode), ...]``,
    are ``sampling_fn.round_seconds``."""
    sampler = make_sampler(config, noise_scheduler, sampling_temperature)
    spectra_keys = SPECTRA_KEYS[config.data.spectra_version]
    drawn, rounds = plan_rounds(ds, n_samples, batch_size, bucket_sizes_of(config))
    cuda = torch.device(device).type == "cuda"

    def sampling_fn(generator):
        total = len(drawn)
        sampling_fn.round_seconds = []
        processed: List = [None] * total
        gt_pos: List = [None] * total
        gt_mols: List = [None] * total
        n_generated = 0
        for sel, n_pad in rounds:
            data = ds.take(drawn[sel])
            data = {
                k: (v[:, :n_pad] if k in ("positions", "atom_type", "formal_charges")
                    else v[:, :n_pad, :n_pad] if k == "edge_type" else v)
                for k, v in data.items()
            }
            specs = [torch.from_numpy(data[k]).to(device) for k in spectra_keys]
            n_nodes = torch.from_numpy(data["num_atom"]).to(device)
            t0 = time.perf_counter()
            pos, one_hot, fc, edge_types = sample_round(
                model, sampler, config, inverse_scaler, specs, n_nodes, n_pad, generator)
            if cuda:
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            mols = mol_process(one_hot, pos, fc, data["num_atom"], edge_types)
            sampling_fn.round_seconds.append((t1 - t0, time.perf_counter() - t1))
            n_generated += len(sel)
            logging.info("Generate %d, Total %d.", n_generated, n_samples)
            for i, dst in enumerate(sel):
                dst = int(dst)
                processed[dst] = mols[i]
                na = int(data["num_atom"][i])
                gt_pos[dst] = np.asarray(data["positions"][i][:na])
                gt_mols[dst] = (
                    np.asarray(data["positions"][i][:na]),
                    np.asarray(data["atom_type"][i][:na]),
                    np.asarray(data["edge_type"][i][:na, :na]),
                    np.asarray(data["formal_charges"][i][:na, 0]).astype(np.int64),
                )
        return processed[:n_samples], gt_pos[:n_samples], gt_mols[:n_samples]

    sampling_fn.rounds = [(len(sel), n_pad) for sel, n_pad in rounds]
    sampling_fn.round_seconds = []
    return sampling_fn
