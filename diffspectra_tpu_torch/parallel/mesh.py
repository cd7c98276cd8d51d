"""Data parallelism over ``torch.distributed`` (port of
``diffspectra_tpu/parallel/mesh.py`` and ``run_lib._maybe_init_distributed``).

The JAX package runs one program over a 1-D ``data`` mesh of devices; the
port runs one process a device, joined in a process group: NCCL when the
device is cuda, gloo when it is the CPU. ``torchrun`` starts the processes
and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, which ``init_distributed`` reads:

    torchrun --nproc_per_node=8 -m diffspectra_tpu_torch.main --mode train --workdir W

A ``Mesh`` is this process's place in the group: ``(rank, world, device)``.
Batches split over the ranks on axis 0 (``shard_batch``), parameters and
optimizer state are replicated (``replicate`` once, then every rank takes
the same averaged update), and ``pmean_`` averages tensors over the ranks
with one ``all_reduce`` a dtype. Unlike JAX, which can take the first
``num_devices`` of ``jax.devices()``, the port cannot run on a subset of
its processes: ``training.num_devices`` must be 0 or the world size.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh(NamedTuple):
    rank: int
    world: int
    device: torch.device


def backend_for(device) -> str:
    """``nccl`` for a cuda device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None):
    """Join the process group that torchrun's variables describe; nothing at
    world size 1 (or when this process has joined one already). Without a
    ``device`` the process runs on ``cuda:LOCAL_RANK`` and makes it the
    current device. Returns the device to run on: ``device`` unchanged at
    world size 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return device
    if device is None:
        device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
        torch.cuda.set_device(device)
    device = resolve_device(device)
    dist.init_process_group(backend_for(device), init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    logging.info("torch.distributed initialised: rank %d of %d, %s on %s", dist.get_rank(),
                 world, backend_for(device), device)
    return device


def process_rank() -> int:
    """This process's rank in its process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def create_mesh(num_devices: int = 0, device=None) -> Mesh:
    """This process's ``Mesh``: rank and world size of the process group
    (0 and 1 without one) and ``device`` (cuda unless the caller asks for
    the CPU). ``num_devices`` 0 means the world size; another value than
    the world size raises."""
    device = resolve_device(device)
    joined = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if joined else (0, 1)
    if num_devices and num_devices != world:
        raise ValueError(
            f"training.num_devices is {num_devices} but the process group holds {world} "
            "processes: the port runs one process a device and cannot take a subset of "
            "them (set it to 0 or to the world size)")
    return Mesh(rank, world, device)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own draws: ``seed`` itself on rank 0, so
    that one process draws what it always drew, else a seed derived from
    ``(seed, rank)`` (the counterpart of ``jax.random.fold_in(key,
    axis_index)``)."""
    if rank == 0:
        return int(seed)
    words = np.random.SeedSequence([int(seed), int(rank)]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a batch (dicts, tuples and lists of arrays or
    tensors with the batch on axis 0): rows ``[rank B / world, (rank + 1)
    B / world)``, as ``P("data")`` splits axis 0. B must divide."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, rank, world) for v in batch)
    rows = batch.shape[0]
    if rows % world:
        raise ValueError(f"a batch of {rows} rows does not split over {world} ranks")
    per = rows // world
    return batch[rank * per:(rank + 1) * per]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (nothing at world size 1)."""
    if mesh.world > 1:
        dist.barrier()


def _by_dtype(tensors: List[torch.Tensor]) -> Dict[tuple, List[int]]:
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return groups


@torch.no_grad()
def _flat_(tensors: List[torch.Tensor], collective) -> None:
    """``collective(buffer)`` on the tensors of each dtype flattened into one
    buffer, the result copied back into them."""
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        collective(flat)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(piece.view(tensors[i].shape))


def pmean_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Average each tensor over the ranks, in place (``jax.lax.pmean``: the
    sum over the ranks, divided by their number), one ``all_reduce`` a
    dtype."""
    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(mesh.world)

    _flat_(tensors, mean)


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a train state: the model's parameters and persistent
    buffers (SpecFormer's batch statistics), the optimizer state's and the
    EMA's, in an order every rank shares."""
    found = list(state.model.state_dict(keep_vars=True).values())

    def walk(node):
        if isinstance(node, torch.Tensor):
            found.append(node)
        elif isinstance(node, dict):
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    walk(state.opt_state)
    walk(state.ema.shadow_params)
    return found


def replicate(state, mesh: Mesh):
    """Rank 0's train state on every rank: its parameters, buffers,
    optimizer state and EMA broadcast once, each dtype as one buffer, and
    the bf16 weight copies made anew (the counterpart of ``replicate``:
    every rank built the same state from the same seed or file already, so
    this makes sure of it). Nothing at world size 1."""
    from ..models.layers import refresh_casts

    if mesh.world > 1:
        _flat_(state_tensors(state), lambda flat: dist.broadcast(flat, src=0))
        refresh_casts(state.model)
    return state
