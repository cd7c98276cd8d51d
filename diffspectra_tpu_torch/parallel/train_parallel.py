"""Data-parallel train steps over the ranks (port of
``diffspectra_tpu/parallel/train_parallel.py`` and of
``data/device_store.py::make_sharded_store_step``).

Both wrap a step built by ``training.step.get_step_fn(..., mesh=mesh)``,
which averages the gradients, the loss and SpecFormer's batch statistics
over the ranks before the replicated update, for one of the two input
paths:

- ``make_parallel_train_step``: the host iterator's global batch, of which
  each rank keeps its own rows (``shard_batch``), as ``shard_map`` hands
  each chip its block of a batch sharded on axis 0;
- ``make_parallel_store_step``: the global index vector of the sharded
  iterators, of which each rank takes its block (``global_index_array``)
  and gathers the rows from its own shard of the device store.

``prepare(batch) -> (batch, draws)`` does what the JAX step does with its
key: augments the positions and draws the noise, the self-conditioning coin
and the dropout seeds, from this rank's own generators.

``torch.nn.parallel.DistributedDataParallel`` does not fit: its reducer
fires on ``.backward()``, and the step takes its gradients with
``torch.autograd.grad``.
"""

from __future__ import annotations

import torch

from ..data.device_store import build_batch, global_index_array
from .mesh import Mesh, shard_batch


def make_parallel_train_step(step_fn, mesh: Mesh):
    """``step(state, batch, prepare) -> (state, loss)`` with ``batch`` the
    global batch and ``prepare`` taking this rank's rows."""

    def step(state, batch, prepare):
        return step_fn(state, *prepare(shard_batch(batch, mesh.rank, mesh.world)))

    return step


def make_parallel_store_step(step_fn, mesh: Mesh, arrays, **batch_kwargs):
    """``step(state, idx, n_pad, prepare) -> (state, loss)`` with ``idx``
    the global index vector (block r: offsets into rank r's shard of
    ``arrays``) and ``n_pad`` its bucket; ``batch_kwargs`` go to
    ``build_batch``."""

    def step(state, idx, n_pad, prepare):
        local = torch.from_numpy(global_index_array(idx, mesh.rank, mesh.world)).to(mesh.device)
        return step_fn(state, *prepare(build_batch(arrays, local, n_pad=n_pad, **batch_kwargs)))

    return step
