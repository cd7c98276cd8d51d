"""Data-parallel training and the sweep's fan-out over ranks, each rank a
process of its own on the CPU over gloo (``parallel.launch.spawn_ranks``:
the ``spawn`` method, a file rendezvous, every rank joined under a time
limit and killed past it, so a hung collective fails its test). The ranks
run ``tests/torch_mesh_workers.py``, which imports no JAX.

- The step: two ranks of ``make_parallel_train_step`` against JAX's
  ``make_parallel_train_step(get_step_fn(..., axis_name="data"))`` over
  ``create_mesh(2)`` on one state (``test_torch_train.py``'s small DMT,
  f32), after one step (the two shards' self-conditioning coins agreeing,
  and disagreeing) and after three; rank ``d`` takes
  ``jax_draws(fold_in(key, d), shard_d)``. Tolerances are
  ``test_torch_train.py``'s (``_compare_states``; the loss within 2e-5
  relative), and the ranks equal each other bit for bit. At world size 1
  in a gloo group the step equals the one-process step bit for bit.
- World size 1: ``run_lib.train`` gives the losses and state of the loop
  as one process ran it (its seeds, iterators and plain step), bit for
  bit, on both input paths.
- ``run_lib.train`` over two ranks, bucketed, all three spectra, on the
  device store and on the host iterator: equal losses and states on both
  ranks, moved from the start; checkpoints, export and xyz files written
  by rank 0 alone; a NaN loss on one rank raises on both at the same
  step.
- The sweep over two ranks: the same figures on both; each rank's
  molecules at every draw position of its rows equal to a one-process
  ``sample_round`` of those rows with that rank's generator, in draw
  order; the molecules pickled by rank 0 alone.
- ``main.py --mode train`` and ``tools/eval_sweep.py`` under two ranks.
- ``spawn_ranks`` itself: a rank that raises while the other waits for it
  in a collective fails the call at once with that rank's traceback, and
  ranks past the time limit are killed and the call raises.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffspectra_tpu.diffusion import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.parallel import create_mesh as jax_create_mesh
from diffspectra_tpu.parallel import make_parallel_train_step as jax_parallel_step
from diffspectra_tpu.parallel import replicate as jax_replicate
from diffspectra_tpu.parallel import shard_batch as jax_shard_batch
from diffspectra_tpu.training.step import get_step_fn as jax_step_fn
from diffspectra_tpu.utils.scalers import get_data_scaler as jax_data_scaler
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data import device_store
from diffspectra_tpu_torch.data.pipeline import augment_positions, get_dataset, inf_iterator
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.parallel import rank_seed
from diffspectra_tpu_torch.parallel.launch import spawn_ranks
from diffspectra_tpu_torch.sampling.decode import mol_process
from diffspectra_tpu_torch.sampling.harness import (
    bucket_sizes_of, make_sampler, plan_rounds, sample_round)
from diffspectra_tpu_torch.training import optim
from diffspectra_tpu_torch.training.losses import draw
from diffspectra_tpu_torch.training.step import get_step_fn
from diffspectra_tpu_torch.utils.registry import create_model
from diffspectra_tpu_torch.utils.scalers import get_data_inverse_scaler, get_data_scaler
from diffspectra_tpu_torch.warm_state import load_model_state, random_variables
from test_torch_train import (
    _batch, _compare_states, _configs, _jax_batch, _jax_state, _port_batch, _port_state,
    jax_draws)

import torch_mesh_workers as workers

torch.set_num_threads(2)
RANK_TIMEOUT = 120  # seconds a spawned run may take before its ranks are killed

# the two-rank runs: the smoke DMT narrowed, all three spectra (a tuple
# context), buckets, dropout on, a snapshot of 4 draws (2 a rank) at the last step
RUN = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.synthetic_size": 96,
       "data.spectra_version": "allspectra", "data.bucket_sizes": (10, 16),
       "training.batch_size": 8, "training.n_iters": 4, "training.log_freq": 1,
       "training.snapshot_freq": 4, "training.snapshot_freq_for_preemption": 2,
       "training.eval_samples": 4, "training.eval_batch_size": 4, "sampling.steps": 3,
       "model.dropout": 0.1}


@pytest.fixture(scope="module")
def jax_parallel():
    """JAX's two-device shard_map train step on the small DMT, compiled once,
    with the state and the global batch of 4 graphs (2 a device)."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    jcfg, pcfg = _configs()
    batch = _batch(1)
    model, tx, jstate = _jax_state(jcfg, batch)
    mesh = jax_create_mesh(2)
    step = jax_parallel_step(jax_step_fn(JaxSchedule(jcfg.sde.schedule), model, tx,
                                         jax_data_scaler(jcfg), jcfg, train=True,
                                         axis_name="data"), mesh)
    yield dict(jcfg=jcfg, pcfg=pcfg, batch=batch, jstate=jstate, step=step, mesh=mesh)
    jax.config.update("jax_default_prng_impl", prev)


def _shard_draws(key, batch, jcfg):
    """Each device's draws of JAX's axis-aware step for the step key ``key``."""
    half = batch["atom_mask"].shape[0] // 2
    return [jax_draws(jax.random.fold_in(key, d), {k: v[d * half:(d + 1) * half]
                                                   for k, v in batch.items()}, jcfg)
            for d in range(2)]


def _keys(case, batch, jcfg):
    """Step keys whose two shards' self-conditioning coins agree
    ("agree"), disagree ("disagree"), or three in a row taking both."""
    found = {"agree": [], "disagree": []}
    for i in range(200):
        key = jax.random.PRNGKey(1000 + i)
        a, b = (d["use_sc"] for d in _shard_draws(key, batch, jcfg))
        found["agree" if a == b else "disagree"].append(key)
    if case == "three":
        return [found["agree"][0], found["disagree"][0], found["agree"][1]]
    return [found[case][0]]


def _save_state(pcfg, jstate, tmp_path):
    _, state = _port_state(pcfg, jstate)
    path = str(tmp_path / "state.pt")
    torch.save(state, path)
    return path


def _assert_equal_tensors(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["agree", "disagree", "three"])
def test_two_rank_step_matches_jax_shard_map(jax_parallel, case, tmp_path):
    jcfg, pcfg, batch, jstate = (jax_parallel[k] for k in ("jcfg", "pcfg", "batch", "jstate"))
    keys = _keys(case, batch, jcfg)
    draws = [[], []]
    want_losses = []
    # a copy: the step donates the state it is given
    state = jax_replicate(jax_parallel["mesh"], jax.tree_util.tree_map(jnp.copy, jstate))
    sharded = jax_shard_batch(jax_parallel["mesh"], _jax_batch(batch))
    for key in keys:
        for d, own in enumerate(_shard_draws(key, batch, jcfg)):
            draws[d].append(own)
        state, loss = jax_parallel["step"](state, sharded, key)
        want_losses.append(float(loss))
    out = spawn_ranks(workers.parallel_steps, 2, "cpu", RANK_TIMEOUT,
                      args=(_save_state(pcfg, jstate, tmp_path), pcfg, _port_batch(batch), draws))
    lr_sum = sum(optim.lr_at(pcfg, i) for i in range(len(keys)))
    for rank in out:
        np.testing.assert_allclose(rank["losses"], want_losses, rtol=2e-5)
        _compare_states(rank["state"], state, lr_sum)
    assert out[0]["losses"] == out[1]["losses"]
    _assert_equal_tensors(workers.state_tensors(out[0]["state"]),
                          workers.state_tensors(out[1]["state"]))


def test_world_one_group_step_is_the_one_process_step(jax_parallel, tmp_path):
    """A gloo group of one rank runs the collectives; the result is the
    plain step's, bit for bit."""
    jcfg, pcfg, batch, jstate = (jax_parallel[k] for k in ("jcfg", "pcfg", "batch", "jstate"))
    keys = _keys("three", batch, jcfg)
    draws = [[jax_draws(key, batch, jcfg) for key in keys]]
    (got,) = spawn_ranks(workers.parallel_steps, 1, "cpu", RANK_TIMEOUT,
                         args=(_save_state(pcfg, jstate, tmp_path), pcfg, _port_batch(batch),
                               draws))
    with_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the rank's
    try:
        _, state = _port_state(pcfg, jstate)
        step = get_step_fn(NoiseScheduleVP(pcfg.sde.schedule), optim.get_optimizer(pcfg),
                           get_data_scaler(pcfg), pcfg)
        losses = [step(state, _port_batch(batch), own)[1].item() for own in draws[0]]
    finally:
        torch.set_num_threads(with_threads)
    assert got["losses"] == losses
    _assert_equal_tensors(workers.state_tensors(got["state"]), workers.state_tensors(state))


def _one_process_loop(config, store_path):
    """The train loop as one process ran it before the mesh: ``config.seed``
    on both generators, the unsharded store's or the host iterator's
    batches, augmentation, draws and the plain step. Returns the losses
    and the state."""
    from diffspectra_tpu_torch.data.pipeline import get_batch_iterator

    device = torch.device("cpu")
    config = configs.resolve_runtime_config(config, 1)
    _, train_ds, _, _, _ = get_dataset(config)
    tx, state = run_lib.init_train_state(config, device)
    step_fn = get_step_fn(NoiseScheduleVP.from_config(config), tx, get_data_scaler(config), config)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    host_generator = torch.Generator().manual_seed(config.seed)
    t, buckets = config.training, tuple(config.data.bucket_sizes)
    if store_path:
        store = device_store.DeviceStore(train_ds, config.data.spectra_version, device)
        idx_iter = inf_iterator(lambda epoch: device_store.index_iterator(
            len(store), t.batch_size, shuffle=True, seed=config.seed + epoch, drop_last=True,
            bucket_sizes=buckets, num_atom=store.host_num_atom))

        def next_batch():
            n_pad, idx = next(idx_iter)
            return device_store.build_batch(
                store.arrays, torch.from_numpy(idx), n_pad=n_pad,
                atom_types=config.data.atom_types, include_aromatic=config.data.include_aromatic,
                spectra_keys=store.spectra_keys)
    else:
        it = inf_iterator(lambda epoch: get_batch_iterator(
            train_ds, t.batch_size, config.data.spectra_version, shuffle=True,
            seed=config.seed + epoch, drop_last=True, bucket_sizes=buckets))

        def next_batch():
            return run_lib.batch_to_device(next(it), device)

    losses = []
    for _ in range(t.n_iters + 1):
        batch = next_batch()
        batch["positions"] = augment_positions(generator, batch["positions"], batch["atom_mask"],
                                               True, True, config.data.aug_translation_scale)
        draws = draw(generator, host_generator, batch, len(state.model.blocks),
                     config.model.include_fc_charge, config.only_2D, config.pred_edge)
        state, loss = step_fn(state, batch, draws)
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("store_path", [True, False])
def test_world_one_train_is_the_one_process_loop(store_path, tmp_path):
    over = {**RUN, "training.snapshot_sampling": False, "data.device_resident": store_path}
    lines = workers._StepLines()
    import logging

    root, level = logging.getLogger(), logging.getLogger().level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    try:
        state = run_lib.train(configs.apply_overrides(configs.get_smoke_config(), over),
                              str(tmp_path), "cpu")
    finally:
        root.removeHandler(lines)
        root.setLevel(level)
    losses, want = _one_process_loop(configs.apply_overrides(configs.get_smoke_config(), over),
                                     store_path)
    assert [float(f"{x:.5e}") for x in losses] == lines.losses
    _assert_equal_tensors(workers.state_tensors(state), workers.state_tensors(want))


@pytest.mark.parametrize("store_path", [True, False])
def test_two_rank_train(store_path, tmp_path):
    over = {**RUN, "data.device_resident": store_path}
    out = spawn_ranks(workers.train_rank, 2, "cpu", RANK_TIMEOUT, args=(over, str(tmp_path)))
    first, second = out
    assert first["raised"] is None and second["raised"] is None
    assert len(first["losses"]) == RUN["training.n_iters"] + 1
    assert all(np.isfinite(first["losses"]))
    assert first["losses"] == second["losses"]
    assert first["step"] == second["step"] == RUN["training.n_iters"] + 1
    _assert_equal_tensors(first["state"], second["state"])
    # moved from the fresh init
    _, fresh = run_lib.init_train_state(configs.apply_overrides(configs.get_smoke_config(), over),
                                        torch.device("cpu"))
    fresh = workers.state_tensors(fresh)
    assert not all(torch.equal(first["state"][k], v) for k, v in fresh.items()
                   if k.startswith("model/"))
    # rank 0 alone writes: the preemption checkpoint at steps 2 and 4, the
    # numbered one at 4, the export, the samples' and targets' xyz files
    assert first["writes"] == {"save_checkpoint": 3, "export_warm_state": 1, "visualize_mols": 2}
    assert second["writes"] == {}
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1"]
    assert os.path.exists(tmp_path / "warm_state.npz")
    assert os.path.exists(tmp_path / "samples" / "iter_4.json")


def test_two_rank_train_stops_on_both_ranks_at_a_nan(tmp_path):
    over = {**RUN, "training.snapshot_sampling": False}
    out = spawn_ranks(workers.train_rank, 2, "cpu", RANK_TIMEOUT,
                      args=(over, str(tmp_path), 2))
    assert out[0]["raised"] == out[1]["raised"] == 2
    assert np.isnan(out[0]["losses"][-1]) and np.isnan(out[1]["losses"][-1])
    assert all(np.isfinite(out[0]["losses"][:-1]))


SWEEP = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.synthetic_size": 64,
         "eval.num_samples": 6, "eval.batch_size": 4, "eval.num_candidates": 2,
         "eval.bucket_sizes": (12, 16), "sampling.steps": 3, "eval.save_mols": "true"}


def test_two_rank_sweep(tmp_path):
    out = spawn_ranks(workers.sweep_rank, 2, "cpu", RANK_TIMEOUT,
                      args=(SWEEP, str(tmp_path / "eval")))
    # the figures but the ranks' own timings (NaN equal to NaN)
    same = [json.dumps({k: v for k, v in rank["figures"].items()
                        if k not in ("sweeps", "phase_seconds")}, sort_keys=True) for rank in out]
    assert same[0] == same[1]
    assert [s["decoded"] for s in out[0]["figures"]["sweeps"]] == [6, 6]
    for key in ("top1_2d", "top1_3d", "topk_2d", "consensus_2d"):
        assert 0.0 <= out[0]["figures"][key] <= 1.0
    # one process: each rank's rows of each round, with that rank's generator
    config = configs.apply_overrides(configs.get_smoke_config(), SWEEP)
    model = create_model(config)
    load_model_state(model, random_variables(model, seed=0))
    model.eval()
    test_ds = get_dataset(config)[3]
    drawn, rounds = plan_rounds(test_ds, 6, 4, bucket_sizes_of(config))
    assert out[0]["figures"]["rounds"] == [(4, n_pad) for _, n_pad in rounds]
    sampler = make_sampler(config, NoiseScheduleVP.from_config(config))
    inverse = get_data_inverse_scaler(config)
    with_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks'
    try:
        for rank in range(2):
            generator = torch.Generator().manual_seed(rank_seed(config.seed, rank))
            for sweep in range(2):
                for sel, n_pad in rounds:
                    mine = sel[2 * rank:2 * rank + 2]
                    data = test_ds.take(drawn[mine])
                    n = data["num_atom"]
                    pos, one_hot, fc, edges = sample_round(
                        model, sampler, config, inverse, [torch.from_numpy(data["ir"])],
                        torch.from_numpy(n), n_pad, generator)
                    want = mol_process(one_hot, pos, fc, n, edges)
                    for dst, mol in zip(mine, want):
                        if dst >= 6:
                            continue
                        for got_rank in out:
                            got = got_rank["sweeps"][sweep][dst]
                            for g, w in zip(got, mol):
                                np.testing.assert_array_equal(g, w)
    finally:
        torch.set_num_threads(with_threads)
    # the pickles of eval.save_mols: rank 0's alone
    assert (out[0]["writes"], out[1]["writes"]) == ({"save_molecules": 1}, {})
    assert "molecules_ckpt_random" in out[0]["files"]


def test_command_lines_under_two_ranks(tmp_path):
    workdir = str(tmp_path / "train")
    argv = ["--mode", "train", "--smoke", "--device", "cpu", "--workdir", workdir,
            "--config", "model.nf=32", "--config", "model.n_layers=2",
            "--config", "model.n_heads=4", "--config", "training.n_iters=2",
            "--config", "training.snapshot_sampling=false", "--config", "data.synthetic_size=96"]
    out = spawn_ranks(workers.main_rank, 2, "cpu", RANK_TIMEOUT,
                      args=("diffspectra_tpu_torch.main", argv))
    assert out[0]["step"] == out[1]["step"] == 3
    assert os.path.exists(os.path.join(workdir, "stdout.txt"))
    sweep = ["--smoke", "--random-weights", "--device", "cpu", "--steps", "2",
             "--num-samples", "4", "--batch-size", "4", "--num-candidates", "1",
             "--synthetic-size", "64", "--workdir", str(tmp_path / "sweep")]
    spawn_ranks(workers.main_rank, 2, "cpu", RANK_TIMEOUT,
                args=("diffspectra_tpu_torch.tools.eval_sweep", sweep))
    with open(tmp_path / "sweep" / "eval_sweep.log") as f:
        log = f.read()
    assert "TOTAL EVAL WALL TIME" in log and "Generate 4, Total 4." in log


@pytest.mark.parametrize("case", ["raises", "hangs"])
def test_spawn_ranks_fails_fast_and_kills(case):
    import time

    t0 = time.monotonic()
    if case == "raises":
        with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank 1 fails before"):
            spawn_ranks(workers.fail_before_collective, 2, "cpu", RANK_TIMEOUT)
    else:
        with pytest.raises(RuntimeError, match="did not finish within 5 s"):
            spawn_ranks(workers.sleep_past_the_limit, 2, "cpu", 5, args=(RANK_TIMEOUT,))
    assert time.monotonic() - t0 < 60  # neither waits for the rank that never returns
