"""The port's train loop, checkpoints, warm-state export and warm start, and
its fresh init, on the CPU at small widths.

- Checkpoints: a save / restore round trip gives the state back exactly;
  a non-finite state is not saved; resume takes the preemption checkpoint,
  else the latest numbered one.
- ``export_warm_state``: the JAX package's ``load_warm_state`` reads a
  state the port trained (params, EMA and batch statistics equal to the
  port's rounded to bfloat16, step and EMA count exact), the port's
  ``Elucidator.from_warm_state`` serves from it, and the port's warm start
  restores it with a fresh optimizer.
- ``run_lib.train`` and ``main.py --mode train --smoke --device cpu`` (the
  smoke config cut to a few steps): finite losses on every log line,
  checkpoints, a snapshot's figures, the exported warm state; a resume runs
  on from the checkpoint; a non-finite loss stops the run.
- The snapshot writes ``mol_<i>.xyz`` of its sampled molecules to
  ``samples/iter_<step>`` and of their targets to ``iter_<step>_gt``, each
  file's lines as the JAX package's ``visualize_mols`` writes them for the
  same molecules.
- The fresh init against JAX's ``model.init``: the same leaves and shapes,
  the constant ones equal, each random one's standard deviation within 15%
  of JAX's (leaves of 1000 values or more).
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu import visualize as jax_visualize
from diffspectra_tpu import warm_state as jax_warm_state
from diffspectra_tpu.evaluation.molgraph import MolGraph as JaxMolGraph
from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.training import optim as jax_optim
from diffspectra_tpu.training.train_state import create_train_state as jax_create_train_state
from diffspectra_tpu_torch import checkpoint as ckpt
from diffspectra_tpu_torch import configs, main, run_lib
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.training.losses import draw
from diffspectra_tpu_torch.training.step import get_step_fn
from diffspectra_tpu_torch.utils.scalers import get_data_scaler
from diffspectra_tpu_torch.warm_state import (
    export_warm_state,
    flax_variables,
    init_variables,
    warm_start,
)

torch.set_num_threads(2)

SMALL = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
         "data.synthetic_size": 96, "optim.warmup": 2, "sampling.steps": 4,
         "training.batch_size": 4, "training.eval_batch_size": 4, "training.eval_samples": 4}


def _config(**overrides):
    return configs.apply_overrides(configs.get_smoke_config(), {**SMALL, **overrides})


def _trained(config, steps=3):
    """A train state after ``steps`` steps on one synthetic batch."""
    _, state = run_lib.init_train_state(config, torch.device("cpu"))
    _, train_ds, _, _, _ = run_lib.get_dataset(config)
    batch = run_lib.batch_to_device(next(run_lib.get_batch_iterator(
        train_ds, config.training.batch_size, config.data.spectra_version)), "cpu")
    step = get_step_fn(NoiseScheduleVP(config.sde.schedule), run_lib.get_optimizer(config),
                       get_data_scaler(config), config)
    gen, host = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    for _ in range(steps):
        state, _ = step(state, batch, draw(gen, host, batch, config.model.n_layers))
    return state


def _all_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ema.shadow_params.items()})
    for key in ("mu", "nu", "nu_max"):
        out.update({f"{key}.{k}": v for k, v in state.opt_state[key].items()})
    out["clip.queue"] = state.opt_state["clip"]["queue"]
    return out


def test_checkpoint_round_trip_and_resume(tmp_path):
    config = _config()
    state = _trained(config)
    workdir = str(tmp_path)
    ckpt.save_checkpoint(ckpt.numbered_checkpoint_dir(workdir, 2), state)
    assert ckpt.latest_numbered_checkpoint(workdir) == 2
    _, fresh = run_lib.init_train_state(config, torch.device("cpu"))
    restored = ckpt.restore_for_resume(workdir, fresh)  # no meta: the numbered one
    want, got = _all_tensors(state), _all_tensors(restored)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert restored.step == state.step == 3
    assert restored.ema.num_updates == state.ema.num_updates == 3
    for k in ("count", "lr_count"):
        assert restored.opt_state[k] == state.opt_state[k]
    assert restored.opt_state["clip"]["count"] == state.opt_state["clip"]["count"]

    # the preemption checkpoint wins over the numbered ones
    _trained_more = _trained(config, steps=1)
    ckpt.save_checkpoint(ckpt.meta_checkpoint_dir(workdir), _trained_more)
    _, fresh = run_lib.init_train_state(config, torch.device("cpu"))
    assert ckpt.restore_for_resume(workdir, fresh).step == 1
    # a non-finite state is refused and the file on disk kept
    with torch.no_grad():
        next(state.model.parameters()).view(-1)[0] = float("nan")
    assert not ckpt.state_is_finite(state)
    assert not ckpt.save_checkpoint_if_finite(ckpt.meta_checkpoint_dir(workdir), state)
    _, fresh = run_lib.init_train_state(config, torch.device("cpu"))
    assert ckpt.restore_for_resume(workdir, fresh).step == 1
    os.makedirs(os.path.join(workdir, "checkpoints", "checkpoint_9"))  # holds no state
    assert ckpt.latest_numbered_checkpoint(workdir) == 2


def _bf16(arr):
    return torch.tensor(arr).to(torch.bfloat16).float().numpy()


def test_exported_warm_state_loads_in_jax_and_serves(tmp_path):
    config = _config()
    state = _trained(config)
    path = str(tmp_path / "warm.npz")
    export_warm_state(state, path, meta={"spectra_version": "ir"})

    jcfg = jax_smoke.get_config()
    jcfg.model.nf, jcfg.model.n_layers, jcfg.model.n_heads = 32, 2, 4
    model = JaxDMT.from_config(jcfg)
    n = 8
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, n, 9)), jnp.ones((2, n, 1)),
        jnp.ones((2, n, n)), jnp.ones((2, 3501)), edge_x=jnp.zeros((2, n, n, 2)),
        noise_level=jnp.zeros((2,)))
    tx = jax_optim.get_optimizer(jcfg)
    restored = jax_warm_state.load_warm_state(
        jax_create_train_state(variables, tx, 0.999), path)
    assert int(restored.step) == 3 and int(restored.ema.num_updates) == 3
    want = flax_variables(state.model)
    shadow = flax_variables(state.model, state.ema.shadow_params)
    for tree, got in (("params", restored.params), ("batch_stats", restored.batch_stats),
                      ("ema", restored.ema.shadow_params)):
        flat = traverse_util.flatten_dict(jax.device_get(got), sep="/")
        ref = shadow if tree == "ema" else want
        prefix = "params" if tree == "ema" else tree
        assert {f"{prefix}/{p}" for p in flat} == {k for k in ref if k.startswith(prefix + "/")}
        for p, value in flat.items():
            np.testing.assert_array_equal(np.asarray(value), _bf16(ref[f"{prefix}/{p}"]),
                                          err_msg=p)

    el = Elucidator.from_warm_state(path, config=_config(), device="cpu")
    data = generate(seed=7, size=1, max_n=8, fidelity=4)
    n_atoms = int(data["num_atom"][0])
    result = el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=2, seed=0)
    assert sum(c.count for c in result.candidates) == 2
    assert all(np.isfinite(c.positions).all() for c in result.candidates)

    _, fresh = run_lib.init_train_state(config, torch.device("cpu"))
    fresh_opt = {k: v.clone() for k, v in fresh.opt_state["mu"].items()}
    warm = warm_start(fresh, path)
    assert warm.step == 3 and warm.ema.num_updates == 3 and warm.opt_state["count"] == 0
    assert all(torch.equal(warm.opt_state["mu"][k], v) for k, v in fresh_opt.items())
    got = flax_variables(warm.model)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], _bf16(v), err_msg=k)


def _loop_config(**overrides):
    return _config(**{"training.n_iters": 4, "training.log_freq": 1,
                      "training.snapshot_freq": 4, "training.snapshot_freq_for_preemption": 2,
                      **overrides})


def test_train_loop_writes_checkpoints_and_resumes(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    workdir = str(tmp_path)
    state = run_lib.train(_loop_config(), workdir, "cpu")
    assert state.step == 5  # steps 0..n_iters, as the JAX loop
    losses = [float(r.getMessage().split("training_loss: ")[1].split(",")[0])
              for r in caplog.records if "training_loss" in r.getMessage()]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert ckpt.latest_numbered_checkpoint(workdir) == 1
    assert os.path.exists(os.path.join(ckpt.meta_checkpoint_dir(workdir), ckpt.STATE_FILE))
    with open(os.path.join(workdir, "samples", "iter_4.json")) as f:
        figures = json.load(f)
    for dim in ("3D", "2D"):
        for key in ("atom_stable", "mol_stable", "Validity", "Complete"):
            assert 0.0 <= figures[dim][key] <= 1.0
    assert os.path.exists(os.path.join(workdir, "warm_state.npz"))
    resumed = run_lib.train(_loop_config(**{"training.n_iters": 6,
                                            "training.snapshot_sampling": False}), workdir, "cpu")
    assert resumed.step == 7  # from the checkpoint at step 4 (state step 5), steps 5 and 6


def test_snapshot_writes_the_molecule_files_as_jax(tmp_path, monkeypatch):
    seen = []
    real = run_lib.visualize_mols

    def record(mols, save_dir, max_mols=16):
        seen.append((list(mols), save_dir))
        return real(mols, save_dir, max_mols)

    monkeypatch.setattr(run_lib, "visualize_mols", record)
    workdir = str(tmp_path / "run")
    run_lib.train(_loop_config(**{"training.snapshot_freq_for_preemption": 100}), workdir, "cpu")
    samples = os.path.join(workdir, "samples")
    assert [d for _, d in seen] == [os.path.join(samples, "iter_4"),
                                    os.path.join(samples, "iter_4_gt")]
    for mols, save_dir in seen:
        names = sorted(os.listdir(save_dir))
        assert names == sorted(f"mol_{i}.xyz" for i in range(4)), names
        jax_dir = str(tmp_path / ("jax_" + os.path.basename(save_dir)))
        jax_visualize.visualize_mols(
            [JaxMolGraph(m.atom_syms, m.formal_charges, m.bond_orders, m.positions)
             for m in mols], jax_dir)
        assert sorted(os.listdir(jax_dir)) == names
        for name in names:
            with open(os.path.join(save_dir, name)) as f, open(os.path.join(jax_dir, name)) as g:
                got, want = f.read().splitlines(), g.read().splitlines()
            assert got == want and int(got[0]) == len(got) - 2 > 0


def test_non_finite_loss_stops_the_run(tmp_path, monkeypatch):
    real = run_lib.get_step_fn

    def nan_step(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda state, batch, draws: (step(state, batch, draws)[0], torch.tensor(float("nan")))

    monkeypatch.setattr(run_lib, "get_step_fn", nan_step)
    with pytest.raises(FloatingPointError, match="step 0"):
        run_lib.train(_loop_config(**{"training.snapshot_sampling": False}), str(tmp_path), "cpu")


def test_main_trains_the_smoke_config_on_the_cpu(tmp_path, monkeypatch):
    smoke = configs.get_smoke_config
    monkeypatch.setattr(configs, "get_smoke_config",
                        lambda: configs.apply_overrides(smoke(), {
                            **SMALL, "training.n_iters": 3, "training.snapshot_freq": 3}))
    workdir = str(tmp_path / "run")
    state = main.main(["--mode", "train", "--workdir", workdir, "--smoke", "--device", "cpu"])
    assert state.step == 4
    with open(os.path.join(workdir, "stdout.txt")) as f:
        log = f.read()
    assert "training_loss" in log and "3D atom stability" in log
    # the snapshot's molecule files, where the log once said they were skipped
    for sub in ("iter_3", "iter_3_gt"):
        assert os.listdir(os.path.join(workdir, "samples", sub))
    assert ckpt.latest_numbered_checkpoint(workdir) == 1


def test_entry_points_refuse_cuda_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lib.train(_loop_config(), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--mode", "train", "--workdir", str(tmp_path), "--smoke"])


def test_fresh_init_matches_flax_initializers():
    jcfg = jax_smoke.get_config()
    model = JaxDMT.from_config(jcfg)
    n = 16
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, n, 9)), jnp.ones((2, n, 1)),
        jnp.ones((2, n, n)), jnp.ones((2, 3501)), edge_x=jnp.zeros((2, n, n, 2)),
        noise_level=jnp.zeros((2,)))
    want = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    got = init_variables(DMT.from_config(configs.get_smoke_config()), seed=0)
    assert set(got) == set(want)
    for path, value in want.items():
        value = np.asarray(value)
        assert got[path].shape == value.shape, path
        if value.std() == 0:
            np.testing.assert_array_equal(got[path], value, err_msg=path)
        elif value.size >= 1000:
            assert abs(got[path].std() / value.std() - 1) < 0.15, path
            assert abs(got[path].mean() - value.mean()) < 0.15 * value.std() + 1e-3, path
