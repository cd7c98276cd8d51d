"""What the mesh tests run on each rank (``parallel.launch.spawn_ranks``).
A rank imports this module by name, so it imports torch and the port
alone: no rank imports JAX."""

import logging
import os

import torch

from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.parallel import make_parallel_train_step
from diffspectra_tpu_torch.training import optim
from diffspectra_tpu_torch.training.step import get_step_fn
from diffspectra_tpu_torch.utils.scalers import get_data_scaler


def state_tensors(state) -> dict:
    """A train state's tensors by name: the model's, the EMA's and the
    optimizer's moments."""
    out = {f"model/{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    out.update({f"ema/{k}": v.clone() for k, v in state.ema.shadow_params.items()})
    for key in ("mu", "nu", "nu_max"):
        out.update({f"{key}/{k}": v.clone() for k, v in state.opt_state.get(key, {}).items()})
    out["clip/queue"] = state.opt_state["clip"]["queue"].clone()
    return out


def parallel_steps(mesh, state_path, pcfg, batch, draws):
    """``len(draws[rank])`` steps of ``make_parallel_train_step`` from the
    saved state on the global ``batch``, this rank taking
    ``draws[rank][i]`` at step ``i``. Returns the losses and the state."""
    state = torch.load(state_path, weights_only=False)
    step_fn = get_step_fn(NoiseScheduleVP(pcfg.sde.schedule), optim.get_optimizer(pcfg),
                          get_data_scaler(pcfg), pcfg, mesh=mesh)
    step = make_parallel_train_step(step_fn, mesh)
    losses = []
    for own in draws[mesh.rank]:
        state, loss = step(state, batch, lambda shard, own=own: (shard, own))
        losses.append(loss.item())
    return {"losses": losses, "state": state}


class _StepLines(logging.Handler):
    """The losses of the train loop's step lines (rank 0's at INFO, the
    others' at DEBUG)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.losses = []

    def emit(self, record):
        msg = record.getMessage()
        if "training_loss" in msg:
            self.losses.append(float(msg.split("training_loss: ")[1].split(",")[0]))


def _count_calls(module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)


def train_rank(mesh, overrides, workdir, nan_at_step=None):
    """``run_lib.train`` on this rank's CPU. Returns the losses, the state's
    tensors, the file writes this rank made (checkpoints, export, xyz
    files), and the step at which it raised ``FloatingPointError`` (None
    where it did not). With ``nan_at_step``, rank 1's loss at that step is
    NaN."""
    from diffspectra_tpu_torch import checkpoint

    lines = _StepLines()
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    root.addHandler(lines)
    writes = {}
    _count_calls(checkpoint, "save_checkpoint", writes)
    _count_calls(run_lib, "export_warm_state", writes)
    _count_calls(run_lib, "visualize_mols", writes)
    if nan_at_step is not None and mesh.rank == 1:
        from diffspectra_tpu_torch.training import step as step_lib

        make = step_lib.make_loss_fn

        def poisoned(*args, **kwargs):
            loss_fn, calls = make(*args, **kwargs), []

            def nan_once(model, batch, draws):
                calls.append(1)
                loss = loss_fn(model, batch, draws)
                return loss * float("nan") if len(calls) == nan_at_step + 1 else loss

            return nan_once

        step_lib.make_loss_fn = poisoned
    config = configs.apply_overrides(configs.get_smoke_config(), overrides)
    try:
        state = run_lib.train(config, workdir, "cpu")
    except FloatingPointError:
        return {"losses": lines.losses, "raised": len(lines.losses) - 1, "writes": writes}
    return {"losses": lines.losses, "raised": None, "writes": writes,
            "state": state_tensors(state), "step": state.step}


def sweep_rank(mesh, overrides, eval_dir, seed=0):
    """``run_lib.diffspectra_evaluate`` on this rank's CPU with the small
    model's random weights from ``seed``; returns the figures, what each
    sweep's sampling function returned on this rank, and the molecule
    pickles it wrote."""
    from diffspectra_tpu_torch.utils.registry import create_model
    from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

    config = configs.apply_overrides(configs.get_smoke_config(), overrides)
    model = create_model(config)
    load_model_state(model, random_variables(model, seed=seed))
    sweeps, writes = [], {}
    _count_calls(run_lib, "save_molecules", writes)
    make = run_lib.make_cond_sampling_fn

    def recorded(*args, **kwargs):
        fn = make(*args, **kwargs)

        def sampling_fn(generator):
            out = fn(generator)
            sampling_fn.round_seconds = fn.round_seconds
            sweeps.append(out[0])
            return out

        sampling_fn.rounds = fn.rounds
        return sampling_fn

    run_lib.make_cond_sampling_fn = recorded
    figures = run_lib.diffspectra_evaluate(config, model.eval(), eval_dir, "cpu", "random")
    return {"figures": figures, "sweeps": sweeps, "writes": writes,
            "files": sorted(os.listdir(eval_dir))}


def main_rank(mesh, module, argv):
    """A command line's ``main(argv)`` on this rank (``diffspectra_tpu_torch.main``
    or ``.tools.eval_sweep``)."""
    import importlib

    out = importlib.import_module(module).main(argv)
    return {"step": getattr(out, "step", None)}


def fail_before_collective(mesh):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank 1 fails before the collective")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def sleep_past_the_limit(mesh, seconds):
    """Every rank outlasts the caller's time limit."""
    import time

    time.sleep(seconds)
