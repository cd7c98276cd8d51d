"""The port's one-command real-data run, ``diffspectra_tpu_torch/scripts/
real_data.sh``, end to end on the CPU: a rehearsal file of
``make_rehearsal_pt`` (256 molecules: below 130 its train splits are empty)
packed, trained on and evaluated through ``python -m
diffspectra_tpu_torch.main`` at a small model's widths given by
``TRAIN_FLAGS`` and ``EVAL_FLAGS`` with ``--device cpu``. The eval's figures
equal those of ``run_lib.train`` and ``run_lib.evaluate_checkpoints``
called in this process with the same config, and the script stops at its
first failing command.
"""

import json
import math
import os
import subprocess
import sys

import torch

from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.main import parse_overrides
from diffspectra_tpu_torch.tools import make_rehearsal_pt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "diffspectra_tpu_torch", "scripts", "real_data.sh")
MODEL = ["model.nf=32", "model.n_layers=2", "model.n_heads=4",
         "training.matmul_precision=float32"]
TRAIN = MODEL + ["training.batch_size=8", "training.n_iters=2", "training.snapshot_freq=2",
                 "training.snapshot_sampling=false", "training.log_freq=1", "optim.warmup=2"]
EVAL = MODEL + ["eval.num_samples=4", "eval.batch_size=4", "eval.num_candidates=1",
                "sampling.steps=3"]


def _flags(items):
    return " ".join(f"--config {item}" for item in items) + " --device cpu"


def _scores(figures) -> str:
    """A sweep's figures without its clock readings, as sorted JSON."""
    kept = {k: v for k, v in figures.items() if k != "phase_seconds"}
    kept["sweeps"] = [s["decoded"] for s in figures["sweeps"]]
    return json.dumps(kept, sort_keys=True)


def _run(tmp_path, data_root, workdir, **env):
    env = dict(os.environ, PYTHON=sys.executable,
               OMP_NUM_THREADS=str(torch.get_num_threads()), WORKDIR=workdir,
               DATA_ROOT=data_root, SPECTRA="ir", EVAL_CKPT="1", **env)
    return subprocess.run(["bash", SCRIPT], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)


def _config(items):
    # the script's own keys, then the flags'
    config = configs.get_config()
    base = ["data.synthetic=false", "data.spectra_version=ir"]
    return configs.apply_overrides(config, parse_overrides(config, base + items))


def test_real_data_script_matches_the_loop_in_process(tmp_path):
    data_root = str(tmp_path / "rehearsal")
    make_rehearsal_pt.main(["--size", "256", "--root", data_root])
    proc = _run(tmp_path, data_root, str(tmp_path / "run"),
                TRAIN_FLAGS=_flags(TRAIN), EVAL_FLAGS=_flags(EVAL))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    workdir = tmp_path / "run"
    assert os.path.exists(os.path.join(data_root, "packed", "atom_type.npy"))
    assert (workdir / "warm_state.npz").exists()
    with open(workdir / "stdout.txt") as f:
        losses = [float(line.split("training_loss: ")[1].split(",")[0])
                  for line in f if "training_loss" in line]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    with open(workdir / "eval" / "figures_ckpt_1.json") as f:
        script = json.load(f)

    root = [f"data.root={data_root}"]
    here = str(tmp_path / "here")
    run_lib.train(_config(root + TRAIN), here, "cpu")
    eval_config = _config(root + ["eval.ckpts=1", "eval.num_candidates=10"] + EVAL)
    figures = run_lib.evaluate_checkpoints(eval_config, here, "eval", "cpu")[1]
    assert _scores(script) == _scores(json.loads(json.dumps(figures)))
    assert script["sweeps"][0]["decoded"] == 4 and script["targets"] == 4


def test_real_data_script_stops_at_the_first_failure(tmp_path):
    # no dataset under DATA_ROOT: the train command fails and the eval never runs
    proc = _run(tmp_path, str(tmp_path / "nothing"), str(tmp_path / "run"),
                TRAIN_FLAGS=_flags(TRAIN), EVAL_FLAGS=_flags(EVAL))
    assert proc.returncode != 0 and "No QM9S data found" in proc.stderr
    assert not os.path.exists(tmp_path / "run" / "eval_stdout.txt")
