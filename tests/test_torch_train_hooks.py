"""The train loop's profile hook and the evaluation over numbered
checkpoints (``run_lib``), on the CPU at a tiny size.

- ``training.profile`` writes a ``torch.profiler`` trace of steps
  ``[init+10, init+15)`` to ``<workdir>/profile``, and none without it.
- ``evaluate_checkpoints`` sweeps each checkpoint ``eval.ckpts`` names (or
  ``eval.begin_ckpt`` ... ``eval.end_ckpt``), one set of figures a
  checkpoint, named by it; a missing one raises ``FileNotFoundError``;
  ``--mode eval`` runs the same loop.
"""

import json
import os

import pytest
import torch

from diffspectra_tpu_torch import configs, main, run_lib

torch.set_num_threads(2)
TINY = {"model.nf": 32, "model.n_layers": 1, "model.n_heads": 4, "data.synthetic_size": 96,
        "training.batch_size": 2, "training.log_freq": 1, "training.snapshot_sampling": False,
        "training.snapshot_freq_for_preemption": 100, "sampling.steps": 2,
        "eval.num_samples": 2, "eval.batch_size": 2}


def _config(**over):
    return configs.apply_overrides(configs.get_smoke_config(), {**TINY, **over})


def test_profile_hook_writes_a_trace(tmp_path):
    run_lib.train(_config(**{"training.n_iters": 15, "training.snapshot_freq": 100,
                             "training.profile": True}), str(tmp_path / "on"), "cpu")
    files = os.listdir(tmp_path / "on" / "profile")
    assert files == ["trace_step_15.json"], files
    with open(tmp_path / "on" / "profile" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::mm" in n or "aten::addmm" in n for n in names)
    run_lib.train(_config(**{"training.n_iters": 15, "training.snapshot_freq": 100}),
                  str(tmp_path / "off"), "cpu")
    assert not os.path.exists(tmp_path / "off" / "profile")


def test_eval_loop_over_numbered_checkpoints(tmp_path):
    workdir = str(tmp_path / "run")
    config = _config(**{"training.n_iters": 2, "training.snapshot_freq": 1})
    run_lib.train(config, workdir, "cpu")  # checkpoints 1 and 2
    for over in ({"eval.ckpts": "1,2"}, {"eval.begin_ckpt": 1, "eval.end_ckpt": 2}):
        figures = run_lib.evaluate_checkpoints(configs.apply_overrides(_config(), over),
                                               workdir, "eval_loop", "cpu")
        assert sorted(figures) == [1, 2]
        for ckpt, fig in figures.items():
            assert fig["targets"] == 2 and 0.0 <= fig["top1_2d"] <= 1.0
            with open(os.path.join(workdir, "eval_loop", f"figures_ckpt_{ckpt}.json")) as f:
                assert json.load(f)["targets"] == 2
    assert run_lib.checkpoints_to_evaluate(configs.get_config()) == [40]
    with pytest.raises(FileNotFoundError, match="checkpoint_3"):
        run_lib.evaluate_checkpoints(_config(**{"eval.ckpts": "1,3"}), workdir, "eval", "cpu")
    figures = main.main(["--mode", "eval", "--workdir", workdir, "--smoke", "--device", "cpu",
                         *[a for k, v in TINY.items() for a in ("--config", f"{k}={v}")],
                         "--config", "eval.ckpts=2"])
    assert sorted(figures) == [2]
    with pytest.raises(FileNotFoundError):
        main.main(["--mode", "eval", "--workdir", workdir, "--smoke", "--device", "cpu",
                   "--config", "eval.begin_ckpt=4", "--config", "eval.end_ckpt=4"])
