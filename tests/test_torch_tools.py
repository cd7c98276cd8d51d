"""The port's counterparts of the repository's tools (``tools/*.py``),
each held to the JAX tool on the same seeds on the CPU.

- ``make_rehearsal_pt`` at 128 molecules: both processed files, packed by
  each package's ``pack_from_pyg``, give equal arrays, and the split dicts
  are equal.
- ``ceiling_analysis``: ``estimate(384, seed=7)`` at fidelity 1, 2 and 4,
  and ``fingerprint_and_hash`` on ``tests/test_ceiling_tools.py``'s two
  skeletons, give JAX's outputs.
- ``protocol_ceiling`` and ``unseen_env_analysis`` at 512 molecules and
  ``f4_continuity`` at 20 print JAX's lines.
- ``gt_mmd_anchor`` at 512 molecules and 32 draws gives JAX's JSON within
  1e-5, relative or absolute (float32 kernel sums in another order, as
  ``Metric-Align``; the floor's MMDs lie near 0).
- ``export_warm_state`` on a 3-step workdir writes ``run_lib.train``'s own
  export tensor for tensor, which JAX's ``load_warm_state`` reads; an
  empty workdir returns 1.
- ``warm_to_ckpt``: ``evaluate_checkpoints`` on its workdir gives the
  figures of ``run_lib.evaluate`` on the warm state.
- The tools with a device refuse CUDA without CUDA.

The JAX tools write their synthetic sets under the repository's
``data/synthetic_cache``; the tests redirect them to a temporary directory,
which the port's tool then reads (the cache is one format in both
packages), and feed them their arguments and variables.
"""

import contextlib
import io
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu import warm_state as jax_warm_state
from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.data import qm9s as jax_qm9s
from diffspectra_tpu.data import synthetic as jax_synthetic
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.training import optim as jax_optim
from diffspectra_tpu.training.train_state import create_train_state as jax_create_train_state
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data import qm9s
from diffspectra_tpu_torch.tools import (
    ceiling_analysis,
    export_warm_state,
    f4_continuity,
    gt_mmd_anchor,
    make_rehearsal_pt,
    protocol_ceiling,
    unseen_env_analysis,
    warm_to_ckpt,
)
from diffspectra_tpu_torch.warm_state import read_warm_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.ceiling_analysis as jax_ceiling  # noqa: E402
import tools.f4_continuity as jax_f4  # noqa: E402
import tools.gt_mmd_anchor as jax_gt_mmd  # noqa: E402
import tools.make_rehearsal_pt as jax_rehearsal  # noqa: E402
import tools.protocol_ceiling as jax_protocol  # noqa: E402
import tools.unseen_env_analysis as jax_unseen  # noqa: E402

torch.set_num_threads(2)

# the small model of the train-loop tests, as --config items of the tools
SMALL = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.max_node": 8,
         "data.spectra_version": "ir", "training.matmul_precision": "float32"}
TRAIN = {"data.synthetic_size": 96, "optim.warmup": 2, "training.batch_size": 4,
         "training.n_iters": 2, "training.snapshot_freq": 2, "training.snapshot_sampling": False,
         "eval.num_samples": 4, "eval.batch_size": 4, "sampling.steps": 3}


def _items(overrides):
    return [f"--config={k}={v}" for k, v in overrides.items()]


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def _scores(figures) -> str:
    """A sweep's figures without its clock readings, as sorted JSON (NaN
    equal to NaN)."""
    kept = {k: v for k, v in figures.items() if k != "phase_seconds"}
    kept["sweeps"] = [s["decoded"] for s in figures["sweeps"]]
    return json.dumps(kept, sort_keys=True)


def _cached_generate(monkeypatch, module, cache):
    """Redirect ``module.generate`` (the JAX generator) to keep its sets in
    ``cache``."""
    plain = jax_synthetic.generate

    def generate(*args, **kwargs):
        return plain(*args, **{**kwargs, "cache_dir": str(cache)})

    monkeypatch.setattr(module, "generate", generate)


def test_make_rehearsal_pt_matches_jax(tmp_path, monkeypatch):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["make_rehearsal_pt.py", "128", str(jax_root)])
    jax_rehearsal.main()
    splits = make_rehearsal_pt.main(["--size", "128", "--root", str(port_root)])
    assert [len(s) for s in splits] == [0, 0, 64, 64]
    want_split = torch.load(jax_root / qm9s.SPLIT_FILE, weights_only=True)
    got_split = torch.load(port_root / qm9s.SPLIT_FILE, weights_only=True)
    assert set(got_split) == set(want_split) == set(qm9s.SPLIT_KEYS)
    for k in qm9s.SPLIT_KEYS:
        assert got_split[k].dtype == want_split[k].dtype
        assert torch.equal(got_split[k], want_split[k]), k
    shutil.copytree(port_root, tmp_path / "port_by_jax")
    want, want_splits = jax_qm9s.pack_from_pyg(str(jax_root), 29)
    for got, got_splits in (qm9s.pack_from_pyg(str(port_root), 29),
                            jax_qm9s.pack_from_pyg(str(tmp_path / "port_by_jax"), 29)):
        for k in qm9s.RAW_KEYS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for a, b in zip(got_splits, want_splits):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fidelity", [1, 2, 4])
def test_ceiling_estimate_matches_jax(fidelity):
    got = ceiling_analysis.estimate(384, seed=7, fidelity=fidelity)
    assert got == jax_ceiling.estimate(384, seed=7, fidelity=fidelity)
    assert 0.0 < got["top1_ceiling"] <= got["top10_ceiling"] <= 1.0 + 1e-12


def test_fingerprint_and_hash_matches_jax():
    # tests/test_ceiling_tools.py's two skeletons: equal bond-pattern counts,
    # different WL environments
    def build(edges, types, max_n=8):
        e = np.zeros((max_n, max_n), dtype=np.int64)
        for a, b in edges:
            e[a, b] = e[b, a] = 1
        t = np.zeros(max_n, dtype=np.int64)
        t[:len(types)] = types
        return t, e, len(types)

    pos = np.zeros((8, 3))
    for edges in ([(0, 1), (1, 2), (2, 3)], [(0, 1), (1, 2), (1, 3)]):
        t, e, n = build(edges, [1, 1, 1, 3])
        for fidelity, f4_bin in ((1, 1), (2, 1), (4, 1), (4, 8)):
            got = ceiling_analysis.fingerprint_and_hash(t, pos, e, n, fidelity, f4_bin)
            assert got == jax_ceiling.fingerprint_and_hash(t, pos, e, n, fidelity, f4_bin)


def test_ceiling_main_prints_its_table():
    printed, rows = _printed(ceiling_analysis.main, ["--fidelity", "2", "64"])
    lines = printed.splitlines()
    assert lines[0] == "fidelity=2 f4_bin=1" and len(lines) == 3
    assert lines[2].split()[:2] == ["64", str(rows[0]["n_classes"])]


def test_protocol_ceiling_matches_jax(tmp_path, monkeypatch):
    _cached_generate(monkeypatch, jax_protocol, tmp_path)
    monkeypatch.setattr(sys, "argv", ["protocol_ceiling.py", "512"])
    want, _ = _printed(jax_protocol.main)
    got, out = _printed(protocol_ceiling.main, ["--size", "512", "--cache-dir", str(tmp_path)])
    assert got == want and out["test"] == 51


def test_unseen_env_analysis_matches_jax(tmp_path, monkeypatch):
    _cached_generate(monkeypatch, jax_unseen, tmp_path)
    monkeypatch.setattr(sys, "argv", ["unseen_env_analysis.py", "512"])
    want, _ = _printed(jax_unseen.main)
    got, out = _printed(unseen_env_analysis.main, ["--size", "512", "--cache-dir", str(tmp_path)])
    assert got == want and out["unseen"] > 0


def test_f4_continuity_matches_jax(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["f4_continuity.py", "20"])
    want, _ = _printed(jax_f4.main)
    got, shifts = _printed(f4_continuity.main, ["--n-molecules", "20"])
    assert got == want and shifts["f4"]


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == pytest.approx(want, rel=tol, abs=tol), (got, want)


def test_gt_mmd_anchor_matches_jax(tmp_path, monkeypatch):
    _cached_generate(monkeypatch, jax_synthetic, tmp_path)  # the JAX tool imports it in main
    for key, value in (("SIZE", "512"), ("N_GEN", "32")):
        monkeypatch.setenv(key, value)
    printed, _ = _printed(jax_gt_mmd.main)
    json_line, ok = printed.strip().splitlines()[-2:]
    assert ok == "GT_MMD_ANCHOR OK"
    want = json.loads(json_line)
    printed, got = _printed(gt_mmd_anchor.main, ["--size", "512", "--n-gen", "32", "--cache-dir",
                                                  str(tmp_path), "--device", "cpu"])
    assert printed.strip().splitlines() == [json.dumps(got), "GT_MMD_ANCHOR OK"]
    # each MMD is xx/n^2 + yy/m^2 - 2 xy/nm, kernel sums of order 1 (each
    # of the first two in (0, 5] over 5 kernels), so float32 sums in another
    # order move an MMD near 0 by ~1e-7 of those sums: 1e-5 relative to the
    # MMD or absolute, as phase 13 of chip_smoke.py holds the MMD to 1e-5 x
    # (xx/n^2 + yy/m^2)
    _close(got, want, 1e-5)
    for stats in ("gt_vs_test_stats", "gt_vs_train_stats"):
        assert all(math.isfinite(v) and v >= 0 for v in got[stats].values()), got


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A workdir ``run_lib.train`` trained 3 steps (a checkpoint at the
    last), its config, and its own export ``warm_state.npz``."""
    workdir = str(tmp_path_factory.mktemp("trained"))
    config = configs.apply_overrides(configs.get_smoke_config(), {**SMALL, **TRAIN})
    assert run_lib.train(config, workdir, "cpu").step == 3
    return workdir, config, os.path.join(workdir, "warm_state.npz")


def _jax_restored(path):
    """The JAX package's ``load_warm_state`` of ``path`` into a fresh JAX
    train state of the small model."""
    jcfg = jax_smoke.get_config()
    jcfg.model.nf, jcfg.model.n_layers, jcfg.model.n_heads = 32, 2, 4
    n = 8
    # the tree's shapes without compiling the init: the load replaces every leaf
    shapes = jax.eval_shape(
        JaxDMT.from_config(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((2,)),
        jnp.zeros((2, n, 9)), jnp.ones((2, n, 1)), jnp.ones((2, n, n)), jnp.ones((2, 3501)),
        edge_x=jnp.zeros((2, n, n, 2)), noise_level=jnp.zeros((2,)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return jax_warm_state.load_warm_state(
        jax_create_train_state(variables, jax_optim.get_optimizer(jcfg), 0.999), path)


def test_export_warm_state_matches_the_trains_export(trained, tmp_path):
    workdir, _, train_export = trained
    out = str(tmp_path / "exported.npz")
    printed, rc = _printed(export_warm_state.main,
                           ["--workdir", workdir, "--out", out, "--device", "cpu", *_items(SMALL)])
    assert rc == 0 and printed.startswith("exported step 3 to")
    meta = json.loads(printed.strip().splitlines()[-1])
    assert meta == {"spectra_version": "ir", "synthetic_size": 32768, "step": 3,
                    "workdir": workdir}
    with np.load(out) as got, np.load(train_export) as want:
        assert set(got.files) == set(want.files)
        for k in want.files:
            if k != "__meta__":
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert read_warm_state(out)["meta"] == meta

    restored = _jax_restored(out)
    assert int(restored.step) == 3 and int(restored.ema.num_updates) == 3
    warm = read_warm_state(out)
    for tree, got in (("params", restored.params), ("batch_stats", restored.batch_stats),
                      ("ema", restored.ema.shadow_params)):
        prefix = "batch_stats" if tree == "batch_stats" else "params"
        flat = {f"{prefix}/{p}": v for p, v in
                traverse_util.flatten_dict(jax.device_get(got), sep="/").items()}
        assert set(flat) == set(warm[tree]), tree
        for p, value in flat.items():
            np.testing.assert_array_equal(np.asarray(value), warm[tree][p], err_msg=p)


def test_export_warm_state_without_checkpoint_returns_1(tmp_path):
    out = str(tmp_path / "none.npz")
    printed, rc = _printed(export_warm_state.main, ["--workdir", str(tmp_path / "empty"),
                                                    "--out", out, "--device", "cpu",
                                                    *_items(SMALL)])
    assert rc == 1 and printed.startswith("no checkpoint found in")
    assert not os.path.exists(out)


def test_warm_to_ckpt_evaluates_as_the_warm_state(trained, tmp_path):
    _, config, warm = trained
    workdir = str(tmp_path / "from_warm")
    printed, rc = _printed(warm_to_ckpt.main, ["--warm", warm, "--workdir", workdir,
                                               "--device", "cpu", *_items(SMALL)])
    assert rc == 0 and printed.strip() == "WARM_TO_CKPT OK ckpt=0 step=3"
    _, rc = _printed(warm_to_ckpt.main, ["--warm", warm, "--workdir", workdir, "--ckpt", "1",
                                         "--device", "cpu", *_items(SMALL)])
    # the checkpoint restores the warm state's EMA (rounded to bfloat16) and step
    from diffspectra_tpu_torch.api import restore_model
    from diffspectra_tpu_torch.warm_state import flax_variables

    model, step = restore_model(workdir, config, "cpu", ckpt=1)
    assert rc == 0 and step == 3
    ema = read_warm_state(warm)["ema"]
    got = flax_variables(model)
    for k, v in ema.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    eval_config = configs.apply_overrides(configs.get_smoke_config(), {
        **SMALL, **TRAIN, "eval.ckpts": "1"})
    by_ckpt = run_lib.evaluate_checkpoints(eval_config, workdir, "eval", "cpu")
    by_warm = run_lib.evaluate(eval_config, warm, str(tmp_path / "eval_warm"), "cpu")
    assert list(by_ckpt) == [1]
    assert _scores(by_ckpt[1]) == _scores(by_warm)
    assert by_ckpt[1]["sweeps"][0]["decoded"] == 4


def test_tools_refuse_cuda_without_cuda(trained, tmp_path, monkeypatch):
    workdir, _, warm = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, argv in (
            (export_warm_state, ["--workdir", workdir, "--out", str(tmp_path / "w.npz")]),
            (warm_to_ckpt, ["--warm", warm, "--workdir", str(tmp_path / "wd")]),
            (gt_mmd_anchor, ["--size", "16", "--n-gen", "2"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(argv)
    assert not os.listdir(tmp_path)
