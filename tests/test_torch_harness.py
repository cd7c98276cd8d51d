"""The port's evaluation sweep against the JAX package's, on the CPU.

- Data: ``get_dataset``'s four splits (indices) and every array of the
  dataset transform equal JAX's on the smoke config at size 64.
- The round plan: both harnesses run with their reverse diffusion replaced
  by one scripted fake (the JAX harness's ``jax.jit`` and the port's
  ``sample_round``, patched in this test only) that returns each drawn
  row's ground truth with seeded edits. The rows of each round, the
  ``n_pad`` sequence, the predictions and the ground truth must be equal,
  with no tolerance: ``num_samples`` not a multiple of the batch, over the
  split's size, no buckets, and buckets (8, 12, 16).
- The eval loop: the port's ``run_lib`` and JAX's ``run_lib.evaluate`` on the
  same scripted sweeps (JAX's checkpoint restore and model set-up patched
  out) log the same ``Metric-3D``, ``Metric-2D`` (the moses ``FCD`` and
  ``Filters`` lines among them), ``Metric-Align`` (with ``sub_geometry``),
  ``Top-K``, ``Consensus``, ``Generalization`` and similarity lines, text
  and figures (the ``phase-time`` lines and the port's line naming the
  train split are not compared).
- End to end: the sweep tool on the CPU at the smoke size with random
  weights (3 steps, 6 targets, K=2), and its refusal without CUDA.
"""

import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from diffspectra_tpu import run_lib as jax_run_lib
from diffspectra_tpu.configs import smoke
from diffspectra_tpu.data.pipeline import get_dataset as jax_get_dataset
from diffspectra_tpu.diffusion.schedule import NoiseScheduleVP as JaxSchedule
from diffspectra_tpu.sampling import harness as jax_harness
from diffspectra_tpu.utils.scalers import get_data_inverse_scaler as jax_inverse_scaler
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data.pipeline import get_dataset
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.sampling import harness
from diffspectra_tpu_torch.tools import eval_sweep
from diffspectra_tpu_torch.utils.scalers import get_data_inverse_scaler
from test_torch_dmt import ROOT

torch.set_num_threads(2)

SIZE = 64  # smoke config, 6 test targets


def _configs(max_node=16, buckets=(), **eval_keys):
    jcfg = smoke.get_config()
    jcfg.data.synthetic_size = SIZE
    jcfg.data.max_node = max_node
    jcfg.eval.bucket_sizes = buckets
    cfg = configs.apply_overrides(configs.get_smoke_config(), {
        "data.synthetic_size": SIZE, "data.max_node": max_node, "eval.bucket_sizes": buckets})
    for k, v in eval_keys.items():
        setattr(jcfg.eval, k, v)
        setattr(cfg.eval, k, v)
    return jcfg, cfg


def test_get_dataset_matches_jax():
    jcfg, cfg = _configs()
    want, got = jax_get_dataset(jcfg), get_dataset(cfg)
    assert got[4]["atom_decoder"] == want[4]["atom_decoder"]
    keys = ("atom_one_hot", "edge_one_hot", "positions", "formal_charges", "num_atom",
            "atom_type", "edge_type", "ir", "uv", "raman")
    assert set(got[0].arrays) == set(want[0].arrays) == set(keys)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.indices, w.indices)
    for k in keys:
        assert got[0].arrays[k].dtype == want[0].arrays[k].dtype, k
        np.testing.assert_array_equal(got[0].arrays[k], want[0].arrays[k])
    assert [len(s) for s in got[:4]] == [27, 28, 3, 6]


def _scripted(ds, rows, n_pad, call):
    """Round ``call``'s dense output for the split rows ``rows``: each row's
    ground truth with seeded edits (positions jittered, now and then an atom
    type, a bond order or a charge changed)."""
    rng = np.random.default_rng(call)
    idx = ds.indices[rows]
    at = ds.arrays["atom_type"][idx, :n_pad].copy()
    et = ds.arrays["edge_type"][idx, :n_pad, :n_pad].astype(np.float32)
    fc = ds.arrays["formal_charges"][idx, :n_pad].copy()
    pos = ds.arrays["positions"][idx, :n_pad] + rng.normal(0, 0.02, (len(rows), n_pad, 3))
    for d, n in enumerate(ds.arrays["num_atom"][idx]):
        edit = rng.integers(4)
        if edit == 1:
            at[d, rng.integers(n)] = rng.integers(5)
        elif edit == 2:
            i, j = rng.integers(n, size=2)
            et[d, i, j] = et[d, j, i] = float(rng.integers(4)) if i != j else 0.0
        elif edit == 3:
            fc[d, rng.integers(n), 0] = 1.0
    one_hot = np.eye(5, dtype=np.float32)[at]
    return pos.astype(np.float32), one_hot, fc, et


class _JaxJitProxy:
    """The ``jax`` module as the JAX harness sees it, with ``jit`` replaced."""

    def __init__(self, jit):
        self.jit = jit

    def __getattr__(self, name):
        return getattr(jax, name)


def _recording(ds, log):
    take = ds.take

    def recorded(rows):
        log.append(np.array(rows))
        return take(rows)

    ds.take = recorded
    return ds


def _run_both_harnesses(monkeypatch, n_samples, batch, max_node, buckets):
    jcfg, cfg = _configs(max_node, buckets)
    jds, ds = jax_get_dataset(jcfg)[3], get_dataset(cfg)[3]
    log = {"jax": [], "port": []}
    pads = {"jax": [], "port": []}

    def jax_round(variables, rng, context, n_nodes, n_pad):
        pads["jax"].append(n_pad)
        return _scripted(jds, log["jax"][-1], n_pad, len(pads["jax"]))

    def port_round(model, sampler, config, inverse_scaler, specs, n_nodes, n_pad, generator):
        pads["port"].append(n_pad)
        out = _scripted(ds, log["port"][-1], n_pad, len(pads["port"]))
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in out)

    monkeypatch.setattr(jax_harness, "jax", _JaxJitProxy(lambda fn, **kw: jax_round))
    monkeypatch.setattr(harness, "sample_round", port_round)
    want = jax_harness.make_cond_sampling_fn(
        jcfg, None, JaxSchedule("cosine"), batch, n_samples, jax_inverse_scaler(jcfg),
        _recording(jds, log["jax"]), fixed_seed=42)({}, jax.random.PRNGKey(0))
    got = harness.make_cond_sampling_fn(
        cfg, None, NoiseScheduleVP("cosine"), batch, n_samples, get_data_inverse_scaler(cfg),
        _recording(ds, log["port"]), torch.device("cpu"))(torch.Generator())
    return got, want, log, pads, ds


@pytest.mark.parametrize("n_samples,batch,max_node,buckets", [
    (5, 2, 16, ()),  # not a multiple of the batch
    (14, 4, 16, ()),  # over the split's 6 targets: the draw wraps around
    (6, 4, 16, (8, 12, 16)),
    (11, 3, 16, (12, 16)),
    (6, 6, 12, (8, 12)),
])
def test_round_plan_matches_jax(monkeypatch, n_samples, batch, max_node, buckets):
    got, want, log, pads, ds = _run_both_harnesses(monkeypatch, n_samples, batch, max_node,
                                                   buckets)
    assert len(log["port"]) == len(log["jax"]) == -(-n_samples // batch)
    for a, b in zip(log["port"], log["jax"]):
        np.testing.assert_array_equal(a, b)
    assert pads["port"] == pads["jax"]
    assert all(p in (buckets or (max_node,)) for p in pads["port"])
    plan = harness.plan_rounds(ds, n_samples, batch, harness.bucket_sizes_of(
        configs.apply_overrides(configs.get_smoke_config(), {
            "data.max_node": max_node, "eval.bucket_sizes": buckets})))
    assert [p for _, p in plan[1]] == pads["port"]
    for g_list, w_list in zip(got, want):  # predictions, gt positions, gt tuples
        assert len(g_list) == len(w_list) == n_samples
        for g, w in zip(g_list, w_list):
            if isinstance(w, tuple):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, np.asarray(b))
                    assert np.asarray(a).dtype == np.asarray(b).dtype
            else:
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- the eval loop

K = 3


def _scripted_sweeps(cfg):
    """K sweeps over the 6 test targets in draw order: predictions edited
    from the ground truth with seeded edits, sweep k from seed k."""
    _, _, _, test_ds, _ = get_dataset(cfg)
    drawn, _ = harness.plan_rounds(test_ds, 6, 6, (16,))
    rows = drawn[:6]
    idx = test_ds.indices[rows]
    a = test_ds.arrays
    gt = [(a["positions"][i][:n], a["atom_type"][i][:n], a["edge_type"][i][:n, :n],
           a["formal_charges"][i][:n, 0].astype(np.int64))
          for i, n in zip(idx, a["num_atom"][idx])]
    sweeps = []
    for k in range(K):
        pos, one_hot, fc, et = _scripted(test_ds, rows, 16, k)
        n = a["num_atom"][idx]
        preds = [(pos[d, :n[d]], one_hot[d, :n[d]].argmax(1), et[d, :n[d], :n[d]],
                  fc[d, :n[d], 0].astype(np.int64)) for d in range(6)]
        sweeps.append((preds, [g[0] for g in gt], gt))
    return sweeps


COMPARED = ("Metric-3D", "Metric-2D", "Metric-Align", "Top-", "Consensus", "Generalization",
            "3D ", "2D ")


def _compared_lines(records):
    lines = [r.getMessage() for r in records]
    return [m for m in lines if m.startswith(COMPARED) and "train split counted against" not in m]


def run_both_evals(monkeypatch, tmp_path, caplog, jcfg, cfg, jax_original=None, original=None):
    """JAX's ``run_lib.evaluate`` and the port's ``diffspectra_evaluate``
    on the same K scripted sweeps (JAX's model set-up and checkpoint
    restore patched out), JAX's reference config ``jax_original`` and the
    port's ``original``. Returns JAX's compared log lines, the port's, the
    port's figures, JAX's eval directory and the port's."""
    jcfg.training.num_devices = 1
    sweeps = _scripted_sweeps(cfg)

    calls = {"jax": 0, "port": 0}

    def jax_fn(variables, rng):
        calls["jax"] += 1
        return sweeps[calls["jax"] - 1]

    def port_fn(generator):
        calls["port"] += 1
        return sweeps[calls["port"] - 1]

    # the harness's round plan and timings, which the compared lines do not read
    port_fn.rounds, port_fn.round_seconds = [(6, 16)], [(0.0, 0.0)]

    workdir = str(tmp_path / "jax")
    os.makedirs(os.path.join(workdir, "checkpoints", "checkpoint_1"))
    monkeypatch.setattr(jax_run_lib, "make_cond_sampling_fn", lambda *a, **k: jax_fn)
    monkeypatch.setattr(jax_run_lib, "_init_model_and_state", lambda *a: (None, None, None))
    monkeypatch.setattr(jax_run_lib.ckpt_lib, "restore_checkpoint", lambda path, state: state)
    monkeypatch.setattr(jax_run_lib, "_ema_variables", lambda state: {})
    monkeypatch.setattr(run_lib, "make_cond_sampling_fn", lambda *a, **k: port_fn)
    # JAX's consensus memoizes canonical ids by id(molecule) (compute_metrics
    # canonical_id's _cache), and a later sweep's molecules can reuse the id
    # of an earlier one freed in between. Holding every scored molecule
    # alive keeps ids unique, so that JAX's lines are the consensus' own.
    alive = []

    def kept(factory):
        def build(*args):
            metric = factory(*args)

            def run(processed):
                out = metric(processed)
                alive.append(out)
                return out
            return run
        return build

    monkeypatch.setattr(jax_run_lib, "get_edm_metric", kept(jax_run_lib.get_edm_metric))
    monkeypatch.setattr(jax_run_lib, "get_2D_edm_metric", kept(jax_run_lib.get_2D_edm_metric))

    with caplog.at_level(logging.INFO):
        jax_run_lib.evaluate(jcfg, jax_original, workdir, "eval")
    want = _compared_lines(caplog.records)
    caplog.clear()
    port_dir = str(tmp_path / "port")
    with caplog.at_level(logging.INFO):
        figures = run_lib.diffspectra_evaluate(cfg, None, port_dir, "cpu", "1", original)
    got = _compared_lines(caplog.records)
    assert calls == {"jax": K, "port": K}
    return want, got, figures, os.path.join(workdir, "eval"), port_dir


NUMBER = re.compile(r"-?\d+\.\d+|nan")
ALIGN_ATOL = 1e-5  # the sub-geometry MMDs' bound against JAX (tests/test_torch_eval_stack.py)


def assert_lines_match(got, want):
    """Every line equal, but the ``Metric-Align`` line's figures: its text
    equal with each figure within ``ALIGN_ATOL`` of JAX's. Two float32 MMDs
    summed in another order differ by about 1e-6 (JAX's jitted sums and the
    port's row blocks each lie within 1e-6 of the float64 plain version), so
    a dihedral figure printed to six places can flip its last digit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not g.startswith("Metric-Align"):
            assert g == w
            continue
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        np.testing.assert_allclose([float(x) for x in NUMBER.findall(g)],
                                   [float(x) for x in NUMBER.findall(w)], rtol=0,
                                   atol=ALIGN_ATOL)


@pytest.mark.parametrize("sub_geometry", [False, True])
def test_eval_log_lines_match_jax(monkeypatch, tmp_path, caplog, sub_geometry):
    """The moses lines (FCD, Filters) always; with ``sub_geometry`` the
    ``Metric-Align`` line too, each package's target statistics computed
    from the test split into its own ``data.root`` under ``tmp_path``."""
    jcfg, cfg = _configs(num_samples=6, batch_size=6, num_candidates=K,
                         sub_geometry=sub_geometry)
    jcfg.data.root, cfg.data.root = str(tmp_path / "jax_root"), str(tmp_path / "port_root")
    want, got, figures, jax_dir, port_dir = run_both_evals(monkeypatch, tmp_path, caplog,
                                                           jcfg, cfg)
    assert_lines_match(got, want)
    # every kind of line, and hits and misses both: the stability and moses
    # lines (2 + 3), Top-K and consensus (4), the generalization lines (7),
    # the similarity lines of each dimension (9 each), and Metric-Align
    assert len(got) == 5 + 4 + 7 + 2 * 9 + sub_geometry
    assert [m.startswith("Metric-Align") for m in got].count(True) == sub_geometry
    assert os.path.exists(tmp_path / "port_root" / "target_geometry_stat.pk") == sub_geometry
    assert 0 < figures["top1_2d"] < figures["topk_2d"] and 0 < figures["topk_3d"] < 1
    assert [s["decoded"] for s in figures["sweeps"]] == [6] * K
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port_dir):
        if name.endswith("ckpt_1.csv"):
            with open(os.path.join(port_dir, name), "rb") as a, \
                    open(os.path.join(jax_dir, name), "rb") as b:
                assert a.read() == b.read()


# ---------------------------------------------------------------- end to end

def test_sweep_tool_end_to_end_on_the_cpu(tmp_path, capsys):
    argv = ["--smoke", "--random-weights", "--device", "cpu", "--steps", "3",
            "--num-samples", "6", "--num-candidates", "2", "--synthetic-size", str(SIZE),
            "--workdir", str(tmp_path)]
    assert eval_sweep.main(argv) == 0
    import json

    figures = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert figures["targets"] == 6 and figures["rounds"] == [[8, 16]]  # one round of the smoke batch, 8
    assert [s["decoded"] for s in figures["sweeps"]] == [6, 6]
    assert [len(s["round_seconds"]) for s in figures["sweeps"]] == [1, 1]
    for key in ("top1_2d", "top1_3d", "topk_2d", "topk_3d", "consensus_2d", "consensus_3d"):
        assert 0.0 <= figures[key] <= 1.0
    # the sub-geometry MMDs run by default, against the committed statistics
    assert set(figures["phase_seconds"]) == {"sampling+decode", "metrics-3d", "metrics-2d",
                                             "geometry", "topk-extra-sweeps(x1)", "similarity"}
    with open(tmp_path / "eval_sweep.log") as f:
        assert "Top-2 accuracy || 2D" in f.read()


def test_sweep_tool_flags_set_the_config():
    config = eval_sweep.build_config(eval_sweep.parse_args([
        "--pallas-ops", "block", "--num-samples", "64",
        "--batch-size", "32", "--steps", "7", "--seed", "3"]))
    assert config.model.pallas_ops == ("block",)
    assert (config.eval.num_samples, config.eval.batch_size) == (64, 32)
    assert (config.sampling.steps, config.seed) == (7, 3)
    default = eval_sweep.build_config(eval_sweep.parse_args([]))
    assert default.model.pallas_ops == ("attn", "equi")
    assert eval_sweep.build_config(eval_sweep.parse_args(
        ["--pallas-ops", "attn,equi"])).model.pallas_ops == ("attn", "equi")


@pytest.mark.parametrize("buckets,max_node", [((), 16), ((8, 12, 16), 16), ((16, 12, 8), 16),
                                              ((17, 21, 25, 29), 29)])
def test_bucket_policy_of_the_sweep_and_of_serving(buckets, max_node):
    """One policy, two callers: the sweep's round and a served request pad to
    the smallest bucket that holds them; where the buckets stop short of
    data.max_node the sweep refuses (the JAX harness) and serving pads to
    data.max_node (the JAX Elucidator)."""
    from diffspectra_tpu_torch.api import Elucidator

    cfg = configs.apply_overrides(configs.get_smoke_config(), {
        "data.max_node": max_node, "eval.bucket_sizes": buckets})
    el = object.__new__(Elucidator)
    el.config = cfg
    jax_buckets = tuple(sorted(buckets)) or (max_node,)
    for n in range(1, max_node + 1):
        want = next((b for b in jax_buckets if b >= n), max_node)  # JAX api.py's pad
        assert el._bucket(n) == want
        assert harness.bucket_for(harness.bucket_sizes_of(cfg), n) == want
    short = configs.apply_overrides(cfg, {"eval.bucket_sizes": (8, 12), "data.max_node": 16})
    with pytest.raises(ValueError, match="must cover data.max_node"):
        harness.bucket_sizes_of(short)
    el.config = short
    assert [el._bucket(n) for n in (8, 9, 12, 13, 16)] == [8, 12, 12, 16, 16]


def test_sweep_refuses_cuda_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lib.evaluate(cfg, f"{ROOT}/artifacts/warm_qm9s_as.npz", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_sweep.main(["--smoke", "--random-weights", "--workdir", str(tmp_path)])
