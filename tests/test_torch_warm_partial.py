"""The cross-spectra warm start (``warm_state.warm_start_partial``) against
the JAX package's ``_merge_partial``: an IR-only state into an allspectra
model (smoke widths), with ``cond_encoder/head_linear/kernel`` zeroed where
fresh. The restored, fresh and zeroed leaves and every merged value equal
JAX's, tree by tree (params, batch statistics, EMA), and so do the logged
counts; a file of which nothing is restored raises in both packages;
``run_lib.train`` takes ``training.warm_start_partial`` and
``warm_start_zero_fresh``."""

import logging

import numpy as np
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu import warm_state as jax_warm
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.warm_state import (
    _BF16,
    _META,
    _RAW,
    export_warm_state,
    f32_to_bf16_bits,
    flax_variables,
    warm_start,
    warm_start_partial,
)

torch.set_num_threads(2)
SMALL = {"model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "data.synthetic_size": 96}
ZERO = ("cond_encoder/head_linear/kernel",)


def _config(version, **over):
    return configs.apply_overrides(configs.get_smoke_config(), {
        **SMALL, "data.spectra_version": version, **over})


def _ir_state_file(tmp_path):
    _, state = run_lib.init_train_state(_config("ir"), torch.device("cpu"))
    with torch.no_grad():  # weights apart from a fresh init's
        for p in state.model.parameters():
            p.add_(0.01)
    state.step = 5
    path = str(tmp_path / "ir.npz")
    export_warm_state(state, path)
    return path


def _merge_lines(messages):
    return sorted(m for m in messages if m.startswith("partial warm start"))


def test_ir_state_into_allspectra_matches_jax(tmp_path, caplog):
    path = _ir_state_file(tmp_path)
    _, state = run_lib.init_train_state(_config("allspectra"), torch.device("cpu"))
    fresh = {k: v.copy() for k, v in flax_variables(state.model).items()}
    fresh_ema = {k: v.copy() for k, v in
                 flax_variables(state.model, state.ema.shadow_params).items()}
    with caplog.at_level(logging.INFO):
        state, reports = warm_start_partial(state, path, ZERO)
    port_lines = [r.getMessage() for r in caplog.records]
    caplog.clear()
    got = flax_variables(state.model)
    got_ema = flax_variables(state.model, state.ema.shadow_params)
    assert state.step == 5

    with np.load(path) as npz, caplog.at_level(logging.INFO):
        for tree, want_tree, got_tree in (("params", fresh, got), ("batch_stats", fresh, got),
                                          ("ema", fresh_ema, got_ema)):
            prefix = "batch_stats" if tree == "batch_stats" else "params"
            sub = {k.split("/", 1)[1]: v for k, v in want_tree.items()
                   if k.startswith(prefix + "/")}
            merged = jax_warm._merge_partial(
                traverse_util.unflatten_dict(sub, sep="/"), jax_warm._decode(npz, tree), tree,
                zero_fresh=ZERO)
            merged = traverse_util.flatten_dict(merged, sep="/")
            assert set(merged) == set(sub)
            for k, v in merged.items():
                np.testing.assert_array_equal(got_tree[f"{prefix}/{k}"], np.asarray(v),
                                              err_msg=f"{tree} {k}")
            report = reports[tree]
            assert len(report["restored"]) + len(report["fresh"]) == len(sub)
    jax_lines = [r.getMessage() for r in caplog.records]
    # the same counts and zeroed paths, logged in the same words
    assert _merge_lines(port_lines) == _merge_lines(jax_lines)
    assert len(_merge_lines(port_lines)) == 3
    # the IR state lacks the UV and Raman patch embedders; the head's kernel
    # (its input width differs) is fresh and zeroed; the DMT trunk is restored
    for tree in ("params", "ema"):
        zeroed = reports[tree]["zeroed"]
        assert zeroed == ["params/cond_encoder/head_linear/kernel"], zeroed
        assert not got[zeroed[0]].any() and not got_ema[zeroed[0]].any()
        assert "params/cond_encoder/W_P_0/kernel" in reports[tree]["fresh"]
        assert any(k.startswith("params/blocks/") for k in reports[tree]["restored"])
        assert reports[tree]["shape_mismatched"] >= 1


def test_nothing_restored_raises(tmp_path):
    path = str(tmp_path / "other.npz")
    bits = f32_to_bf16_bits(np.ones((3, 3), np.float32))
    np.savez(path, **{_BF16 + "params/other/kernel": bits, _BF16 + "ema/other/kernel": bits,
                      _RAW + "step": np.asarray(1), _RAW + "ema_num_updates": np.asarray(1),
                      _META: np.asarray("{}")})
    _, state = run_lib.init_train_state(_config("ir"), torch.device("cpu"))
    with pytest.raises(ValueError, match="restored nothing"):
        warm_start(state, path, partial=True)
    with np.load(path) as npz, pytest.raises(ValueError, match="restored nothing"):
        jax_warm._merge_partial({"x": np.zeros(2, np.float32)}, jax_warm._decode(npz, "params"),
                                "params")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        warm_start(state, path)  # whole: the trees must match


def test_train_takes_a_partial_warm_start(tmp_path):
    path = _ir_state_file(tmp_path)
    config = _config("allspectra", **{
        "training.warm_start": path, "training.warm_start_partial": True,
        "training.warm_start_zero_fresh": ",".join(ZERO), "training.n_iters": 5,
        "training.log_freq": 1, "training.snapshot_sampling": False})
    state = run_lib.train(config, str(tmp_path / "run"), "cpu")
    assert state.step == 6  # the file's step 5, then one step
    # the first update's learning rate is 0: the zeroed kernel stays zero
    kernel = flax_variables(state.model)["params/cond_encoder/head_linear/kernel"]
    assert not kernel.any()
