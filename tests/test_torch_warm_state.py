"""Reading the warm-state exports without ml_dtypes: the bfloat16 decode is
bit-exact against ml_dtypes, every one of the 283 keys of
``artifacts/warm_qm9s_as.npz`` is accounted for, and a missing or extra key
raises, in the file and in the model's state."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.warm_state import (
    bf16_bits_to_f32,
    load_model_state,
    load_warm_state,
    random_variables,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")


def test_bf16_decode_is_bit_exact_against_ml_dtypes():
    bits = np.arange(1 << 16, dtype=np.uint16)  # every bfloat16 bit pattern
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    got = bf16_bits_to_f32(bits)
    assert got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_all_283_keys_of_the_flagship_state_are_accounted_for():
    with np.load(WARM) as npz:
        files = set(npz.files)
    assert len(files) == 283
    state = load_warm_state(WARM)
    variables = state["variables"]
    ema = {k for k in files if k.startswith("bf16:ema/")}
    params = {k for k in files if k.startswith("bf16:params/")}
    stats = {k for k in files if k.startswith("bf16:batch_stats/")}
    assert (len(ema), len(params), len(stats)) == (134, 134, 12)
    assert len(ema) + len(params) + len(stats) + 3 == len(files)  # + step, ema_num_updates, meta
    assert len(variables) == len(ema) + len(stats)
    assert state["step"] == 1_000_001
    assert state["meta"]["spectra_version"] == "allspectra"
    assert all(v.dtype == np.float32 for v in variables.values())
    # the EMA params are what serving loads, not the raw params
    with np.load(WARM) as npz:
        key = "cond_lin/bias"
        np.testing.assert_array_equal(
            variables[f"params/{key}"], bf16_bits_to_f32(npz[f"bf16:ema/{key}"])
        )
    model = DMT.from_config(configs.get_config())
    load_model_state(model, variables)  # strict: every parameter and buffer filled
    n_state = len(model.state_dict())
    n_layers = configs.get_config().model.n_layers
    n_block = sum(1 for k in variables if k.startswith("params/blocks/"))
    assert n_state == len(variables) - n_block + n_layers * n_block


def _write(path, keys):
    arrays = {k: np.zeros(2, np.uint16) for k in keys}
    arrays.update({"raw:step": np.asarray(3), "raw:ema_num_updates": np.asarray(2),
                   "__meta__": np.asarray(json.dumps({}))})
    np.savez(path, **arrays)
    return path


def test_unexpected_or_unmatched_file_keys_raise(tmp_path):
    good = ["bf16:params/a/kernel", "bf16:ema/a/kernel", "bf16:batch_stats/n/mean"]
    state = load_warm_state(_write(tmp_path / "good.npz", good))
    assert set(state["variables"]) == {"params/a/kernel", "batch_stats/n/mean"}
    with pytest.raises(KeyError, match="unexpected key"):
        load_warm_state(_write(tmp_path / "extra.npz", good + ["bf16:opt/a"]))
    with pytest.raises(KeyError, match="differ"):
        load_warm_state(_write(tmp_path / "mirror.npz", good + ["bf16:ema/b"]))
    path = tmp_path / "nostep.npz"
    np.savez(path, **{k: np.zeros(2, np.uint16) for k in good})
    with pytest.raises(KeyError, match="raw:step"):
        load_warm_state(path)


def test_missing_or_extra_model_keys_raise():
    config = configs.apply_overrides(configs.get_smoke_config(), {"model.n_layers": 2})
    model = DMT.from_config(config)
    flat = random_variables(model, seed=0)
    load_model_state(model, flat)
    missing = dict(flat)
    missing.pop("params/cond_lin/bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model_state(model, missing)
    extra = dict(flat, **{"params/not_a_layer/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_model_state(model, extra)
    with pytest.raises(KeyError):
        load_model_state(model, dict(flat, **{"opt_state/x": np.zeros(1, np.float32)}))
