"""Read the committed warm-state ``.npz`` exports (``artifacts/warm_*.npz``)
into PyTorch, without ``ml_dtypes`` or any JAX package.

The export (``diffspectra_tpu/warm_state.py``) stores float arrays as
bfloat16 bit patterns under ``bf16:<tree>/<flax path>`` keys, other arrays
under ``raw:<...>``, and a JSON ``__meta__``. The trees are ``params``,
``ema`` (the EMA shadow of ``params``) and ``batch_stats``; serving uses the
EMA params and the batch statistics. The DMT block parameters carry the
block scan's leading layer axis, which ``params_from_flax`` unstacks.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

_BF16 = "bf16:"
_RAW = "raw:"
_META = "__meta__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_warm_state(npz_path: str) -> dict:
    """Returns ``{"variables": {"params/<path>": f32, "batch_stats/<path>":
    f32}, "step": int, "ema_num_updates": int, "meta": dict}`` with the EMA
    params as ``params``. Every key of the file is accounted for: the
    ``params/`` tree must mirror the ``ema/`` tree key for key, and a key of
    any other kind raises."""
    with np.load(npz_path, allow_pickle=False) as npz:
        trees: Dict[str, Dict[str, str]] = {"params": {}, "ema": {}, "batch_stats": {}}
        scalars = {}
        for key in npz.files:
            if key == _META:
                continue
            prefix = _BF16 if key.startswith(_BF16) else _RAW if key.startswith(_RAW) else None
            if prefix is None:
                raise KeyError(f"{npz_path}: unexpected key {key!r}")
            name = key[len(prefix):]
            tree, _, path = name.partition("/")
            if tree in trees and path:
                trees[tree][path] = key
            elif name in ("step", "ema_num_updates") and prefix == _RAW:
                scalars[name] = int(npz[key])
            else:
                raise KeyError(f"{npz_path}: unexpected key {key!r}")
        if set(trees["params"]) != set(trees["ema"]):
            diff = sorted(set(trees["params"]) ^ set(trees["ema"]))[:5]
            raise KeyError(f"{npz_path}: params/ and ema/ trees differ, e.g. {diff}")
        if set(scalars) != {"step", "ema_num_updates"}:
            raise KeyError(f"{npz_path}: missing raw:step or raw:ema_num_updates")

        def decode(key):
            arr = npz[key]
            return bf16_bits_to_f32(arr) if key.startswith(_BF16) else arr.astype(np.float32)

        variables = {f"params/{p}": decode(k) for p, k in trees["ema"].items()}
        variables.update({f"batch_stats/{p}": decode(k) for p, k in trees["batch_stats"].items()})
        meta = json.loads(str(npz[_META])) if _META in npz.files else {}
    return {"variables": variables, "step": scalars["step"],
            "ema_num_updates": scalars["ema_num_updates"], "meta": meta}


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables (``"params/<path>"`` / ``"batch_stats/<path>"``,
    ``/``-separated as ``flax.traverse_util.flatten_dict(..., sep="/")``
    gives them) -> a ``state_dict`` for ``DMT``. ``params/blocks/<path>``
    arrays are stacked over layers and become ``blocks.<l>.<path>``."""
    state = {}
    for key, value in flat.items():
        tree, _, path = key.partition("/")
        if tree not in ("params", "batch_stats") or not path:
            raise KeyError(f"not a params/ or batch_stats/ path: {key!r}")
        arr = np.asarray(value, dtype=np.float32)
        dotted = path.replace("/", ".")
        if dotted.startswith("blocks."):
            sub = dotted[len("blocks."):]
            for layer in range(arr.shape[0]):
                state[f"blocks.{layer}.{sub}"] = torch.from_numpy(np.ascontiguousarray(arr[layer]))
        else:
            state[dotted] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_model_state(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Fill every parameter and buffer of ``model`` from flat flax
    variables; a key left over, a parameter never filled or a shape
    mismatch raises."""
    model.load_state_dict(params_from_flax(flat), strict=True)


def random_variables(model: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for ``model`` in the flat flax layout that
    ``load_model_state`` takes (and ``flax.traverse_util.unflatten_dict``
    turns into a flax tree), for runs without a checkpoint: kernels scaled
    by 1/sqrt(fan_in), norm scales near 1, Gaussian-basis widths in
    [0.5, 3], running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    buffers = {name for name, _ in model.named_buffers()}
    flat: Dict[str, np.ndarray] = {}
    blocks: Dict[str, list] = {}
    for key, tensor in model.state_dict().items():
        shape, leaf = tuple(tensor.shape), key.rsplit(".", 1)[-1]
        if leaf == "var":
            value = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("means", "stds"):
            value = rng.uniform(0.5, 3.0, shape)
        elif leaf == "scale":
            value = 1.0 + rng.normal(0.0, 0.1, shape)
        elif len(shape) >= 2:
            value = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            value = rng.normal(0.0, 0.1, shape)
        value = value.astype(np.float32)
        tree = "batch_stats" if key in buffers else "params"
        if key.startswith("blocks."):
            _, layer, rest = key.split(".", 2)
            blocks.setdefault(f"{tree}/blocks/{rest.replace('.', '/')}", []).append((int(layer), value))
        else:
            flat[f"{tree}/{key.replace('.', '/')}"] = value
    for path, layers in blocks.items():
        flat[path] = np.stack([v for _, v in sorted(layers)])
    return flat
