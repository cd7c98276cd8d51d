"""Warm-state ``.npz`` files (``artifacts/warm_*.npz``) in PyTorch, without
``ml_dtypes`` or any JAX package: read them, write them from a state the
port trained, warm-start training from them, and carry the JAX package's
train state and initial parameters across.

The layout (``diffspectra_tpu/warm_state.py``) stores float arrays as
bfloat16 bit patterns under ``bf16:<tree>/<flax path>`` keys, other arrays
under ``raw:<...>``, and a JSON ``__meta__``. The trees are ``params``,
``ema`` (the EMA shadow of ``params``) and ``batch_stats``; serving uses the
EMA params and the batch statistics. The DMT block parameters carry the
block scan's leading layer axis, which ``params_from_flax`` unstacks and
``flax_variables`` stacks again.
"""

from __future__ import annotations

import json
import logging
import math
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

_BF16 = "bf16:"
_RAW = "raw:"
_META = "__meta__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 values -> their bfloat16 bit patterns (uint16), rounded to
    nearest even, as ``ml_dtypes`` rounds."""
    arr = np.asarray(arr, dtype=np.float32)
    # ascontiguousarray makes a 0-d array (GINE's eps) 1-d: keep the shape
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def read_warm_state(npz_path: str) -> dict:
    """Every tree of the file as flat variables: ``{"params": {"params/<path>":
    f32}, "ema": {"params/<path>": f32}, "batch_stats": {"batch_stats/<path>":
    f32}, "step": int, "ema_num_updates": int, "meta": dict}``. Every key of
    the file is accounted for: the ``params/`` tree must mirror the ``ema/``
    tree key for key, and a key of any other kind raises."""
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

        out = {tree: {f"{'batch_stats' if tree == 'batch_stats' else 'params'}/{p}": decode(k)
                      for p, k in keys.items()} for tree, keys in trees.items()}
        meta = json.loads(str(npz[_META])) if _META in npz.files else {}
    return {**out, "step": scalars["step"], "ema_num_updates": scalars["ema_num_updates"],
            "meta": meta}


def load_warm_state(npz_path: str) -> dict:
    """Returns ``{"variables": {"params/<path>": f32, "batch_stats/<path>":
    f32}, "step": int, "ema_num_updates": int, "meta": dict}`` with the EMA
    params as ``params``, for serving."""
    state = read_warm_state(npz_path)
    return {"variables": {**state["ema"], **state["batch_stats"]}, "step": state["step"],
            "ema_num_updates": state["ema_num_updates"], "meta": state["meta"]}


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables (``"params/<path>"`` / ``"batch_stats/<path>"``,
    ``/``-separated as ``flax.traverse_util.flatten_dict(..., sep="/")``
    gives them) -> a ``state_dict`` for the DMT, DMT_WO_EQ or CDGS.
    ``params/blocks/<path>`` arrays are stacked over layers and become
    ``blocks.<l>.<path>``; CDGS's blocks are apart in flax too
    (``block_<l>``)."""
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
            state[dotted] = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    return state


def load_model_state(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Fill every parameter and buffer of ``model`` from flat flax
    variables; a key left over, a parameter never filled or a shape
    mismatch raises."""
    model.load_state_dict(params_from_flax(flat), strict=True)


def _flax_layout(model: torch.nn.Module, values: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``{state_dict key: array}`` of ``model`` -> flat flax variables
    (``params/`` or ``batch_stats/`` by whether the key is a buffer), the
    blocks' arrays stacked over layers."""
    buffers = {name for name, _ in model.named_buffers()}
    flat: Dict[str, np.ndarray] = {}
    blocks: Dict[str, list] = {}
    for key, value in values.items():
        tree = "batch_stats" if key in buffers else "params"
        if key.startswith("blocks."):
            _, layer, rest = key.split(".", 2)
            blocks.setdefault(f"{tree}/blocks/{rest.replace('.', '/')}", []).append((int(layer), value))
        else:
            flat[f"{tree}/{key.replace('.', '/')}"] = value
    for path, layers in blocks.items():
        flat[path] = np.stack([v for _, v in sorted(layers, key=lambda lv: lv[0])])
    return flat


def flax_variables(model: torch.nn.Module,
                   tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """The model's parameters and batch statistics (or ``tensors``, keyed
    as its ``state_dict``) as flat flax variables, float32 numpy."""
    tensors = model.state_dict() if tensors is None else tensors
    return _flax_layout(model, {k: v.detach().float().cpu().numpy() for k, v in tensors.items()})


def random_variables(model: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded random weights for ``model`` in the flat flax layout that
    ``load_model_state`` takes (and ``flax.traverse_util.unflatten_dict``
    turns into a flax tree), for runs without a checkpoint: kernels scaled
    by 1/sqrt(fan_in), norm scales near 1, Gaussian-basis widths in
    [0.5, 3], running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    values = {}
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
        values[key] = value.astype(np.float32)
    return _flax_layout(model, values)


def init_variables(model: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """A fresh init of the model (the DMT, DMT_WO_EQ or CDGS) with flax's
    initializers, layer by layer, as
    JAX's ``model.init`` draws them (the distributions, not the numbers):
    kernels ``lecun_normal`` (a normal truncated at 2 standard deviations,
    variance 1 / fan_in), biases and GINE's ``eps`` 0, the time
    embedding's weights N(0, 1),
    the Gaussian basis' means and stds U[0, 3), the coordinate norms' scale
    0.01, SpecFormer's positional embeddings U(-0.02, 0.02), norm scales 1,
    running means 0 and variances 1."""
    gen = torch.Generator().manual_seed(seed)
    values = {}
    for key, tensor in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        out = torch.empty(tensor.shape)
        if leaf.endswith("kernel"):
            std = math.sqrt(1.0 / tensor.shape[0]) / 0.87962566103423978
            torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif leaf.endswith("bias") or leaf in ("mean", "eps"):
            out.zero_()
        elif leaf == "weights":
            out.normal_(generator=gen)
        elif leaf in ("means", "stds"):
            out.uniform_(0.0, 3.0, generator=gen)
        elif leaf.startswith("W_pos"):
            out.uniform_(-0.02, 0.02, generator=gen)
        elif key.endswith("coord_norm.scale"):
            out.fill_(1e-2)
        elif leaf in ("scale", "var"):
            out.fill_(1.0)
        else:
            raise KeyError(f"no initializer for {key}")
        values[key] = out.numpy()
    return _flax_layout(model, values)


def _flatten_tree(tree, prefix: str) -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> ``{"<prefix>/<a>/<b>": array}``."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree, dtype=np.float32)}
    flat = {}
    for key, sub in tree.items():
        flat.update(_flatten_tree(sub, f"{prefix}/{key}"))
    return flat


def _leaves_with(tree, attr: str):
    """The namedtuples with field ``attr`` in an optax state tree."""
    if hasattr(tree, "_fields"):
        return [tree] if attr in tree._fields else []
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaves_with(sub, attr)]
    return []


def train_state_from_flax(jax_state, model: torch.nn.Module, tx, device=None):
    """The JAX package's ``TrainState`` with numpy leaves (``jax.device_get``
    of it) -> the port's ``TrainState`` around ``model``: params,
    batch_stats, the EMA shadow and count, the optax state of
    ``training/optim.py`` (the clip queue and count, the moments ``mu``,
    ``nu``, ``nu_max`` and their count, the schedule's count) and the
    step. ``tx`` is the port's optimizer for the same config."""
    from .training.train_state import TrainState, params_of
    from .models import ema as ema_lib

    device = torch.device("cpu") if device is None else torch.device(device)
    variables = {**_flatten_tree(jax_state.params, "params"),
                 **_flatten_tree(jax_state.batch_stats or {}, "batch_stats")}
    load_model_state(model, variables)
    model.to(device)

    def tree(nested):
        return {k: v.to(device) for k, v in params_from_flax(_flatten_tree(nested, "params")).items()}

    opt = tx.init(params_of(model))
    (moments,) = _leaves_with(jax_state.opt_state, "mu")
    opt.update(count=int(moments.count), mu=tree(moments.mu), nu=tree(moments.nu))
    if "nu_max" in opt:
        opt["nu_max"] = tree(moments.nu_max)
    (schedule,) = [x for x in _leaves_with(jax_state.opt_state, "count") if x._fields == ("count",)]
    opt["lr_count"] = int(schedule.count)
    clip = _leaves_with(jax_state.opt_state, "queue")
    if clip:
        opt["clip"] = {"queue": torch.as_tensor(np.asarray(clip[0].queue), device=device),
                       "count": int(clip[0].count)}
    ema = ema_lib.EMAState(float(jax_state.ema.decay), int(jax_state.ema.num_updates),
                           tree(jax_state.ema.shadow_params))
    return TrainState(step=int(jax_state.step), model=model, opt_state=opt, ema=ema)


def export_warm_state(state, path: str, meta: Optional[dict] = None) -> None:
    """Write a port ``TrainState``'s params, EMA, batch statistics and step
    in the JAX package's layout (float arrays as bfloat16 bits), which both
    packages' ``load_warm_state`` read: an ``.npz`` deflated at level 1
    (bfloat16 bits hardly compress: the flagship state takes 127.9 MB at
    level 1 and 126.7 at ``np.savez_compressed``'s 6, in a third of the
    time)."""
    model = state.model
    params = {k: v for k, v in model.state_dict().items() if k in state.ema.shadow_params}
    buffers = {k: v for k, v in model.state_dict().items() if k not in params}
    out = {}
    for tree, tensors in (("params", params), ("ema", state.ema.shadow_params),
                          ("batch_stats", buffers)):
        for key, arr in flax_variables(model, tensors).items():
            out[_BF16 + tree + "/" + key.split("/", 1)[1]] = f32_to_bf16_bits(arr)
    out[_RAW + "step"] = np.asarray(int(state.step), np.int64)
    out[_RAW + "ema_num_updates"] = np.asarray(int(state.ema.num_updates), np.int64)
    out[_META] = np.asarray(json.dumps(meta or {}))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for key, arr in out.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def warm_start(state, npz_path: str, partial: bool = False, zero_fresh=()):
    """``state`` (fresh) with the params, EMA, batch statistics and step of
    a warm-state file; the optimizer state stays fresh, so the moments
    rebuild and the learning-rate warmup replays, as the JAX package's
    warm start does. With ``partial``: ``warm_start_partial``."""
    if partial:
        return warm_start_partial(state, npz_path, zero_fresh)[0]
    warm = read_warm_state(npz_path)
    load_model_state(state.model, {**warm["params"], **warm["batch_stats"]})
    shadow = params_from_flax(warm["ema"])
    if set(shadow) != set(state.ema.shadow_params):
        raise KeyError(f"{npz_path}: its ema tree does not match the model")
    for k, v in shadow.items():
        state.ema.shadow_params[k].copy_(v)
    return _restored(state, warm, npz_path)


def _restored(state, warm, npz_path):
    state.step, state.ema.num_updates = warm["step"], warm["ema_num_updates"]
    logging.info("warm start: restored step %d from %s (meta: %s); optimizer state is fresh "
                 "(Adam moments rebuild, LR warmup replays)", state.step, npz_path, warm["meta"])
    return state


def _merge_partial(want: Dict[str, np.ndarray], flat: Dict[str, np.ndarray], what: str,
                   zero_fresh=()):
    """``(merged, report)``: each leaf of ``want`` (flat flax variables)
    from ``flat`` where the file has its path and shape, else kept fresh,
    or zeroed where its path (without the tree's prefix) holds one of the
    ``zero_fresh`` substrings. ``report``: the paths ``restored``,
    ``fresh`` and ``zeroed``, and the counts ``shape_mismatched`` and
    ``unused`` (file keys the model lacks). Nothing restored raises."""
    merged, report = {}, {"restored": [], "fresh": [], "zeroed": [], "shape_mismatched": 0}
    for path, leaf in want.items():
        if path in flat and flat[path].shape == leaf.shape:
            merged[path] = flat[path]
            report["restored"].append(path)
            continue
        report["shape_mismatched"] += path in flat
        report["fresh"].append(path)
        if any(pat and pat in path.split("/", 1)[1] for pat in zero_fresh):
            merged[path] = np.zeros_like(leaf)
            report["zeroed"].append(path)
        else:
            merged[path] = leaf
    report["unused"] = len(set(flat) - set(want))
    logging.info("partial warm start %s: %d/%d leaves restored (%d shape-mismatched kept fresh, "
                 "%d npz keys unused%s)", what, len(report["restored"]), len(want),
                 report["shape_mismatched"], report["unused"],
                 f", zeroed fresh: {[p.split('/', 1)[1] for p in report['zeroed']]}"
                 if report["zeroed"] else "")
    if not report["restored"]:
        raise ValueError(f"partial warm state restored nothing for {what} -- wrong file?")
    return merged, report


def warm_start_partial(state, npz_path: str, zero_fresh=()):
    """``(state, reports)``: the cross-spectra warm start (an allspectra
    model from an IR-only state, say). The leaves of the params, the batch
    statistics and the EMA that the file holds at the same path and shape
    are restored, the rest keep their fresh values, or are zeroed where a
    ``zero_fresh`` substring (a flax path such as
    ``cond_encoder/head_linear/kernel``) is in their path; the optimizer
    state stays fresh and the step is the file's. ``reports``: each tree's
    ``_merge_partial`` report. A tree of which nothing is restored raises."""
    warm = read_warm_state(npz_path)
    model = state.model
    current = flax_variables(model)
    reports = {}
    params, reports["params"] = _merge_partial(
        {k: v for k, v in current.items() if k.startswith("params/")}, warm["params"],
        "params", zero_fresh)
    stats = {k: v for k, v in current.items() if k.startswith("batch_stats/")}
    if stats:
        stats, reports["batch_stats"] = _merge_partial(stats, warm["batch_stats"],
                                                      "batch_stats", zero_fresh)
    ema, reports["ema"] = _merge_partial(flax_variables(model, state.ema.shadow_params),
                                         warm["ema"], "ema", zero_fresh)
    load_model_state(model, {**params, **stats})
    for k, v in params_from_flax(ema).items():
        state.ema.shadow_params[k].copy_(v)
    return _restored(state, warm, npz_path), reports
