"""Checkpoints of the train state (port of ``diffspectra_tpu/checkpoint.py``,
in the port's own format: JAX's orbax layout cannot be read without orbax).

A checkpoint is a directory holding ``state.pt``: ``torch.save`` of the
step, the model's ``state_dict`` (params and batch statistics), the
optimizer state and the EMA, tensors and plain numbers only, read back with
``torch.load(weights_only=True)``. The layout is the JAX package's: one
overwritten preemption checkpoint ``checkpoints-meta/checkpoint`` and
numbered snapshots ``checkpoints/checkpoint_N``. A save writes a temporary
file and renames it, so an interrupted save leaves the previous file whole.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

STATE_FILE = "state.pt"


def _tensors(state):
    yield from state.model.state_dict().values()
    yield from state.ema.shadow_params.values()
    opt = state.opt_state
    for key in ("mu", "nu", "nu_max"):
        yield from opt.get(key, {}).values()
    if opt.get("clip"):
        yield opt["clip"]["queue"]


def state_is_finite(state) -> bool:
    """True iff every floating-point tensor of the train state is finite;
    guards a checkpoint from being overwritten by a diverged run."""
    checks = [torch.isfinite(t).all() for t in _tensors(state) if t.is_floating_point()]
    return bool(torch.stack(checks).all()) if checks else True


def save_checkpoint(ckpt_dir: str, state) -> None:
    """Write the train state to ``ckpt_dir`` (overwrites)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {"step": int(state.step), "model": state.model.state_dict(), "opt": state.opt_state,
            "ema": {"decay": float(state.ema.decay), "num_updates": int(state.ema.num_updates),
                    "shadow": state.ema.shadow_params}}
    path = os.path.join(ckpt_dir, STATE_FILE)
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_checkpoint_if_finite(ckpt_dir: str, state) -> bool:
    """Save unless the state holds non-finite values (then the previous
    checkpoint is kept); returns whether it saved."""
    if not state_is_finite(state):
        logging.error("REFUSING to save non-finite train state to %s "
                      "(keeping the previous checkpoint)", ckpt_dir)
        return False
    save_checkpoint(ckpt_dir, state)
    return True


def restore_checkpoint(ckpt_dir: str, state):
    """``state`` with the checkpoint's values, on the device of its model;
    unchanged (with a warning) if ``ckpt_dir`` holds none."""
    path = os.path.join(ckpt_dir, STATE_FILE)
    if not os.path.exists(path):
        logging.warning("No checkpoint found at %s. Returned the same state as input", ckpt_dir)
        return state
    device = next(state.model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    if set(blob["ema"]["shadow"]) != set(state.ema.shadow_params):
        raise KeyError(f"{path}: its EMA does not match the model")
    for k, v in blob["ema"]["shadow"].items():
        state.ema.shadow_params[k].copy_(v)
    state.ema.decay, state.ema.num_updates = blob["ema"]["decay"], blob["ema"]["num_updates"]
    state.opt_state, state.step = blob["opt"], blob["step"]
    return state


def meta_checkpoint_dir(workdir: str) -> str:
    return os.path.join(workdir, "checkpoints-meta", "checkpoint")


def numbered_checkpoint_dir(workdir: str, number: int) -> str:
    return os.path.join(workdir, "checkpoints", f"checkpoint_{number}")


def latest_numbered_checkpoint(workdir: str) -> Optional[int]:
    """The highest N for which ``checkpoints/checkpoint_N`` holds a state."""
    ckpt_dir = os.path.join(workdir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    nums = []
    for name in os.listdir(ckpt_dir):
        suffix = name[len("checkpoint_"):]
        if (name.startswith("checkpoint_") and suffix.isdigit()
                and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE))):
            nums.append(int(suffix))
    return max(nums) if nums else None


def restore_for_resume(workdir: str, state):
    """The preemption checkpoint, else the latest numbered snapshot, else
    ``state`` as it is."""
    meta = meta_checkpoint_dir(workdir)
    if os.path.exists(os.path.join(meta, STATE_FILE)):
        return restore_checkpoint(meta, state)
    latest = latest_numbered_checkpoint(workdir)
    if latest is None:
        return restore_checkpoint(meta, state)  # warns, returns the fresh state
    logging.warning("Meta checkpoint missing at %s; resuming from snapshot checkpoint_%d "
                    "instead", meta, latest)
    return restore_checkpoint(numbered_checkpoint_dir(workdir, latest), state)
