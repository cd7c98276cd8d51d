"""Exponential moving average of the parameters (port of
``diffspectra_tpu/models/ema.py``): a shadow copy of each parameter, its
decay warmed up as ``min(decay, (1 + n) / (10 + n))`` over the updates."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    decay: float
    num_updates: int  # -1: no warmup
    shadow_params: Dict[str, torch.Tensor]


def init(params: Dict[str, torch.Tensor], decay: float,
         use_num_updates: bool = True) -> EMAState:
    if decay < 0.0 or decay > 1.0:
        raise ValueError("Decay must be between 0 and 1")
    return EMAState(decay, 0 if use_num_updates else -1,
                    {k: p.detach().clone() for k, p in params.items()})


def one_minus_decay(state: EMAState, num_updates: int) -> float:
    """``1 - decay_t`` in float32, as the JAX update computes it."""
    decay = np.float32(state.decay)
    if num_updates >= 0:
        decay = min(decay, np.float32(1.0 + num_updates) / np.float32(10.0 + num_updates))
    return float(np.float32(1.0) - np.float32(decay))


@torch.no_grad()
def update(state: EMAState, params: Dict[str, torch.Tensor]) -> EMAState:
    """``shadow <- shadow - (1 - decay_t) (shadow - param)``, in place."""
    num_updates = state.num_updates + 1 if state.num_updates >= 0 else -1
    w = one_minus_decay(state, num_updates)
    shadow = list(state.shadow_params.values())
    diff = torch._foreach_sub(shadow, [params[k].detach() for k in state.shadow_params])
    torch._foreach_mul_(diff, w)
    torch._foreach_sub_(shadow, diff)
    state.num_updates = num_updates
    return state


def params(state: EMAState) -> Dict[str, torch.Tensor]:
    """The averaged parameters."""
    return state.shadow_params
