"""The train state (port of ``diffspectra_tpu/training/train_state.py``):
the step, the model (its parameters and SpecFormer's batch statistics),
the optimizer state and the EMA, as one object the train step updates in
place."""

from __future__ import annotations

import dataclasses
from typing import Dict

from torch import nn

from ..models import ema as ema_lib


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module  # params and batch_stats
    opt_state: dict
    ema: ema_lib.EMAState


def params_of(model: nn.Module) -> Dict[str, nn.Parameter]:
    return dict(model.named_parameters())


def create_train_state(model: nn.Module, tx, ema_decay: float) -> TrainState:
    params = params_of(model)
    return TrainState(step=0, model=model, opt_state=tx.init(params),
                      ema=ema_lib.init(params, ema_decay))
