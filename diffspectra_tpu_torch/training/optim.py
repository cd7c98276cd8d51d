"""The optimizer chain (port of ``diffspectra_tpu/training/optim.py``),
written out over tensors as optax computes it:

- the adaptive gradient clip: the allowed norm is ``min(1.5 mean + 2 std,
  grad_clip)`` over a queue of the last 50 (clipped) norms, started at
  3000; ``grad_clip <= 1`` clips to it plainly, ``< 0`` not at all;
- ``AdamW``: ``scale_by_amsgrad`` (the max is over the bias-corrected
  second moment, which is not ``torch.optim.AdamW(amsgrad=True)``'s rule),
  ``add_decayed_weights(1e-12)``, then the learning rate; ``Adam``:
  ``add_decayed_weights(weight_decay)`` where set, ``scale_by_adam``, the
  learning rate;
- the learning rate ``lr * min(count / warmup, 1)`` of the chain's own
  count, 0 at the first update.

The state is a dict of tensors and plain numbers (``torch.save`` with
``weights_only`` reads it back); parameters, gradients and moments are
dicts keyed by parameter name.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

QUEUE_LEN = 50
QUEUE_INIT = 3000.0
B2 = 0.999
AMSGRAD_EPS = 1e-8  # optax.scale_by_amsgrad's default eps
ADAMW_DECAY = 1e-12  # the reference's torch.optim.AdamW(weight_decay=1e-12)

Tensors = Dict[str, torch.Tensor]


def lr_at(config, count: int) -> float:
    """``lr * min(count / warmup, 1)`` in float32 (``lr`` when warmup <= 0)."""
    lr, warmup = config.optim.lr, config.optim.warmup
    if warmup <= 0:
        return float(np.float32(lr))
    frac = min(np.float32(count) / np.float32(warmup), np.float32(1.0))
    return float(np.float32(lr) * frac)


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) -> state``
    applies the step to ``params`` in place (optax's ``update`` then
    ``apply_updates``)."""

    def __init__(self, config):
        self.config = config
        self.name = config.optim.optimizer
        if self.name not in ("Adam", "AdamW"):
            raise NotImplementedError(f"Optimizer {self.name} not supported yet!")
        self.grad_clip = float(config.optim.grad_clip)
        self.b1 = config.optim.beta1 if self.name == "Adam" else 0.9
        self.eps = config.optim.eps if self.name == "Adam" else AMSGRAD_EPS

    def init(self, params: Tensors) -> dict:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        device = next(iter(params.values())).device
        state = {"count": 0, "lr_count": 0, "mu": zeros(), "nu": zeros(), "clip": None}
        if self.name == "AdamW":
            state["nu_max"] = zeros()
        if self.grad_clip > 1.0:
            queue = torch.zeros(QUEUE_LEN, dtype=torch.float32, device=device)
            queue[0] = QUEUE_INIT
            state["clip"] = {"queue": queue, "count": 1}
        return state

    def _clip(self, grads: list, state: dict) -> list:
        """The clipped gradients; pushes onto the queue. No host sync."""
        if self.grad_clip < 0:
            return grads
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = state["clip"]
        if clip is None:  # clip_by_global_norm
            allowed = torch.tensor(self.grad_clip, device=gnorm.device)
            scale = torch.where(gnorm < allowed, torch.ones_like(gnorm), allowed / gnorm)
            return torch._foreach_mul(grads, scale)
        queue, count = clip["queue"], clip["count"]
        valid = (torch.arange(QUEUE_LEN, device=queue.device) < count).float()
        n = float(max(count, 1))
        mean = (queue * valid).sum() / n
        std = torch.sqrt(((valid * (queue - mean) ** 2).sum() / n).clamp_min(0.0))
        allowed = torch.clamp(1.5 * mean + 2.0 * std, max=self.grad_clip)
        scale = torch.clamp(allowed / gnorm.clamp_min(1e-12), max=1.0)
        clip["queue"] = torch.cat([torch.minimum(gnorm, allowed)[None], queue[:-1]])
        clip["count"] = min(count + 1, QUEUE_LEN)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors) -> dict:
        names = list(params)
        p = [params[k] for k in names]
        g = self._clip([grads[k].float() for k in names], state)
        if self.name == "Adam" and self.config.optim.weight_decay:
            g = torch._foreach_add(g, p, alpha=float(self.config.optim.weight_decay))
        mu, nu = [state["mu"][k] for k in names], [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(B2, count))
        if self.name == "AdamW":
            nu_max = [state["nu_max"][k] for k in names]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu_hat, denom)
        if self.name == "AdamW":
            torch._foreach_add_(u, p, alpha=ADAMW_DECAY)
        torch._foreach_mul_(u, -lr_at(self.config, state["lr_count"]))
        torch._foreach_add_(p, u)
        state["count"], state["lr_count"] = count, state["lr_count"] + 1
        return state


def get_optimizer(config) -> Optimizer:
    return Optimizer(config)
