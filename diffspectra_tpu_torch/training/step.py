"""The train and eval steps (port of ``diffspectra_tpu/training/step.py``).

``train_step(state, batch, draws) -> (state, loss)``: the loss of the
config's path (``make_loss_fn``) in training mode, its gradient with
respect to every parameter (zeros where a parameter does not reach the
loss, as ``jax.grad`` gives them), the clipped optimizer step, the bf16
weight copies made anew, then the EMA; SpecFormer's batch statistics move
inside the loss. ``eval_step(state, batch, draws, eval_model)``: the loss
with the EMA weights and the batch statistics loaded into ``eval_model``,
deterministic.

With ``mesh`` (``parallel.Mesh``, the counterpart of JAX's ``axis_name``)
the step runs on each rank's shard of the batch with that rank's draws,
and averages over the ranks, before the update, the gradients, the loss
and SpecFormer's new batch statistics (JAX's ``pmean``s), all three in one
buffer and one ``all_reduce`` (``parallel.pmean_``). The running statistics
move linearly in the batch's, so averaging them after the forward is
averaging the batch's. Every rank then takes the same update.
"""

from __future__ import annotations

import torch

from ..models import ema as ema_lib
from ..models.layers import refresh_casts
from ..parallel.mesh import pmean_
from .losses import get_sde_2d_loss_fn, get_sde_graph_loss_fn, get_sde_node_loss_fn
from .train_state import TrainState, params_of


def batch_stats_of(model: torch.nn.Module):
    """The model's persistent buffers: SpecFormer's running statistics."""
    params = dict(model.named_parameters())
    return [b for k, b in model.state_dict(keep_vars=True).items() if k not in params]


def load_ema_weights(state: TrainState, model: torch.nn.Module) -> torch.nn.Module:
    """``model`` (another instance of the state's model) holding the EMA
    parameters and the state's batch statistics, in eval mode; the load
    makes its bf16 weight copies anew."""
    buffers = {k: v for k, v in state.model.state_dict().items()
               if k not in state.ema.shadow_params}
    model.load_state_dict({**ema_lib.params(state.ema), **buffers}, strict=True)
    return model.eval()


def make_loss_fn(noise_scheduler, scaler, config):
    """The loss of the config's path: the graph loss, with ``only_2D`` the
    2-D loss, and without ``pred_edge`` the node loss."""
    if config.pred_edge:
        if config.only_2D:
            return get_sde_2d_loss_fn(noise_scheduler, scaler, config)
        return get_sde_graph_loss_fn(noise_scheduler, scaler, config)
    return get_sde_node_loss_fn(noise_scheduler, scaler, config)


def get_step_fn(noise_scheduler, tx, scaler, config, train: bool = True, mesh=None):
    loss_fn = make_loss_fn(noise_scheduler, scaler, config)

    def train_step(state: TrainState, batch, draws):
        model = state.model.train()
        params = params_of(model)
        loss = loss_fn(model, batch, draws)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        loss = loss.detach()
        if mesh is not None:
            pmean_([*grads, loss, *batch_stats_of(model)], mesh)
        grads = dict(zip(params, grads))
        state.opt_state = tx.update(grads, state.opt_state, params)
        refresh_casts(model)  # the bf16 copies that no-grad forwards read
        state.ema = ema_lib.update(state.ema, params)
        state.step += 1
        return state, loss

    @torch.no_grad()
    def eval_step(state: TrainState, batch, draws, eval_model):
        return state, loss_fn(load_ema_weights(state, eval_model), batch, draws)

    return train_step if train else eval_step
