"""Ancestral reverse diffusion (port of ``diffspectra_tpu/sampling/ancestral.py``).

The JAX sampler is one ``lax.scan``; here it is a Python loop over steps.
The per-step posterior coefficients are computed once, in float32 as in
JAX, and passed to the loop as Python floats.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import masks as M


def make_time_steps(noise_scheduler, steps: int, eps: float = 1e-3) -> torch.Tensor:
    """linspace(T, eps, steps), float32."""
    return torch.linspace(noise_scheduler.T, eps, steps, dtype=torch.float32)


class AncestralSampler:
    """Joint reverse diffusion of atoms and bonds.
    ``model(t, x, node_mask, edge_mask, edge_x, noise_level, cond_x,
    cond_edge_x, has_cond, context_emb) -> (pred, edge_pred)``. With
    ``only_2d`` the nodes have no position channels and their noise is
    masked, not centred; without ``pred_edge`` the edges stay as drawn and
    the model's edge prediction only feeds self-conditioning."""

    def __init__(self, noise_scheduler, time_steps: torch.Tensor, model_pred_data: bool,
                 self_cond: bool = False, cond_process_fn: Optional[Callable] = None,
                 sampling_temperature: float = 1.0, pred_edge: bool = True,
                 only_2d: bool = False):
        t = time_steps.to(torch.float32).cpu()
        s = torch.cat([t[1:], torch.zeros(1)])
        alpha_t, sigma_t = noise_scheduler.marginal_prob(t)
        alpha_s, sigma_s = noise_scheduler.marginal_prob(s)
        alpha_t_given_s = alpha_t / alpha_s
        sigma2_t_given_s = sigma_t**2 - alpha_t_given_s**2 * sigma_s**2
        sigma_t_given_s = torch.sqrt(sigma2_t_given_s)
        coef_sigma = sigma_t_given_s * sigma_s / sigma_t
        noise_level = torch.log(alpha_t**2 / sigma_t**2)
        if model_pred_data:
            coef_x = alpha_t_given_s * sigma_s**2 / sigma_t**2
            coef_pred = alpha_s * sigma2_t_given_s / sigma_t**2
        else:
            coef_x = 1.0 / alpha_t_given_s
            coef_pred = -sigma2_t_given_s / alpha_t_given_s / sigma_t
        self.steps = list(zip(t.tolist(), coef_x.tolist(), coef_pred.tolist(),
                              coef_sigma.tolist(), noise_level.tolist()))
        self.self_cond = self_cond
        self.cond_process_fn = cond_process_fn
        self.sampling_temperature = sampling_temperature
        self.pred_edge, self.only_2d = pred_edge, only_2d

    @torch.no_grad()
    def sampling(self, model, generator, z_T, node_mask, edge_mask, edge_z_T, context_emb):
        """Run the reverse loop from ``z_T``/``edge_z_T``; returns the final
        posterior means ``(x_mean, edge_x_mean)``, or ``x_mean`` alone
        without ``pred_edge``."""
        bs, n_nodes = z_T.shape[0], z_T.shape[1]
        x, edge_x = z_T, edge_z_T
        cond_x, cond_edge_x, has_cond = None, None, False
        x_mean = edge_x_mean = None
        temp = self.sampling_temperature
        for t, coef_x, coef_pred, coef_sigma, noise_level in self.steps:
            vec_t = torch.full((bs,), t, device=z_T.device)
            nl = torch.full((bs,), noise_level, device=z_T.device)
            pred, edge_pred = model(vec_t, x, node_mask, edge_mask, edge_x, nl,
                                    cond_x, cond_edge_x, has_cond, context_emb)
            if self.self_cond:
                if self.cond_process_fn is not None:
                    cond_x, cond_edge_x = self.cond_process_fn(pred, edge_pred)
                else:
                    cond_x, cond_edge_x = pred, edge_pred
                has_cond = True
            x_mean = coef_x * x + coef_pred * pred
            noise = M.sample_node_noise(generator, x.shape, node_mask, self.only_2d)
            x = x_mean + coef_sigma * noise * temp
            if not self.pred_edge:
                continue
            edge_x_mean = coef_x * edge_x + coef_pred * edge_pred
            edge_noise = M.sample_symmetric_edge_feature_noise(
                generator, bs, n_nodes, edge_x.shape[-1], edge_mask
            )
            edge_x = edge_x_mean + coef_sigma * edge_noise * temp
        return (x_mean, edge_x_mean) if self.pred_edge else x_mean
