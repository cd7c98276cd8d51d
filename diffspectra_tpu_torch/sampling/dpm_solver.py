"""DPM-Solver++(2M) and its SDE variant (port of
``diffspectra_tpu/sampling/dpm_solver.py``).

Second-order multistep DPM-Solver++ (Lu et al. 2022, arXiv:2211.01095) in
data-prediction space, with half-logSNR lambda and data prediction x0:

    h_i = lambda_i - lambda_{i-1},  r_i = h_{i-1} / h_i
    D_i = (1 + 1/(2 r)) x0_i - 1/(2 r) x0_{i-1}          (order 1 at i = 1)
    ODE: x_i = (sigma_i/sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} - 1) D_i
    SDE: x_i = (sigma_i/sigma_{i-1}) e^{-h_i} x_{i-1} + alpha_i (1 - e^{-2 h_i}) D_i
               + sigma_i sqrt(1 - e^{-2 h_i}) z

The JAX solver is one ``lax.scan``; here it is a Python loop over the
transitions, with the coefficients computed once in float32 as in JAX,
and a final model call at t = eps that returns x0. The ODE ignores
``sampling_temperature``; the SDE scales its injected noise by it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import masks as M


class DPMSolverPP:
    """Same ``sampling`` interface, ``only_2d`` and ``pred_edge`` as
    ``AncestralSampler``'s; without ``pred_edge`` the model's edge
    prediction is taken as it is (no conversion to x0)."""

    def __init__(self, noise_scheduler, time_steps: torch.Tensor, model_pred_data: bool,
                 self_cond: bool = False, cond_process_fn: Optional[Callable] = None,
                 sampling_temperature: float = 1.0, stochastic: bool = False,
                 pred_edge: bool = True, only_2d: bool = False):
        self.pred_edge, self.only_2d = pred_edge, only_2d
        self.model_pred_data = model_pred_data
        self.self_cond = self_cond
        self.cond_process_fn = cond_process_fn
        self.sampling_temperature = sampling_temperature
        self.stochastic = stochastic

        t = time_steps.to(torch.float32).cpu()  # t_0 = T ... t_{S-1} = eps
        lam = noise_scheduler.marginal_lambda(t)
        alpha, sigma = noise_scheduler.marginal_prob(t)
        self.t_array, self.alpha, self.sigma = t, alpha, sigma
        self.noise_levels = torch.log(alpha**2 / sigma**2)

        # transition i-1 -> i for i = 1..S-1
        h = lam[1:] - lam[:-1]
        r = torch.cat([torch.ones(1), h[:-1]]) / h
        if stochastic:
            e_h = torch.exp(-h)
            self.c_x = (sigma[1:] / sigma[:-1]) * e_h
            self.c_d = alpha[1:] * (1.0 - e_h**2)
            self.c_n = sigma[1:] * torch.sqrt(1.0 - e_h**2)
        else:
            self.c_x = sigma[1:] / sigma[:-1]
            self.c_d = -alpha[1:] * (torch.exp(-h) - 1.0)
            self.c_n = torch.zeros_like(h)
        # 2M blending weights; the first transition is order 1
        self.w_cur = 1.0 + 1.0 / (2.0 * r)
        self.w_prev = -1.0 / (2.0 * r)
        self.w_cur[0], self.w_prev[0] = 1.0, 0.0

    def _to_x0(self, x, pred, i: int):
        if self.model_pred_data:
            return pred
        return (x - self.sigma[i].item() * pred) / self.alpha[i].item()  # eps-hat -> x0

    @torch.no_grad()
    def sampling(self, model, generator, z_T, node_mask, edge_mask, edge_z_T, context_emb):
        """Run the solver from ``z_T``/``edge_z_T``; returns the final data
        predictions ``(x0, edge_x0)``, or ``x0`` alone without
        ``pred_edge``."""
        bs, n_nodes = z_T.shape[0], z_T.shape[1]
        dev = z_T.device
        temp = self.sampling_temperature
        cond_x = cond_edge_x = None
        has_cond = False

        def call_model(x, edge_x, i):
            vec_t = torch.full((bs,), self.t_array[i].item(), device=dev)
            nl = torch.full((bs,), self.noise_levels[i].item(), device=dev)
            pred, edge_pred = model(vec_t, x, node_mask, edge_mask, edge_x, nl,
                                    cond_x, cond_edge_x, has_cond, context_emb)
            if self.pred_edge:
                edge_pred = self._to_x0(edge_x, edge_pred, i)
            return self._to_x0(x, pred, i), edge_pred

        x, edge_x = z_T, edge_z_T
        prev_x0, prev_e0 = torch.zeros_like(x), 0.0  # the first transition reads neither
        steps = zip(self.c_x.tolist(), self.c_d.tolist(), self.c_n.tolist(),
                    self.w_cur.tolist(), self.w_prev.tolist())
        for i, (c_x, c_d, c_n, w_cur, w_prev) in enumerate(steps):
            x0, edge_x0 = call_model(x, edge_x, i)
            if self.self_cond:
                if self.cond_process_fn is not None:
                    cond_x, cond_edge_x = self.cond_process_fn(x0, edge_x0)
                else:
                    cond_x, cond_edge_x = x0, edge_x0
                has_cond = True
            x = c_x * x + c_d * (w_cur * x0 + w_prev * prev_x0)
            if self.pred_edge:
                edge_x = c_x * edge_x + c_d * (w_cur * edge_x0 + w_prev * prev_e0)
            if self.stochastic:
                noise = M.sample_node_noise(generator, x.shape, node_mask, self.only_2d)
                x = x + c_n * noise * temp
                if self.pred_edge:
                    edge_noise = M.sample_symmetric_edge_feature_noise(
                        generator, bs, n_nodes, edge_x.shape[-1], edge_mask
                    )
                    edge_x = edge_x + c_n * edge_noise * temp
            prev_x0, prev_e0 = x0, edge_x0

        # the final denoise to t = eps returns x0
        x0, edge_x0 = call_model(x, edge_x, len(self.t_array) - 1)
        return (x0, edge_x0) if self.pred_edge else x0
