"""Cosine VP-SDE schedule (port of the cosine branch of
``diffspectra_tpu/diffusion/schedule.py``): ``alpha_t``, ``sigma_t``,
``lambda_t = log(alpha_t / sigma_t)`` and its inverse. T = 0.9946, where the
cosine schedule is still numerically stable."""

from __future__ import annotations

import math

import torch


class NoiseScheduleVP:
    def __init__(self, schedule: str = "cosine", continuous_beta_0: float = 0.1,
                 continuous_beta_1: float = 20.0):
        # the linear schedule's betas (config.sde), which the cosine one ignores
        self.beta_0, self.beta_1 = continuous_beta_0, continuous_beta_1
        if schedule != "cosine":
            raise NotImplementedError(
                f"schedule {schedule!r}: the port serves the cosine schedule "
                "only (see ROADMAP.md)"
            )
        self.cosine_s = 0.008
        self.cosine_log_alpha_0 = math.log(
            math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2.0)
        )
        self.T = 0.9946

    def marginal_log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        log_alpha = torch.log(
            torch.cos((t + self.cosine_s) / (1.0 + self.cosine_s) * math.pi / 2.0)
        )
        return log_alpha - self.cosine_log_alpha_0

    def marginal_prob(self, t: torch.Tensor):
        """(alpha_t, sigma_t)."""
        log_mean = self.marginal_log_mean_coeff(t)
        return torch.exp(log_mean), torch.sqrt(1.0 - torch.exp(2.0 * log_mean))

    def marginal_lambda(self, t: torch.Tensor) -> torch.Tensor:
        """lambda_t = log(alpha_t) - log(sigma_t)."""
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb: torch.Tensor) -> torch.Tensor:
        """t such that ``marginal_lambda(t) == lamb``."""
        log_alpha = -0.5 * torch.logaddexp(-2.0 * lamb, torch.zeros_like(lamb))
        return (
            torch.arccos(torch.exp(log_alpha + self.cosine_log_alpha_0))
            * 2.0 * (1.0 + self.cosine_s) / math.pi
            - self.cosine_s
        )
