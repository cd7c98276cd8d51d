"""VP-SDE noise schedules in the DPM-Solver parameterisation (port of
``diffspectra_tpu/diffusion/schedule.py``): ``alpha_t``, ``sigma_t``,
``lambda_t = log(alpha_t / sigma_t)``, its inverse and the log SNR, for the
schedules ``discrete`` (from ``betas`` or ``alphas_cumprod``),
``discrete_poly``, ``linear`` and ``cosine``. T is 1.0 for each but
``cosine``, whose T is 0.9946, where it is still numerically stable. Every
value is float32, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

SCHEDULES = ("discrete", "linear", "cosine", "discrete_poly")


def interpolate_fn(x: torch.Tensor, xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of ``x [N]`` through the keypoints
    ``xp [K]`` (ascending) and ``yp [K]``, extrapolated linearly from the
    outermost segments. Differentiable."""
    K = xp.shape[0]
    idx = torch.searchsorted(xp, x.contiguous(), right=True)
    start = (idx - 1).clamp(0, K - 2)
    x0, x1, y0, y1 = xp[start], xp[start + 1], yp[start], yp[start + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _linspace(stop: float, num: int) -> torch.Tensor:
    """``num`` float32 points from 0 to ``stop`` as ``jnp.linspace(0, stop,
    num)`` gives them on the CPU: ``i * float32(stop / (num - 1))``, the
    last point ``stop`` (``torch.linspace`` differs in the last bit, and
    the polynomial schedule's tail, ``1 - (x / steps)^2`` near 0, magnifies
    that to 2e-5)."""
    div = num - 1
    out = torch.arange(div, dtype=torch.float32) * torch.tensor(stop / div, dtype=torch.float32)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32)])


def get_polynomial_schedule(time_steps: int, s: float = 1e-4, power: float = 2.0) -> torch.Tensor:
    """``alphas_cumprod`` (alpha^2) of the polynomial schedule 1 - x^power
    with each step's ratio clipped to [0.001, 1], of length
    ``time_steps``."""
    steps = time_steps + 1
    x = _linspace(steps, steps)
    alphas2 = (1 - torch.pow(x / steps, power)) ** 2
    alphas2 = torch.cat([torch.ones(1), alphas2])
    alphas_step = (alphas2[1:] / alphas2[:-1]).clamp(0.001, 1.0)
    alphas2 = torch.cumprod(alphas_step, dim=0)
    precision = 1 - 2 * s
    return (precision * alphas2 + s)[1:]


class NoiseScheduleVP:
    """The forward VP-SDE's marginals. ``discrete`` takes ``betas`` or
    ``alphas_cumprod``; ``linear`` reads ``continuous_beta_0`` and
    ``continuous_beta_1``; ``cosine`` and ``discrete_poly`` read neither.
    ``from_config`` builds the schedule of ``config.sde``."""

    def __init__(self, schedule: str = "discrete", betas=None, alphas_cumprod=None,
                 continuous_beta_0: float = 0.1, continuous_beta_1: float = 20.0):
        if schedule not in SCHEDULES:
            raise ValueError(f"Unsupported noise schedule {schedule}")
        self.schedule = schedule
        if "discrete" in schedule:
            if schedule == "discrete_poly":
                log_alphas = 0.5 * torch.log(get_polynomial_schedule(1000, power=2))
            elif betas is not None:
                betas = torch.as_tensor(betas, dtype=torch.float32)
                log_alphas = 0.5 * torch.cumsum(torch.log(1 - betas), dim=0)
            elif alphas_cumprod is not None:
                log_alphas = 0.5 * torch.log(torch.as_tensor(alphas_cumprod, dtype=torch.float32))
            else:
                raise ValueError("the 'discrete' schedule takes betas or alphas_cumprod")
            self.total_N = log_alphas.shape[0]
            self.T = 1.0
            self.t_array = _linspace(1.0, self.total_N + 1)[1:]
            self.log_alpha_array = log_alphas
        else:
            self.total_N = 1000
            self.beta_0, self.beta_1 = continuous_beta_0, continuous_beta_1
            self.cosine_s = 0.008
            self.cosine_log_alpha_0 = math.log(
                math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2.0))
            self.T = 0.9946 if schedule == "cosine" else 1.0

    @classmethod
    def from_config(cls, config) -> "NoiseScheduleVP":
        """``config.sde``'s schedule with its ``continuous_beta_0/1``."""
        sde = config.sde
        return cls(sde.schedule, continuous_beta_0=sde.continuous_beta_0,
                   continuous_beta_1=sde.continuous_beta_1)

    def _keypoints(self, like: torch.Tensor):
        return self.t_array.to(like.device), self.log_alpha_array.to(like.device)

    def marginal_log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """log(alpha_t)."""
        if "discrete" in self.schedule:
            t_array, log_alpha = self._keypoints(t)
            return interpolate_fn(t.reshape(-1), t_array, log_alpha).reshape(t.shape)
        if self.schedule == "linear":
            return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        log_alpha = torch.log(
            torch.cos((t + self.cosine_s) / (1.0 + self.cosine_s) * math.pi / 2.0))
        return log_alpha - self.cosine_log_alpha_0

    def marginal_alpha(self, t: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

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
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * torch.logaddexp(
                -2.0 * lamb, torch.zeros_like(lamb))
            delta = self.beta_0**2 + tmp
            return tmp / (torch.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        if "discrete" in self.schedule:
            log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
            t_array, log_alphas = self._keypoints(lamb)
            # log_alpha falls with t: interpolate through the flipped keypoints
            return interpolate_fn(log_alpha.reshape(-1), log_alphas.flip(0),
                                  t_array.flip(0)).reshape(lamb.shape)
        log_alpha = -0.5 * torch.logaddexp(-2.0 * lamb, torch.zeros_like(lamb))
        return (torch.arccos(torch.exp(log_alpha + self.cosine_log_alpha_0))
                * 2.0 * (1.0 + self.cosine_s) / math.pi - self.cosine_s)

    def get_noiseLevel(self, t: torch.Tensor) -> torch.Tensor:
        """The log SNR, log(alpha_t^2 / sigma_t^2)."""
        alpha, sigma = self.marginal_alpha(t), self.marginal_std(t)
        return torch.log(alpha**2 / sigma**2)
