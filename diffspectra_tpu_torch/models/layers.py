"""Dense graph-transformer layers (port of ``diffspectra_tpu/models/layers.py``).

Parameters keep flax's names and layouts (a Dense ``kernel`` is
``[in, out]``), so a flax parameter path maps one to one onto a
``state_dict`` key (see ``warm_state.params_from_flax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mix_attention import mix_attention


def empty_param(*shape):
    return nn.Parameter(torch.empty(*shape))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel [in, out]``.
    Parameters start empty; they are always loaded from a checkpoint."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = empty_param(in_features, features)
        self.bias = empty_param(features) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


def layer_norm(x, eps: float = 1e-6):
    """flax ``nn.LayerNorm(use_bias=False, use_scale=False)``, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def modulate(x, shift, scale):
    """adaLN modulation."""
    return x * (1 + scale) + shift


def gelu(x):
    """flax ``nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class LearnedSinusoidalPosEmb(nn.Module):
    """``[B] -> [B, dim + 1]`` = [x, sin(2 pi x w), cos(2 pi x w)]."""

    def __init__(self, dim: int = 16):
        super().__init__()
        self.weights = empty_param(dim // 2)

    def forward(self, x):
        x = x[:, None]
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def _gaussian(x, mean, std):
    pi = 3.14159  # the reference's value, kept for parity
    a = (2 * pi) ** 0.5
    return torch.exp(-0.5 * ((x - mean) / std) ** 2) / (a * std)


class CondGaussianLayer(nn.Module):
    """Gaussian basis of squared distances ``[B, N, N, 1] -> [B, N, N, K]``
    with a time-conditioned scale and shift of the input; ``time_mlp``
    output column 0 is the scale, column 1 the shift."""

    def __init__(self, K: int, time_dim: int):
        super().__init__()
        self.means = empty_param(K - 1)
        self.stds = empty_param(K - 1)
        self.time_mlp = Dense(time_dim, 2)

    def forward(self, x, time_emb):
        _, _, scale, shift = self.export_params(time_emb)
        x = x * (scale[:, None, None, None] + 1) + shift[:, None, None, None]
        std = self.stds.abs() + 1e-5
        return torch.cat([x, _gaussian(x, self.means, std)], dim=-1)

    def export_params(self, time_emb):
        """``(means, stds, scale [B], shift [B])`` for the whole-block
        kernel, which applies the basis on the pair grid itself."""
        ss = self.time_mlp(F.silu(time_emb))
        return self.means, self.stds, ss[:, 0], ss[:, 1]


class CoorsNorm(nn.Module):
    """Unit-length coordinate vectors times a learned scale. The
    double-where keeps exactly-zero vectors (the diagonal) at 0."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.scale = empty_param(1)

    def forward(self, coors):
        sq = (coors * coors).sum(dim=-1, keepdim=True)
        is_zero = sq <= self.eps * self.eps
        norm = torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq))
        normed = torch.where(is_zero, torch.zeros_like(coors), coors / norm.clamp_min(self.eps))
        return normed * self.scale


class DenseTransMixLayer(nn.Module):
    """Dense masked multi-head attention with edge-gated logits and values
    and ``extra_heads`` raw adjacency heads; the pair-grid part is the
    ``mix_attention`` kernel. ``x [B, N, D]``, ``edge_attr [B, N, N, De]``,
    ``extra_heads [B, N, N, n]``, ``edge_mask [B, N, N]`` -> ``[B, N, H*C]``.
    The learned logits are scaled by ``1/sqrt(out_channels)``."""

    def __init__(self, x_channels: int, out_channels: int, edge_dim: int,
                 extra_heads: int = 2, heads: int = 4, set_inf: bool = False):
        super().__init__()
        self.heads, self.extra_heads, self.out_channels = heads, extra_heads, out_channels
        self.set_inf = set_inf
        n_sub = heads - extra_heads
        self.sub_c = heads * out_channels // n_sub
        self.lin_query = Dense(x_channels, n_sub * self.sub_c)
        self.lin_key = Dense(x_channels, n_sub * self.sub_c)
        self.lin_value = Dense(x_channels, heads * out_channels)
        self.lin_edge0_kernel = empty_param(edge_dim, n_sub * self.sub_c)
        self.lin_edge1_kernel = empty_param(edge_dim, heads * out_channels)

    def forward(self, x, edge_attr, extra_heads, edge_mask):
        n_cur = extra_heads.shape[-1]
        if n_cur != self.extra_heads:
            extra_heads = extra_heads.repeat_interleave(self.extra_heads // n_cur, dim=-1)
        B, N, _ = x.shape
        n_sub = self.heads - self.extra_heads
        q, k, v, w0, w1 = self.export_for_block(x)
        return mix_attention(
            q.reshape(B, N, n_sub, self.sub_c), k.reshape(B, N, n_sub, self.sub_c),
            v.reshape(B, N, self.heads, self.out_channels), edge_attr, w0, w1,
            extra_heads, edge_mask, set_inf=self.set_inf,
        )

    def export_for_block(self, x):
        """The node-level ``q, k [B, N, E*sc]``, ``v [B, N, H*C]`` and the
        raw edge-gate kernels, for the whole-block kernel."""
        return (self.lin_query(x), self.lin_key(x), self.lin_value(x),
                self.lin_edge0_kernel, self.lin_edge1_kernel)
