"""SpecFormer, the spectra encoder, in eval mode (port of
``diffspectra_tpu/models/specformer.py``).

Each spectrum (UV-Vis 701, IR 3501, Raman 3501 points) is cut into
overlapping patches, projected to ``d_model`` with a learned positional
embedding, and the concatenated tokens go through post-norm transformer
layers with residual attention scores and BatchNorm over channels (running
statistics from ``batch_stats``). A flatten head and an affine LayerNorm
(eps 1e-6) give the pooled ``[B, output_dim]`` embedding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, empty_param, gelu

SPECTRUM_LENGTHS = (701, 3501, 3501)  # uv, ir, raman
SPECTRA_VERSIONS = {"uv": (0,), "ir": (1,), "raman": (2,), "allspectra": (0, 1, 2)}
_POS_NAMES = ("W_pos_uv", "W_pos_ir", "W_pos_raman")


def used_spectra_indices(spectra_version: str) -> Tuple[int, ...]:
    if spectra_version not in SPECTRA_VERSIONS:
        raise ValueError("spectra_version should be uv, ir, raman or allspectra")
    return SPECTRA_VERSIONS[spectra_version]


def patch_count(length: int, patch_len: int, stride: int) -> int:
    return (length - patch_len) // stride + 1


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in eval mode over the last axis, eps 1e-5;
    ``mean``/``var`` are the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = empty_param(features)
        self.bias = empty_param(features)
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def forward(self, x):
        return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with its affine ``scale``/``bias``, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = empty_param(features)
        self.bias = empty_param(features)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, eps=self.eps)


class MultiheadAttention(nn.Module):
    """MHA whose pre-softmax scores carry to the next layer."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.W_Q = Dense(d_model, d_model)
        self.W_K = Dense(d_model, d_model)
        self.W_V = Dense(d_model, d_model)
        self.to_out = Dense(d_model, d_model)

    def forward(self, x, prev=None):
        B, L, D = x.shape
        H = self.n_heads
        dk = D // H
        q = self.W_Q(x).reshape(B, L, H, dk)
        k = self.W_K(x).reshape(B, L, H, dk)
        v = self.W_V(x).reshape(B, L, H, dk)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) * dk**-0.5
        if prev is not None:
            scores = scores + prev
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, L, D)
        return self.to_out(out), scores


class TSTEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm_attn = BatchNorm(d_model)
        self.ff1 = Dense(d_model, d_ff)
        self.ff2 = Dense(d_ff, d_model)
        self.norm_ffn = BatchNorm(d_model)

    def forward(self, src, prev=None):
        src2, scores = self.self_attn(src, prev)
        src = self.norm_attn(src + src2)
        src = self.norm_ffn(src + self.ff2(gelu(self.ff1(src))))
        return src, scores


class SpecFormer(nn.Module):
    def __init__(self, spectra_version: str = "ir", patch_len: Sequence[int] = (20, 50, 50),
                 stride: Sequence[int] = (10, 25, 25), output_dim: int = 256,
                 n_layers: int = 3, d_model: int = 128, n_heads: int = 16, d_ff: int = 256):
        super().__init__()
        self.used = used_spectra_indices(spectra_version)
        self.patch_len, self.stride = tuple(patch_len), tuple(stride)
        n_patches = 0
        for i in self.used:
            setattr(self, f"W_P_{i}", Dense(self.patch_len[i], d_model))
            p = patch_count(SPECTRUM_LENGTHS[i], self.patch_len[i], self.stride[i])
            name = _POS_NAMES[i] if spectra_version == "allspectra" else "W_pos"
            setattr(self, name, empty_param(p, d_model))
            n_patches += p
        self.pos_names = [
            _POS_NAMES[i] if spectra_version == "allspectra" else "W_pos" for i in self.used
        ]
        for li in range(n_layers):
            setattr(self, f"encoder_layer_{li}", TSTEncoderLayer(d_model, n_heads, d_ff))
        self.n_layers = n_layers
        self.head_linear = Dense(n_patches * d_model, output_dim)
        self.out_norm = LayerNorm(output_dim)

    def forward(self, specs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``specs``: one ``[B, L_i]`` tensor per used spectrum, in the
        order uv, ir, raman."""
        if len(specs) != len(self.used):
            raise ValueError(f"expected {len(self.used)} spectra, got {len(specs)}")
        tokens = []
        for i, pos_name, spec in zip(self.used, self.pos_names, specs):
            patches = spec.unfold(-1, self.patch_len[i], self.stride[i])
            z = getattr(self, f"W_P_{i}")(patches)
            tokens.append(z + getattr(self, pos_name))
        z = torch.cat(tokens, dim=1)
        scores = None
        for li in range(self.n_layers):
            z, scores = getattr(self, f"encoder_layer_{li}")(z, scores)
        return self.out_norm(self.head_linear(z.reshape(z.shape[0], -1)))
