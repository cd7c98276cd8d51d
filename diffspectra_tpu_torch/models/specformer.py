"""SpecFormer, the spectra encoder (port of
``diffspectra_tpu/models/specformer.py``).

Each spectrum (UV-Vis 701, IR 3501, Raman 3501 points) is cut into
overlapping patches, projected to ``d_model`` with a learned positional
embedding, and the concatenated tokens go through post-norm transformer
layers with residual attention scores and BatchNorm over channels. A
flatten head and an affine LayerNorm (eps 1e-6) give the pooled
``[B, output_dim]`` embedding. In eval mode BatchNorm reads its running
statistics (``batch_stats``); in training mode it normalises with the
batch's and updates the running ones, and dropout (0 in the DMT, as in the
JAX package) draws from the generator ``forward`` is given. For the
masked-patch pretraining (``training/pretrain.py``), ``forward`` zeroes the
patches its ``patch_masks`` name before the projection and, with
``return_tokens``, also returns the encoder's tokens.

``dtype`` is the JAX module's ``dtype`` (the DMT's working dtype under
``model.specformer_bf16``, else float32): in bfloat16 the patch
projections, ``W_Q``/``W_K``/``W_V``, the score and value products,
``to_out`` and ``ff1``/``ff2`` run in bfloat16, cast where flax casts
them; the scores, softmax, BatchNorms, residuals, flatten head and
``out_norm`` stay float32. A product that only a cast to float32 reads
keeps its bias add in float32 (``Dense.forward_f32``), as XLA compiles it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, dropout, empty_param, gelu, product

SPECTRUM_LENGTHS = (701, 3501, 3501)  # uv, ir, raman
SPECTRA_VERSIONS = {"uv": (0,), "ir": (1,), "raman": (2,), "allspectra": (0, 1, 2)}
_POS_NAMES = ("W_pos_uv", "W_pos_ir", "W_pos_raman")


def used_spectra_indices(spectra_version: str) -> Tuple[int, ...]:
    if spectra_version not in SPECTRA_VERSIONS:
        raise ValueError("spectra_version should be uv, ir, raman or allspectra")
    return SPECTRA_VERSIONS[spectra_version]


def patch_count(length: int, patch_len: int, stride: int) -> int:
    return (length - patch_len) // stride + 1


def unfold_patches(spec: torch.Tensor, patch_len: int, stride: int) -> torch.Tensor:
    """``[B, L] -> [B, n_patches, patch_len]``, overlapping windows."""
    return spec.unfold(-1, patch_len, stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the last axis, eps 1e-5;
    ``mean``/``var`` are the running statistics. Training mode: the batch's
    mean and flax's biased variance (``E[x^2] - E[x]^2``, clipped at 0) over
    every other axis normalise ``x``, and the running statistics become
    ``0.9 * running + 0.1 * batch`` (torch's ``BatchNorm1d`` would keep an
    unbiased running variance)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = empty_param(features)
        self.bias = empty_param(features)
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))
        self.eval()  # running statistics until train(), as the JAX module's default

    def forward(self, x):
        if not self.training:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


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
    """MHA whose pre-softmax scores (float32) carry to the next layer."""

    def __init__(self, d_model: int, n_heads: int, attn_dropout: float = 0.0,
                 proj_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.attn_dropout, self.proj_dropout = attn_dropout, proj_dropout
        self.W_Q = Dense(d_model, d_model, dtype=dtype)
        self.W_K = Dense(d_model, d_model, dtype=dtype)
        self.W_V = Dense(d_model, d_model, dtype=dtype)
        self.to_out = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x, prev=None, generator=None):
        B, L, D = x.shape
        H, dt = self.n_heads, self.dtype
        dk = D // H
        q = self.W_Q(x).reshape(B, L, H, dk)
        k = self.W_K(x).reshape(B, L, H, dk)
        v = self.W_V(x).reshape(B, L, H, dk)
        scores = product("bihd,bjhd->bhij", q, k, dtype=dt).float()
        if prev is not None and dt != torch.float32:
            # one fused multiply-add, as XLA fuses the scale and the carry
            scores = torch.add(prev, scores, alpha=dk**-0.5)
        else:
            scores = scores * dk**-0.5
            if prev is not None:
                scores = scores + prev
        attn = dropout(torch.softmax(scores, dim=-1).to(dt), self.attn_dropout, generator)
        out = product("bhij,bjhd->bihd", attn, v, dtype=dt).reshape(B, L, D)
        return dropout(self.to_out.forward_f32(out), self.proj_dropout, generator), scores


class TSTEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, n_heads, attn_dropout, dropout, dtype)
        self.norm_attn = BatchNorm(d_model)
        self.ff1 = Dense(d_model, d_ff, dtype=dtype)
        self.ff2 = Dense(d_ff, d_model, dtype=dtype)
        self.norm_ffn = BatchNorm(d_model)

    def forward(self, src, prev=None, generator=None):
        p = self.dropout
        src2, scores = self.self_attn(src, prev, generator)
        src = self.norm_attn(src + dropout(src2, p, generator))
        ff = self.ff2.forward_f32(dropout(gelu(self.ff1(src)), p, generator))
        src = self.norm_ffn(src + dropout(ff, p, generator))
        return src, scores


class SpecFormer(nn.Module):
    def __init__(self, spectra_version: str = "ir", patch_len: Sequence[int] = (20, 50, 50),
                 stride: Sequence[int] = (10, 25, 25), output_dim: int = 256,
                 n_layers: int = 3, d_model: int = 128, n_heads: int = 16, d_ff: int = 256,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.d_model = dropout, d_model
        self.used = used_spectra_indices(spectra_version)
        self.patch_len, self.stride = tuple(patch_len), tuple(stride)
        n_patches = 0
        for i in self.used:
            setattr(self, f"W_P_{i}", Dense(self.patch_len[i], d_model, dtype=dtype))
            p = patch_count(SPECTRUM_LENGTHS[i], self.patch_len[i], self.stride[i])
            name = _POS_NAMES[i] if spectra_version == "allspectra" else "W_pos"
            setattr(self, name, empty_param(p, d_model))
            n_patches += p
        self.pos_names = [
            _POS_NAMES[i] if spectra_version == "allspectra" else "W_pos" for i in self.used
        ]
        for li in range(n_layers):
            setattr(self, f"encoder_layer_{li}",
                    TSTEncoderLayer(d_model, n_heads, d_ff, dropout, attn_dropout, dtype))
        self.n_layers = n_layers
        self.head_linear = Dense(n_patches * d_model, output_dim)
        self.out_norm = LayerNorm(output_dim)
        self.eval()

    def normalize_context(self, context) -> Tuple[torch.Tensor, ...]:
        """One ``[B, L]`` tensor per used spectrum from a tensor or a
        sequence of them, each ``[B, L]`` or ``[B, 1, L]``; another count of
        spectra than the version uses raises."""
        specs = list(context) if isinstance(context, (list, tuple)) else [context]
        if len(specs) != len(self.used):
            raise ValueError(f"expected {len(self.used)} spectra, got {len(specs)}")
        return tuple(s.reshape(s.shape[0], s.shape[-1]) if s.dim() == 3 else s for s in specs)

    def forward(self, specs: Sequence[torch.Tensor], generator=None, patch_masks=None,
                return_tokens: bool = False):
        """``specs``: one ``[B, L_i]`` tensor per used spectrum, in the
        order uv, ir, raman; ``generator`` draws the dropout masks in
        training mode. ``patch_masks``: one ``[B, n_patches_i]`` tensor per
        spectrum, a patch above 0 zeroed before the projection. Returns the
        ``[B, output_dim]`` embedding, and with ``return_tokens`` also the
        ``[B, P, d_model]`` tokens of the last encoder layer."""
        specs = self.normalize_context(specs)
        generator = generator if self.training else None
        tokens = []
        for slot, (i, pos_name, spec) in enumerate(zip(self.used, self.pos_names, specs)):
            patches = unfold_patches(spec, self.patch_len[i], self.stride[i])
            if patch_masks is not None:
                patches = torch.where(patch_masks[slot][..., None] > 0,
                                      torch.zeros((), dtype=patches.dtype,
                                                  device=patches.device), patches)
            z = getattr(self, f"W_P_{i}").forward_f32(patches)
            tokens.append(dropout(z + getattr(self, pos_name), self.dropout, generator))
        z = torch.cat(tokens, dim=1)
        scores = None
        for li in range(self.n_layers):
            z, scores = getattr(self, f"encoder_layer_{li}")(z, scores, generator)
        pooled = self.out_norm(self.head_linear(z.reshape(z.shape[0], -1)))
        return (pooled, z) if return_tokens else pooled
