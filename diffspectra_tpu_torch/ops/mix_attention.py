"""Mixed edge-gated attention: the CUDA kernel ``csrc/mix_attention.cu`` and
its plain PyTorch version.

Port of ``diffspectra_tpu/ops/pallas_attention.py`` (``mix_attention`` and
``mix_attention_reference``), with the JAX layout at the public functions:
q, k ``[B, N, E, sc]``, v ``[B, N, H, C]``, edge_attr ``[B, N, N, De]``,
w0 ``[De, E*sc]``, w1 ``[De, H*C]``, extra ``[B, N, N, X]``,
edge_mask ``[B, N, N]`` -> ``[B, N, H*C]``, all float32.
"""

from __future__ import annotations

import math

import torch

from . import _lib

MASK_INF = -1e30  # padded and diagonal pairs
NEG_ADJ = -1e10  # an adjacency head's zero entry


def mix_attention_reference(q, k, v, edge_attr, w0, w1, extra, edge_mask, *, set_inf=True):
    """Plain PyTorch version, the same math as the JAX reference."""
    B, N, n_sub, sub_c = q.shape
    n_heads, out_ch = v.shape[2], v.shape[3]
    e0 = torch.tanh(edge_attr @ w0).reshape(B, N, N, n_sub, sub_c)
    e1 = torch.tanh(edge_attr @ w1).reshape(B, N, N, n_heads, out_ch)
    logits = torch.einsum("bihc,bjhc,bijhc->bijh", q, k, e0) / math.sqrt(out_ch)
    if set_inf:
        extra = torch.where(extra == 0.0, torch.full_like(extra, NEG_ADJ), extra)
    alpha = torch.cat([extra, logits], dim=-1)
    alpha = torch.where(edge_mask[..., None] > 0, alpha, torch.full_like(alpha, MASK_INF))
    alpha = torch.softmax(alpha, dim=2)
    out = torch.einsum("bijh,bjhc,bijhc->bihc", alpha, v, e1)
    return out.reshape(B, N, n_heads * out_ch)


def mix_attention(q, k, v, edge_attr, w0, w1, extra, edge_mask, *, set_inf=True):
    """CPU tensors: the plain version. CUDA tensors: the kernel."""
    B, N, n_sub, sub_c = q.shape
    n_heads, out_ch = v.shape[2], v.shape[3]
    de, n_extra = edge_attr.shape[-1], extra.shape[-1]
    if n_extra + n_sub != n_heads:
        raise ValueError(f"mix_attention: {n_extra} extra + {n_sub} learned heads != {n_heads}")
    device = _lib.check_inputs(
        "mix_attention",
        dict(q=q, k=k, v=v, edge_attr=edge_attr, w0=w0, w1=w1, extra=extra, edge_mask=edge_mask),
        dict(q=(B, N, n_sub, sub_c), k=(B, N, n_sub, sub_c), v=(B, N, n_heads, out_ch),
             edge_attr=(B, N, N, de), w0=(de, n_sub * sub_c), w1=(de, n_heads * out_ch),
             extra=(B, N, N, n_extra), edge_mask=(B, N, N)),
    )
    if device.type == "cpu":
        return mix_attention_reference(q, k, v, edge_attr, w0, w1, extra, edge_mask, set_inf=set_inf)
    if N > 32 or max(n_sub * sub_c, n_heads * out_ch) > 1024:
        raise ValueError(f"mix_attention kernel: takes N <= 32 and widths <= 1024, got N={N}")
    lib = _lib.build()
    out = torch.empty((B, N, n_heads * out_ch), device=device, dtype=torch.float32)
    rc = lib.dstt_mix_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), edge_attr.data_ptr(),
        w0.data_ptr(), w1.data_ptr(), extra.data_ptr(), edge_mask.data_ptr(),
        out.data_ptr(), B, N, de, n_sub, sub_c, n_heads, out_ch, n_extra,
        int(set_inf), _lib.stream_handle(device),
    )
    _lib.check_rc("mix_attention", rc)
    _lib.LAUNCHES["mix_attention"] += 1
    return out
