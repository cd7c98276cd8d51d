"""Mixed edge-gated attention: the CUDA kernel ``csrc/mix_attention.cu`` and
its plain PyTorch version.

Port of ``diffspectra_tpu/ops/pallas_attention.py`` (``mix_attention`` and
``mix_attention_reference``), with the JAX layout at the public functions:
q, k ``[B, N, E, sc]``, v ``[B, N, H, C]``, edge_attr ``[B, N, N, De]``,
w0 ``[De, E*sc]``, w1 ``[De, H*C]``, extra ``[B, N, N, X]``,
edge_mask ``[B, N, N]`` -> ``[B, N, H*C]`` float32. q, k, v, edge_attr, w0
and w1 are all float32 or all bfloat16 (the JAX DMT in bfloat16 passes
them so); extra and edge_mask are float32. Either way the math is float32,
as the Pallas kernel casts every operand to float32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _lib
from ._row_tile import MMA_LD, RING, RowTilePlan, ld, ld16, row_tile_plan

MASK_INF = -1e30  # padded and diagonal pairs
NEG_ADJ = -1e10  # an adjacency head's zero entry
DTYPES = (torch.float32, torch.bfloat16)  # of q, k, v, edge_attr, w0 and w1


def launch_plan(batch: int, n: int, de: int, ec: int, hc: int, heads: int,
                bf16: bool = False) -> RowTilePlan:
    """The kernel's launch at these shapes (``csrc/mix_attention.cu``
    recomputes and checks it). Shared memory, float32 operands: the tile's
    edge slab (transposed) with the molecule's k, then the products; the
    slab again with v, then the messages; q of the tile's rows; the softmax
    weights; the weight ring; extra (up to a column a head) and the mask of
    the tile's pairs. bfloat16 operands: the slab (rows of pairs) and k or v
    in bfloat16, then the float32 products or messages; q in bfloat16; the
    softmax weights; W0, then W1, whole in bfloat16 (MMA_LD columns); extra
    and the mask."""
    def floats(tr, r):
        ldw = max(ld(ec), ld(hc))
        if bf16:
            ldq = ld16(max(ec, hc))
            front = max((tr * ld16(de) + n * ldq) // 2, tr * ldw)
            return front + r * ldq // 2 + tr * heads + de * MMA_LD // 2 + tr * (heads + 1)
        front = max(de * (tr + 4) + n * ldw, tr * ldw)
        return front + r * ld(ec) + tr * heads + RING + tr * (heads + 1)
    return row_tile_plan(batch, n, floats)


def mix_attention_reference(q, k, v, edge_attr, w0, w1, extra, edge_mask, *, set_inf=True):
    """Plain PyTorch version, the math of the JAX kernel: float32 from
    operands of either dtype."""
    q, k, v, edge_attr, w0, w1 = (t.float() for t in (q, k, v, edge_attr, w0, w1))
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
    dt = edge_attr.dtype
    if dt not in DTYPES:
        raise TypeError(f"mix_attention: edge_attr is {dt}, takes one of {DTYPES}")
    f32 = torch.float32
    device = _lib.check_inputs(
        "mix_attention",
        dict(q=q, k=k, v=v, edge_attr=edge_attr, w0=w0, w1=w1, extra=extra, edge_mask=edge_mask),
        dict(q=(B, N, n_sub, sub_c), k=(B, N, n_sub, sub_c), v=(B, N, n_heads, out_ch),
             edge_attr=(B, N, N, de), w0=(de, n_sub * sub_c), w1=(de, n_heads * out_ch),
             extra=(B, N, N, n_extra), edge_mask=(B, N, N)),
        dict(q=dt, k=dt, v=dt, edge_attr=dt, w0=dt, w1=dt, extra=f32, edge_mask=f32),
    )
    if device.type == "cpu":
        return mix_attention_reference(q, k, v, edge_attr, w0, w1, extra, edge_mask, set_inf=set_inf)
    ec, hc = n_sub * sub_c, n_heads * out_ch
    bf16 = dt == torch.bfloat16
    if N > 32 or ec > 256 or hc > 256 or ec % 4 or hc % 4 or (bf16 and de % 16):
        raise ValueError(f"mix_attention kernel: takes N <= 32, widths E*sc, H*C multiples of 4 "
                         f"up to 256 and, in bfloat16, De a multiple of 16, got N={N}, "
                         f"E*sc={ec}, H*C={hc}, De={de}")
    plan = launch_plan(B, N, de, ec, hc, n_heads, bf16)
    lib = _lib.build()
    out = torch.empty((B, N, hc), device=device, dtype=f32)
    ints = (ctypes.c_int * len(plan.ints()))(*plan.ints())
    rc = lib.dstt_mix_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), edge_attr.data_ptr(),
        w0.data_ptr(), w1.data_ptr(), extra.data_ptr(), edge_mask.data_ptr(),
        out.data_ptr(), B, N, de, n_sub, sub_c, n_heads, out_ch, n_extra,
        int(set_inf), int(bf16), ints, len(ints), _lib.stream_handle(device),
    )
    _lib.check_rc("mix_attention", rc)
    _lib.LAUNCHES["mix_attention_bf16" if bf16 else "mix_attention"] += 1
    return out
