"""Mixed edge-gated attention: the CUDA kernel ``csrc/mix_attention.cu`` and
its plain PyTorch version.

Port of ``diffspectra_tpu/ops/pallas_attention.py`` (``mix_attention`` and
``mix_attention_reference``), with the JAX layout at the public functions:
q, k ``[B, N, E, sc]``, v ``[B, N, H, C]``, edge_attr ``[B, N, N, De]``,
w0 ``[De, E*sc]``, w1 ``[De, H*C]``, extra ``[B, N, N, X]``,
edge_mask ``[B, N, N]`` -> ``[B, N, H*C]``, all float32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _lib
from ._row_tile import RING, RowTilePlan, ld, row_tile_plan

MASK_INF = -1e30  # padded and diagonal pairs
NEG_ADJ = -1e10  # an adjacency head's zero entry


def launch_plan(batch: int, n: int, de: int, ec: int, hc: int, heads: int) -> RowTilePlan:
    """The kernel's launch at these shapes (``csrc/mix_attention.cu``
    recomputes and checks it). Shared memory: the tile's edge slab
    (transposed) with the molecule's k, then the products; the slab again
    with v, then the messages; q of the tile's rows; the softmax weights;
    the weight ring; extra (up to a column a head) and the mask of the
    tile's pairs."""
    def floats(tr, r):
        ldw = max(ld(ec), ld(hc))
        front = max(de * (tr + 4) + n * ldw, tr * ldw)
        return front + r * ld(ec) + tr * heads + RING + tr * (heads + 1)
    return row_tile_plan(batch, n, floats)


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
    ec, hc = n_sub * sub_c, n_heads * out_ch
    if N > 32 or ec > 256 or hc > 256 or ec % 4 or hc % 4:
        raise ValueError(f"mix_attention kernel: takes N <= 32 and widths E*sc, H*C multiples "
                         f"of 4 up to 256, got N={N}, E*sc={ec}, H*C={hc}")
    plan = launch_plan(B, N, de, ec, hc, n_heads)
    lib = _lib.build()
    out = torch.empty((B, N, hc), device=device, dtype=torch.float32)
    ints = (ctypes.c_int * len(plan.ints()))(*plan.ints())
    rc = lib.dstt_mix_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), edge_attr.data_ptr(),
        w0.data_ptr(), w1.data_ptr(), extra.data_ptr(), edge_mask.data_ptr(),
        out.data_ptr(), B, N, de, n_sub, sub_c, n_heads, out_ch, n_extra,
        int(set_inf), ints, len(ints), _lib.stream_handle(device),
    )
    _lib.check_rc("mix_attention", rc)
    _lib.LAUNCHES["mix_attention"] += 1
    return out
