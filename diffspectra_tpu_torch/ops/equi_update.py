"""Equivariant coordinate update: the CUDA kernel ``csrc/equi_update.cu``
and its plain PyTorch version.

Port of ``diffspectra_tpu/ops/pallas_equi_update.py``
(``equi_update_fused`` and ``equi_update_reference``), with the JAX layout
at the public functions: node_i, node_j ``[B, N, Dh]``, edge_attr
``[B, N, N, De]``, dist ``[B, N, N, Dd]``, normed_diff ``[B, N, N, 3]``,
adj_extra ``[B, N, N, A]``, edge_mask ``[B, N, N]``, w_e ``[De, Dh]``,
w_d ``[Dd, Dh]``, bias ``[Dh]``, shift, scale ``[B, Dh]``, w0 ``[Dh, Dh]``,
b0 ``[Dh]``, w1 ``[Dh, 1+A]`` -> the position delta ``[B, N, 3]`` float32.
node_i, node_j, edge_attr, dist, w_e, w_d and bias are all float32 or all
bfloat16 (the JAX DMT in bfloat16 passes them so); the rest is float32.
Either way the math is float32, as the Pallas kernel casts every operand
to float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _lib
from ._row_tile import MMA_LD, RING, RowTilePlan, ld16, row_tile_plan

DTYPES = (torch.float32, torch.bfloat16)  # of node_i, node_j, edge_attr, dist, w_e, w_d, bias


def launch_key(dd: int, bf16: bool) -> str:
    """The ``LAUNCHES`` key of a launch: ``equi_update``, with ``_dd1`` for
    a 1-wide dist (the DMT's ``dist_gbf=False``) and ``_bf16`` for
    bfloat16 operands."""
    return "equi_update" + ("_dd1" if dd == 1 else "") + ("_bf16" if bf16 else "")


def launch_plan(batch: int, n: int, de: int, dd: int, dh: int,
                bf16: bool = False) -> RowTilePlan:
    """The kernel's launch at these shapes (``csrc/equi_update.cu``
    recomputes and checks it). Shared memory, float32 operands: the tile's
    [edge | dist] slab (transposed), node_j and node_i, then the modulated
    pairs (transposed) over them; the weight ring (then the gates); the row
    sums of 4 warps for up to 4 gates; adj (up to 3), the mask and
    normed_diff of the tile's pairs. bfloat16 operands: the slab (rows of
    pairs), node_j and node_i in bfloat16, then the pairs; We, then Wd, whole
    in bfloat16 (MMA_LD columns), then the ring (then the gates); the rest
    as for float32. A 1-wide dist in bfloat16 is not in the slab: the
    kernel folds ``dist @ Wd`` into its epilogue."""
    def floats(tr, r):
        if bf16:
            slab = (tr * ld16(de if dd == 1 else de + dd) + (n + r) * ld16(dh)) // 2
            front, weights = max(dh * (tr + 4), slab), max(RING, max(de, dd) * MMA_LD // 2)
        else:
            front, weights = max(dh * (tr + 4), (de + dd) * (tr + 4) + (n + r) * dh), RING
        return front + weights + tr * 4 * 4 + tr * (4 + 3)
    return row_tile_plan(batch, n, floats)


def equi_update_reference(node_i, node_j, edge_attr, dist, normed_diff, adj_extra,
                          edge_mask, w_e, w_d, bias, shift, scale, w0, b0, w1,
                          *, eps_ln: float = 1e-6):
    """Plain PyTorch version, the math of the JAX kernel: float32 from
    operands of either dtype."""
    node_i, node_j, edge_attr, dist, w_e, w_d, bias = (
        t.float() for t in (node_i, node_j, edge_attr, dist, w_e, w_d, bias))
    pair = node_i[:, :, None, :] + node_j[:, None, :, :] + edge_attr @ w_e + dist @ w_d
    pair = pair + bias
    mu = pair.mean(dim=-1, keepdim=True)
    var = (pair - mu).square().mean(dim=-1, keepdim=True)
    pair = (pair - mu) * torch.rsqrt(var + eps_ln)
    pair = pair * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
    g = torch.tanh(F.silu(pair @ w0 + b0) @ w1)
    adjs = torch.cat([torch.ones_like(adj_extra[..., :1]), adj_extra], dim=-1)
    gate = (g * adjs).mean(dim=-1, keepdim=True)
    return (normed_diff * gate * edge_mask[..., None]).sum(dim=2)


def equi_update(node_i, node_j, edge_attr, dist, normed_diff, adj_extra, edge_mask,
                w_e, w_d, bias, shift, scale, w0, b0, w1, *, eps_ln: float = 1e-6):
    """CPU tensors: the plain version. CUDA tensors: the kernel."""
    B, N, dh = node_i.shape
    de, dd, n_adj = edge_attr.shape[-1], dist.shape[-1], adj_extra.shape[-1]
    dt = edge_attr.dtype
    if dt not in DTYPES:
        raise TypeError(f"equi_update: edge_attr is {dt}, takes one of {DTYPES}")
    f32 = torch.float32
    device = _lib.check_inputs(
        "equi_update",
        dict(node_i=node_i, node_j=node_j, edge_attr=edge_attr, dist=dist,
             normed_diff=normed_diff, adj_extra=adj_extra, edge_mask=edge_mask,
             w_e=w_e, w_d=w_d, bias=bias, shift=shift, scale=scale, w0=w0, b0=b0, w1=w1),
        dict(node_i=(B, N, dh), node_j=(B, N, dh), edge_attr=(B, N, N, de),
             dist=(B, N, N, dd), normed_diff=(B, N, N, 3), adj_extra=(B, N, N, n_adj),
             edge_mask=(B, N, N), w_e=(de, dh), w_d=(dd, dh), bias=(dh,), shift=(B, dh),
             scale=(B, dh), w0=(dh, dh), b0=(dh,), w1=(dh, 1 + n_adj)),
        dict(node_i=dt, node_j=dt, edge_attr=dt, dist=dt, normed_diff=f32, adj_extra=f32,
             edge_mask=f32, w_e=dt, w_d=dt, bias=dt, shift=f32, scale=f32, w0=f32, b0=f32,
             w1=f32),
    )
    if device.type == "cpu":
        return equi_update_reference(
            node_i, node_j, edge_attr, dist, normed_diff, adj_extra, edge_mask,
            w_e, w_d, bias, shift, scale, w0, b0, w1, eps_ln=eps_ln,
        )
    bf16 = dt == torch.bfloat16
    if N > 32 or dh % 4 or dh > 256 or n_adj > 3 or (bf16 and (de % 16 or dd % 16 and dd != 1)):
        raise ValueError(f"equi_update kernel: takes N <= 32, Dh a multiple of 4 up to 256, "
                         f"A <= 3 and, in bfloat16, De a multiple of 16 and Dd 1 or a multiple "
                         f"of 16, got N={N}, Dh={dh}, A={n_adj}, De={de}, Dd={dd}")
    plan = launch_plan(B, N, de, dd, dh, bf16)
    lib = _lib.build()
    out = torch.empty((B, N, 3), device=device, dtype=f32)
    ints = (ctypes.c_int * len(plan.ints()))(*plan.ints())
    rc = lib.dstt_equi_update(
        node_i.data_ptr(), node_j.data_ptr(), edge_attr.data_ptr(), dist.data_ptr(),
        normed_diff.data_ptr(), adj_extra.data_ptr(), edge_mask.data_ptr(),
        w_e.data_ptr(), w_d.data_ptr(), bias.data_ptr(), shift.data_ptr(),
        scale.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), out.data_ptr(),
        B, N, de, dd, dh, n_adj, int(bf16), eps_ln, ints, len(ints),
        _lib.stream_handle(device),
    )
    _lib.check_rc("equi_update", rc)
    _lib.LAUNCHES[launch_key(dd, bf16)] += 1
    return out
