"""Decode sampled tensors into discrete molecules (port of
``diffspectra_tpu/sampling/decode.py``): un-normalise, argmax the atom
types, threshold edge existence at 0.5 and quantise the bond order x3; a
third, aromatic channel (``data.include_aromatic``) gives order 4."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def quantize_edges(h_edge: torch.Tensor) -> torch.Tensor:
    """Compressed edge channels ``[B, N, N, 2]`` (exists, order/3) -> bond
    orders ``[B, N, N]`` in {0, 1, 2, 3}. With a third channel (aromatic),
    an existing pair whose aromatic channel reaches 0.5 and which has no
    other order is aromatic, 4."""
    exist = (h_edge[..., 0] >= 0.5).to(h_edge.dtype)
    et = h_edge[..., 1] * 3.0
    one = torch.ones_like(et)
    edge_type = exist * torch.where(et >= 2.5, 3.0 * one, torch.where(
        et >= 1.5, 2.0 * one, torch.where(et >= 0.5, one, 0.0 * one)))
    if h_edge.shape[-1] == 3:
        aroma = (h_edge[..., 2] >= 0.5).to(h_edge.dtype) * exist
        edge_type = torch.where((aroma > 0) & (edge_type == 0), 4.0 * one, edge_type)
    return edge_type


def post_process(xh, atom_types: int, node_mask, inverse_scaler, edge_x, edge_mask,
                 include_charge: bool = True, has_positions: bool = True):
    """Split and discretise ``(xh, edge_x)``, whose last node channel is the
    formal charge with ``include_charge`` (else the charge is a zero-width
    channel), into ``(pos, one_hot, formal_charge, edge_types)``; without
    ``has_positions`` (the 2-D path) ``xh`` has no position channels and
    ``pos`` is None."""
    pos, h = (xh[:, :, :3], xh[:, :, 3:]) if has_positions else (None, xh)
    if include_charge:
        h_int, h_cat = h[:, :, -1:], h[:, :, :-1]
    else:
        h_int, h_cat = h[:, :, :0], h
    if h_cat.shape[-1] != atom_types:
        raise ValueError(f"expected {atom_types} atom-type channels, got {h_cat.shape[-1]}")
    pos, h_cat, h_int, h_edge = inverse_scaler(pos, h_cat, h_int, node_mask, edge_x, edge_mask)
    one_hot = F.one_hot(h_cat.argmax(dim=2), atom_types).to(xh.dtype) * node_mask
    fc = torch.round(h_int) * node_mask
    return pos, one_hot, fc, quantize_edges(h_edge)


def mol_process(one_hot, pos, formal_charges, n_nodes, edge_types) -> List[Tuple]:
    """Per-molecule host tuples ``(pos, atom_type, edge_type, fc)`` trimmed
    to the true atom count; ``fc`` int64 ``[n]``, or the zero-width ``[n,
    0]`` of a model without a charge channel, as the JAX decode leaves it;
    ``pos`` None (the 2-D path) gives None positions."""
    one_hot = one_hot.cpu().numpy()
    pos_np = None if pos is None else pos.cpu().numpy()
    fc_np = formal_charges.cpu().numpy()
    edge_np = edge_types.cpu().numpy()
    mols = []
    for i, n in enumerate(np.asarray(n_nodes).tolist()):
        fc = fc_np[i, :n, 0].astype(np.int64) if fc_np.shape[-1] else fc_np[i, :n]
        p = None if pos_np is None else pos_np[i, :n]
        mols.append((p, one_hot[i, :n].argmax(axis=1), edge_np[i, :n, :n], fc))
    return mols
