"""Data scaler, its inverse and self-conditioning post-processing (port of
``diffspectra_tpu/utils/scalers.py``). One-hots are centred to [-1, 1] and
divided by the per-channel factors '1, 4, 4, 1' (pos, atom types, formal
charge, edges), all masked. Without ``model.include_fc_charge`` the formal
charge is a zero-width channel."""

from __future__ import annotations

from typing import Sequence

import torch


def parse_normalize_factors(normalize_factors) -> Sequence[float]:
    """'1, 4, 4, 1' -> (1., 4., 4., 1.); a 3-tuple gets edge_norm=1."""
    if isinstance(normalize_factors, str):
        factors = [float(x) for x in normalize_factors.split(",")]
    else:
        factors = [float(x) for x in normalize_factors]
    if len(factors) == 3:
        factors = factors + [1.0]
    return tuple(factors)


def get_data_scaler(config):
    """The forward normaliser the training loss applies to a batch:
    ``(pos, atom_type, fc_charge[, edge_type])``, the edges where given;
    ``pos`` None (the 2-D path) stays None."""
    pos_norm, atom_type_norm, fc_norm, edge_norm = parse_normalize_factors(
        config.model.normalize_factors
    )
    centered = config.data.centered

    def scale_fn(pos, atom_type, fc_charge, node_mask, edge_type=None, edge_mask=None):
        if centered:
            atom_type = atom_type * 2.0 - 1.0
        if pos is not None:
            pos = pos / pos_norm * node_mask
        atom_type = atom_type / atom_type_norm * node_mask
        fc_charge = fc_charge / fc_norm * node_mask
        if edge_type is None:
            return pos, atom_type, fc_charge
        if centered:
            edge_type = edge_type * 2.0 - 1.0
        return pos, atom_type, fc_charge, edge_type / edge_norm * edge_mask[..., None]

    return scale_fn


def get_data_inverse_scaler(config):
    """The inverse of ``get_data_scaler``'s normaliser, the edges where
    given, ``pos`` None staying None."""
    pos_norm, atom_type_norm, fc_norm, edge_norm = parse_normalize_factors(
        config.model.normalize_factors
    )
    centered = config.data.centered

    def inverse_fn(pos, atom_type, fc_charge, node_mask, edge_type=None, edge_mask=None):
        if pos is not None:
            pos = pos * pos_norm * node_mask
        atom_type = atom_type * atom_type_norm
        fc_charge = fc_charge * fc_norm * node_mask
        if centered:
            atom_type = (atom_type + 1.0) / 2.0 * node_mask
        if edge_type is None:
            return pos, atom_type, fc_charge
        edge_type = edge_type * edge_norm
        if centered:
            edge_type = (edge_type + 1.0) / 2.0
        edge_type = edge_type * edge_mask[..., None]
        return pos, atom_type, fc_charge, edge_type

    return inverse_fn


def get_self_cond_fn(config):
    """'ori' passes the previous prediction through; 'clamp' clips the atom,
    charge (the last node channel, with ``model.include_fc_charge``) and
    edge channels to their normalised value ranges."""
    process_type = config.model.self_cond_type
    if process_type not in ("ori", "clamp"):
        raise ValueError("Self-condition data process error.")
    atom_types = config.data.atom_types
    include_fc = bool(config.model.include_fc_charge)
    _, atom_type_norm, fc_norm, edge_norm = parse_normalize_factors(
        config.model.normalize_factors
    )
    atom_lo, atom_hi = 0.0, 1.0
    edge_lo, edge_hi = 0.0, 1.0
    fc_lo, fc_hi = (float(v) for v in config.data.fc_scale)
    if config.data.centered:
        atom_lo, atom_hi = atom_lo * 2.0 - 1.0, atom_hi * 2.0 - 1.0
        edge_lo, edge_hi = edge_lo * 2.0 - 1.0, edge_hi * 2.0 - 1.0
    atom_lo, atom_hi = atom_lo / atom_type_norm, atom_hi / atom_type_norm
    fc_lo, fc_hi = fc_lo / fc_norm, fc_hi / fc_norm
    edge_lo, edge_hi = edge_lo / edge_norm, edge_hi / edge_norm

    def process(cond_x, cond_edge_x):
        if process_type == "ori":
            return cond_x, cond_edge_x
        pieces = [cond_x[:, :, :3], cond_x[:, :, 3 : 3 + atom_types].clamp(atom_lo, atom_hi)]
        if include_fc:
            pieces.append(cond_x[:, :, -1:].clamp(fc_lo, fc_hi))
        return torch.cat(pieces, dim=-1), cond_edge_x.clamp(edge_lo, edge_hi)

    return process
