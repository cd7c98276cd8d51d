"""The EdgeComSpectra dataset transform over dense numpy arrays (port of
``diffspectra_tpu/data/transform.py``, with the packing semantics of its
numpy packer ``data/native.py::pack_batch_numpy``).

One-hot atom types; the bond orders compressed into the 2-channel (3 with
aromatic) dense edge tensor [exists; order / 3; (aromatic)]; positions and
formal charges zeroed past each molecule's atoms; log10(x + 1) spectra.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

CHUNK = 8192  # rows packed at a time, to bound the temporaries


def _pack(atom_type, pos, edge_type, fc, num_atom, atom_types, include_aromatic):
    n = atom_type.shape[1]
    node_mask = (np.arange(n)[None, :] < num_atom[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    edge_mask *= 1.0 - np.eye(n, dtype=np.float32)[None]
    atom_one_hot = (atom_type[..., None] == np.arange(atom_types)).astype(np.float32)
    bond = np.where(edge_type == 4, 0.0, edge_type).astype(np.float32) / 3.0
    feats = [bond]
    if include_aromatic:
        feats.append((edge_type == 4).astype(np.float32))
    edge_feat = np.stack(feats, axis=-1) * edge_mask[..., None]
    exist = (edge_feat.sum(-1, keepdims=True) != 0).astype(np.float32)
    return dict(
        atom_one_hot=atom_one_hot * node_mask[..., None],
        edge_one_hot=np.concatenate([exist, edge_feat], axis=-1),
        positions=pos.astype(np.float32) * node_mask[..., None],
        formal_charges=(fc.astype(np.float32) * node_mask)[..., None],
    )


def edge_com_spectra_transform(raw: Dict[str, np.ndarray], atom_types: int = 5,
                               include_aromatic: bool = False,
                               use_normalize: bool = True) -> Dict[str, np.ndarray]:
    """``raw``: atom_type [M, N], pos, edge_type [M, N, N] bond orders (4 =
    aromatic), fc, num_atom, uv/ir/raman. Returns atom_one_hot [M, N, A],
    edge_one_hot [M, N, N, C], positions, formal_charges [M, N, 1], num_atom,
    atom_type, edge_type and the spectra."""
    m = raw["atom_type"].shape[0]
    parts = [
        _pack(raw["atom_type"][sl], raw["pos"][sl], raw["edge_type"][sl], raw["fc"][sl],
              raw["num_atom"][sl], atom_types, include_aromatic)
        for sl in (slice(s, s + CHUNK) for s in range(0, m, CHUNK))
    ]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out.update(num_atom=raw["num_atom"], atom_type=raw["atom_type"], edge_type=raw["edge_type"])
    for k in ("uv", "ir", "raman"):
        if k in raw:
            spec = raw[k].astype(np.float32)
            out[k] = np.log10(spec + 1.0) if use_normalize else spec
    return out
