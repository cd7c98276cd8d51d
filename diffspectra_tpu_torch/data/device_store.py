"""The device-resident train split (port of the one-device half of
``diffspectra_tpu/data/device_store.py``).

The whole split goes to the device once, in compact dtypes (int8 atom
types, bond orders and charges; float32 positions and spectra; int32 atom
counts), and each step gathers its batch there from an index vector with
``index_select`` and builds the one-hots and masks on the device: the
per-step host work and copy shrink from a collated batch to ``[B]``
indices. ``build_batch`` gives what ``pipeline.collate`` gives for the
same rows (the edge one-hot without the edge mask's product, which the
rows' zero padding makes equal); ``index_iterator`` gives the index
sequence of ``pipeline.get_batch_iterator`` for the same seed.
``estimate_bytes`` is the store's size on the device, which
``run_lib.train`` holds against ``data.device_store_max_bytes``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import masks as M
from .pipeline import SPECTRA_KEYS, ArrayDataset, validate_bucket_sizes


def estimate_bytes(ds: ArrayDataset, spectra_version: str) -> int:
    """The device bytes of ``DeviceStore(ds, spectra_version)``."""
    m = len(ds)
    n = ds.arrays["atom_type"].shape[1]
    total = m * (n * 3 * 4 + n + n * n + n + 4)  # pos f32; types, bonds, fc int8; count int32
    for k in SPECTRA_KEYS[spectra_version]:
        total += m * ds.arrays[k].shape[-1] * 4
    return total


class DeviceStore:
    """The rows of ``ds`` on ``device``: ``arrays`` holds ``positions``,
    ``atom_type``, ``edge_type``, ``formal_charges``, ``num_atom`` and the
    spectra of ``spectra_version``; ``host_num_atom`` the atom counts on
    the host, in store order, for the bucketed index iterator."""

    def __init__(self, ds: ArrayDataset, spectra_version: str, device):
        rows = ds.take(np.arange(len(ds)))
        self.spectra_keys = SPECTRA_KEYS[spectra_version]
        store = {
            "positions": rows["positions"].astype(np.float32),
            "atom_type": rows["atom_type"].astype(np.int8),
            "edge_type": rows["edge_type"].astype(np.int8),
            "formal_charges": rows["formal_charges"][..., 0].astype(np.int8),
            "num_atom": rows["num_atom"].astype(np.int32),
        }
        for k in self.spectra_keys:
            store[k] = rows[k].astype(np.float32)  # already log-normalised
        self.host_num_atom = store["num_atom"].copy()
        self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for k, v in store.items()}

    def __len__(self):
        return len(self.host_num_atom)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def build_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor, *, atom_types: int,
                include_aromatic: bool, spectra_keys: Tuple[str, ...], n_pad: int = 0) -> Dict:
    """The batch of rows ``idx`` (on the store's device), as
    ``pipeline.collate`` builds it on the host (``context`` a tuple; no
    ``num_atom``): the node and pair axes cut to ``n_pad`` when it is
    below N (a bucket), else whole."""
    at = arrays["atom_type"].index_select(0, idx).long()
    et = arrays["edge_type"].index_select(0, idx).long()
    pos = arrays["positions"].index_select(0, idx)
    fc = arrays["formal_charges"].index_select(0, idx).float()
    num_atom = arrays["num_atom"].index_select(0, idx)
    if n_pad and n_pad < at.shape[1]:
        at, et = at[:, :n_pad], et[:, :n_pad, :n_pad]
        pos, fc = pos[:, :n_pad], fc[:, :n_pad]
    node_mask, edge_mask = M.build_masks(num_atom, at.shape[1])  # [B, N, 1], [B, N, N]
    # an index outside [0, atom_types) gives a zero row, as jax.nn.one_hot
    atom_one_hot = (at[..., None] == torch.arange(atom_types, device=at.device)).float()
    # the bond-order channel: aromatic (4) -> 0, then / 3
    bond = torch.where(et == 4, torch.zeros((), device=et.device), et.float()) / 3.0
    feats = [bond]
    if include_aromatic:
        feats.append((et == 4).float())
    edge_feat = torch.stack(feats, dim=-1)
    edge_exist = (edge_feat.sum(-1, keepdim=True) != 0).float()
    return dict(
        atom_one_hot=atom_one_hot * node_mask,
        edge_one_hot=torch.cat([edge_exist, edge_feat], dim=-1),
        positions=pos,
        formal_charges=fc[..., None],
        atom_mask=node_mask[..., 0],
        edge_mask=edge_mask,
        context=tuple(arrays[k].index_select(0, idx) for k in spectra_keys),
    )


def index_iterator(size: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, bucket_sizes=(), num_atom=None):
    """One epoch of ``(n_pad, idx)`` batches (``idx`` int64 rows of the
    store; ``n_pad`` 0 for the whole N), in the order
    ``pipeline.get_batch_iterator`` gives for ``seed``: with
    ``bucket_sizes`` (and the store's ``num_atom``), a bucket's leftover
    rows carry up into the next larger one."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(size) if shuffle else np.arange(size)
    if not bucket_sizes:
        stop = size - (size % batch_size) if drop_last else size
        for start in range(0, stop, batch_size):
            yield 0, order[start : start + batch_size].astype(np.int64)
        return
    if num_atom is None:
        raise ValueError("bucketed batches take the store's num_atom")
    bucket_sizes = validate_bucket_sizes(bucket_sizes, num_atom)
    bucket_of = np.searchsorted(bucket_sizes, num_atom[order])
    batches = []
    carry = order[:0]
    for bi, bsize in enumerate(bucket_sizes):
        rows = np.concatenate([carry, order[bucket_of == bi]])
        stop = len(rows) - (len(rows) % batch_size)
        for start in range(0, stop, batch_size):
            batches.append((int(bsize), rows[start : start + batch_size]))
        carry = rows[stop:]
    if carry.size and not drop_last:
        batches.append((int(bucket_sizes[-1]), carry))
    rng.shuffle(batches)
    for bsize, rows in batches:
        yield bsize, rows.astype(np.int64)
