"""The device-resident train split (port of
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
``run_lib.train`` holds against ``data.device_store_max_bytes``, a rank's
share of it under data parallelism.

Over ``world`` ranks each rank holds one shard of the rows: the rows
wrap-padded to a multiple of ``world`` (``concat(arange(m), arange(pad))``),
rank ``r`` holding ``[r shard, (r + 1) shard)``. The sharded iterators
(``sharded_index_iterator``, ``sharded_bucket_index_iterator``) give every
rank the same global index vector from the seed, no collective needed;
block ``r`` holds offsets into rank ``r``'s shard (``global_index_array``).
Shard-local shuffling means a row is always trained by the same rank; the
averaged gradients mix them all.
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
    the host, in store order, for the bucketed index iterator. With
    ``world`` ranks, ``arrays`` holds rank ``rank``'s ``shard_size`` rows
    of the wrap-padded store, and ``host_num_atom`` the counts of the whole
    padded store, the same on every rank."""

    def __init__(self, ds: ArrayDataset, spectra_version: str, device, rank: int = 0,
                 world: int = 1):
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
        m = len(store["num_atom"])
        pad = (-m) % world
        if pad:
            store = {k: np.concatenate([v, v[:pad]], axis=0) for k, v in store.items()}
        self.shard_size = (m + pad) // world
        self.host_num_atom = store["num_atom"].copy()
        own = slice(rank * self.shard_size, (rank + 1) * self.shard_size)
        self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v[own])).to(device)
                       for k, v in store.items()}

    def __len__(self):
        """The rows this rank holds."""
        return self.shard_size

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


def global_index_array(idx: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s block of the global index vector of the sharded
    iterators: offsets into its own shard."""
    per = idx.shape[0] // world
    return idx[rank * per:(rank + 1) * per]


def sharded_bucket_index_iterator(num_atom: np.ndarray, shard_size: int, n_dev: int,
                                  per_dev_batch: int, bucket_sizes, shuffle: bool = True,
                                  seed: int = 0):
    """One epoch of bucketed ``(n_pad, idx[n_dev * per_dev_batch])`` over a
    store sharded ``n_dev`` ways (``num_atom``: ``host_num_atom``, the whole
    padded store); block ``d`` holds offsets into shard ``d``, every row at
    most ``n_pad`` atoms. The sequence is a function of ``(num_atom,
    seed)``: every rank computes the same one, so all run the same bucket
    at each step.

    The steps of bucket ``b``: its global row count plus the rows carried
    up from the smaller buckets, over the global batch (the remainder
    carries up). Each shard's unconsumed rows of ``b`` head its draw list of
    ``b + 1``, so the carried steps train those rows. A shard with fewer
    rows than the schedule takes wraps around its list; one with none in a
    bucket draws from its rows of at most that many atoms; a bucket that
    no row of some shard fits is skipped, its rows and count carried up.
    Rows above the largest bucket raise (``validate_bucket_sizes``)."""
    bucket_sizes = validate_bucket_sizes(bucket_sizes, num_atom)
    rng = np.random.default_rng(seed)
    per_shard = np.asarray(num_atom).reshape(n_dev, shard_size)
    n_buckets = len(bucket_sizes)
    pools, fallbacks = [], []  # [d][b]: shard d's rows of bucket b; its rows that fit b
    for d in range(n_dev):
        b_of = np.searchsorted(bucket_sizes, per_shard[d])
        shard_pools, shard_fb = [], []
        for b in range(n_buckets):
            rows = np.where(b_of == b)[0]
            if shuffle and rows.size:
                rows = rng.permutation(rows)
            shard_pools.append(rows)
            fb = np.where(per_shard[d] <= bucket_sizes[b])[0]
            if shuffle and fb.size:
                fb = rng.permutation(fb)
            shard_fb.append(fb)
        pools.append(shard_pools)
        fallbacks.append(shard_fb)

    b_of_all = np.searchsorted(bucket_sizes, per_shard.reshape(-1))
    global_batch = n_dev * per_dev_batch
    lists = [[None] * n_buckets for _ in range(n_dev)]
    carry = [np.empty(0, dtype=np.int64) for _ in range(n_dev)]
    steps_of = [0] * n_buckets
    leftover = 0
    for b in range(n_buckets):
        feasible = True
        for d in range(n_dev):
            rows = np.concatenate([carry[d], pools[d][b]])
            if rows.size == 0:
                rows = fallbacks[d][b].astype(np.int64)
            lists[d][b] = rows
            feasible &= rows.size > 0
        total = int((b_of_all == b).sum()) + leftover
        if not feasible:
            leftover = total
            for d in range(n_dev):
                carry[d] = np.concatenate([carry[d], pools[d][b]])
            continue
        steps_of[b], leftover = total // global_batch, total % global_batch
        consumed = steps_of[b] * per_dev_batch
        for d in range(n_dev):
            own = np.concatenate([carry[d], pools[d][b]])
            carry[d] = own[consumed:] if consumed < own.size else np.empty(0, dtype=np.int64)
    schedule = [b for b in range(n_buckets) for _ in range(steps_of[b])]
    if shuffle:
        rng.shuffle(schedule)

    cursor = np.zeros((n_dev, n_buckets), dtype=np.int64)
    for b in schedule:
        blocks = []
        for d in range(n_dev):
            rows = lists[d][b]
            take = (cursor[d, b] + np.arange(per_dev_batch)) % rows.size
            cursor[d, b] += per_dev_batch
            blocks.append(rows[take])
        yield int(bucket_sizes[b]), np.concatenate(blocks).astype(np.int64)


def sharded_index_iterator(shard_size: int, n_dev: int, per_dev_batch: int,
                           shuffle: bool = True, seed: int = 0):
    """One epoch of ``idx[n_dev * per_dev_batch]`` over a store sharded
    ``n_dev`` ways: block ``d`` holds offsets into shard ``d``, each shard
    permuted on its own; the rows that do not fill a rank's batch are
    dropped."""
    rng = np.random.default_rng(seed)
    orders = [rng.permutation(shard_size) if shuffle else np.arange(shard_size)
              for _ in range(n_dev)]
    for start in range(0, shard_size - shard_size % per_dev_batch, per_dev_batch):
        yield np.concatenate([o[start:start + per_dev_batch] for o in orders]).astype(np.int64)
