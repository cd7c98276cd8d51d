"""Dataset assembly, splits, batching and augmentation (port of
``diffspectra_tpu/data/pipeline.py``).

``get_dataset`` reads QM9S from ``data.root`` (``qm9s.load_qm9s``) or
builds the synthetic set (``data.synthetic``), splits it (the 4-way
conditional split, or the original-QM9 split for another ``exp_type``)
and runs the dataset transform; ``get_batch_iterator`` yields collated
numpy batches (bucketed by atom count, or padded to ``data.max_node``),
which ``prefetch`` assembles on a background thread;
``augment_positions`` rotates and translates a batch on its device, with
draws from a ``torch.Generator``. The device-resident twin of the iterator
and the collate is ``device_store.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from .info import get_dataset_info
from .qm9s import load_qm9s
from .synthetic import generate as generate_synthetic
from .transform import edge_com_spectra_transform

SPECTRA_KEYS = {"uv": ("uv",), "ir": ("ir",), "raman": ("raman",),
                "allspectra": ("uv", "ir", "raman")}


class ArrayDataset:
    """A dict of aligned numpy arrays + an index; cheap row views."""

    def __init__(self, arrays: Dict[str, np.ndarray], indices: np.ndarray):
        self.arrays = arrays
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def take(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        idx = self.indices[rows]
        return {k: v[idx] for k, v in self.arrays.items()}

    def select(self, rows: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.arrays, self.indices[rows])


def _conditional_splits(rng: np.random.Generator, size: int):
    """First/second train halves, val (5%) and test (10%) of one
    permutation, as the reference's conditional split file."""
    perm = rng.permutation(size)
    n_test = max(1, int(size * 0.1))
    n_val = max(1, int(size * 0.05))
    n_train = size - n_test - n_val
    first = perm[: n_train // 2]
    second = perm[n_train // 2 : n_train]
    val = perm[n_train : n_train + n_val]
    test = perm[n_train + n_val :]
    return first, second, val, test


def _original_splits(rng: np.random.Generator, size: int):
    """The original-QM9 split, scaled to ``size``: 100,000 of 130,831 to
    train (both halves alias it), 10% test, the rest validation."""
    perm = rng.permutation(size)
    n_train = max(1, int(size * 100000 / 130831))
    n_test = max(1, int(size * 0.1))
    train = perm[:n_train]
    test = perm[n_train : n_train + n_test]
    val = perm[n_train + n_test :]
    return train, train, val, test


def get_dataset(config, transform: bool = True):
    """``(first_train, second_train, val, test, dataset_info)``.

    With ``data.synthetic``: ``generate(config.seed, data.synthetic_size,
    data.max_node, fidelity=data.synthetic_fidelity)`` (kept in
    ``data.synthetic_cache`` when set), split by a permutation drawn from
    ``config.seed``. Else QM9S from ``data.root`` with its split file's
    splits. ``exp_type`` other than ``'diffspectra'`` takes the original-QM9
    split instead (from ``config.seed`` on the synthetic set, from seed 42
    on QM9S). ``transform=False`` keeps the raw arrays. The train loop
    trains on the second half, as the JAX package does."""
    dataset_info = get_dataset_info(config.data.info_name)
    max_n = config.data.max_node
    conditional = config.exp_type == "diffspectra"
    if config.data.synthetic:
        raw = generate_synthetic(
            seed=config.seed, size=config.data.synthetic_size, max_n=max_n,
            info_name=config.data.info_name, fidelity=config.data.synthetic_fidelity,
            cache_dir=config.data.synthetic_cache,
        )
        split_fn = _conditional_splits if conditional else _original_splits
        first, second, val, test = split_fn(np.random.default_rng(config.seed),
                                             len(raw["num_atom"]))
    else:
        raw, splits = load_qm9s(config.data.root, max_n=max_n)
        if conditional:
            first, second, val, test = splits
        else:
            # a property of the dataset, not of the split file or config.seed
            first, second, val, test = _original_splits(np.random.default_rng(42),
                                                        len(raw["num_atom"]))
    arrays = edge_com_spectra_transform(
        raw, atom_types=config.data.atom_types, include_aromatic=config.data.include_aromatic,
        use_normalize=config.data.use_normalize,
    ) if transform else raw
    ds = ArrayDataset(arrays, np.arange(len(arrays["num_atom"])))
    return ds.select(first), ds.select(second), ds.select(val), ds.select(test), dataset_info


def build_masks_np(num_atom: np.ndarray, max_n: int):
    """``node_mask [B, N]``, ``edge_mask [B, N, N]`` (diagonal zeroed)."""
    ar = np.arange(max_n)
    node_mask = (ar[None, :] < num_atom[:, None]).astype(np.float32)
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    edge_mask *= 1.0 - np.eye(max_n, dtype=np.float32)[None]
    return node_mask, edge_mask


def collate(rows: Dict[str, np.ndarray], spectra_version: str) -> Dict:
    """Pack rows into the model batch dict; ``context`` is a tuple of the
    spectra the model reads, in the order uv, ir, raman."""
    num_atom = rows["num_atom"]
    node_mask, edge_mask = build_masks_np(num_atom, rows["atom_one_hot"].shape[1])
    return dict(
        atom_one_hot=rows["atom_one_hot"],
        edge_one_hot=rows["edge_one_hot"],
        positions=rows["positions"],
        formal_charges=rows["formal_charges"],
        atom_mask=node_mask,
        edge_mask=edge_mask,
        context=tuple(rows[k] for k in SPECTRA_KEYS[spectra_version]),
        num_atom=num_atom,
    )


def random_rotation_matrices(generator: torch.Generator, bs: int,
                             device=None) -> torch.Tensor:
    """Uniform SO(3) rotations from normalised quaternions, ``[B, 3, 3]``."""
    q = torch.randn((bs, 4), generator=generator, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x**2 + z**2), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x**2 + y**2)], -1),
    ], dim=1)


def augment_positions(generator: torch.Generator, positions: torch.Tensor,
                      node_mask: torch.Tensor, aug_rotation: bool, aug_translation: bool,
                      aug_translation_scale: float) -> torch.Tensor:
    """A random rotation, then a random translation of scale
    ``aug_translation_scale``, per molecule, masked; the draws on the
    positions' device."""
    bs = positions.shape[0]
    mask = node_mask[..., None] if node_mask.dim() == 2 else node_mask
    if aug_rotation:
        rot = random_rotation_matrices(generator, bs, positions.device)
        positions = torch.einsum("bij,bnj->bni", rot, positions) * mask
    if aug_translation:
        trans = torch.randn((bs, 1, 3), generator=generator, device=positions.device)
        positions = (positions + aug_translation_scale * trans) * mask
    return positions


def _truncate_batch(rows: Dict[str, np.ndarray], n_pad: int) -> Dict[str, np.ndarray]:
    """The node and pair axes of gathered rows cut to ``n_pad`` (a bucket)."""
    out = {}
    for k, v in rows.items():
        if k in ("atom_one_hot", "positions", "atom_type", "formal_charges"):
            out[k] = v[:, :n_pad]
        elif k in ("edge_one_hot", "edge_type"):
            out[k] = v[:, :n_pad, :n_pad]
        else:
            out[k] = v
    return out


def validate_bucket_sizes(bucket_sizes, num_atom) -> list:
    """Sorted bucket boundaries; a molecule above the largest raises (it
    would fall in no bucket and never be trained on)."""
    bucket_sizes = sorted(int(b) for b in bucket_sizes)
    top = int(np.max(num_atom)) if len(num_atom) else 0
    if bucket_sizes and top > bucket_sizes[-1]:
        raise ValueError(
            f"bucket_sizes[-1]={bucket_sizes[-1]} < max atom count {top}: rows above the "
            f"last bucket would never be trained on; add a bucket >= {top}"
        )
    return bucket_sizes


def get_batch_iterator(ds: ArrayDataset, batch_size: int, spectra_version: str,
                       shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                       bucket_sizes=()) -> Iterator[Dict]:
    """One epoch of collated numpy batches in a permutation from ``seed``.
    With ``bucket_sizes`` every batch holds molecules of one bucket, padded
    to it; a bucket's leftover rows carry up into the next larger one, and
    the batches of all buckets run in a shuffled order."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    order = rng.permutation(n) if shuffle else np.arange(n)

    if not bucket_sizes:
        stop = n - (n % batch_size) if drop_last else n
        for start in range(0, stop, batch_size):
            yield collate(ds.take(order[start : start + batch_size]), spectra_version)
        return

    num_atom = ds.arrays["num_atom"][ds.indices[order]]
    bucket_sizes = validate_bucket_sizes(bucket_sizes, num_atom)
    bucket_of = np.searchsorted(bucket_sizes, num_atom)  # the first b >= n
    batches = []
    carry = order[:0]
    for bi, bsize in enumerate(bucket_sizes):
        rows = np.concatenate([carry, order[bucket_of == bi]])
        stop = len(rows) - (len(rows) % batch_size)
        for start in range(0, stop, batch_size):
            batches.append((bsize, rows[start : start + batch_size]))
        carry = rows[stop:]
    if carry.size and not drop_last:
        batches.append((bucket_sizes[-1], carry))
    rng.shuffle(batches)
    for bsize, rows in batches:
        yield collate(_truncate_batch(ds.take(rows), bsize), spectra_version)


def inf_iterator(make_iter):
    """Epoch after epoch of ``make_iter(epoch)``."""
    epoch = 0
    while True:
        yield from make_iter(epoch)
        epoch += 1


def prefetch(iterator, size: int = 2):
    """``iterator``'s items, made ``size`` ahead on a background thread, so
    that the host assembles the next batches while the device computes. An
    exception in the thread ends the iteration with it raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    failure = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # handed to the consumer, raised there
            failure.append(e)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if failure:
                raise failure[0]
            return
        yield item
