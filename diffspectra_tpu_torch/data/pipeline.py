"""The evaluation sweep's dataset: the synthetic branch of
``diffspectra_tpu/data/pipeline.py``'s ``get_dataset`` with its 4-way
conditional split, and of ``data/transform.py`` only the arrays the
sampling harness reads.

Left out (training, ``ROADMAP.md`` queue 1, item 7): the one-hot atom and
edge packing, the QM9S loader, the original-QM9 split and the dataset
cache.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .info import get_dataset_info
from .synthetic import generate as generate_synthetic

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


def sweep_arrays(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """From the generator's arrays: ``num_atom``, ``atom_type``,
    ``edge_type``, positions and formal charges as float32 zeroed past each
    molecule's atoms (charges ``[M, N, 1]``), and log10(x + 1) spectra."""
    atom_type = raw["atom_type"]
    node_mask = (np.arange(atom_type.shape[1])[None, :] < raw["num_atom"][:, None])
    node_mask = node_mask.astype(np.float32)
    out = dict(
        positions=raw["pos"].astype(np.float32) * node_mask[..., None],
        formal_charges=(raw["fc"].astype(np.float32) * node_mask)[..., None],
        num_atom=raw["num_atom"],
        atom_type=atom_type,
        edge_type=raw["edge_type"],
    )
    for k in ("uv", "ir", "raman"):
        out[k] = np.log10(raw[k].astype(np.float32) + 1.0)
    return out


def get_dataset(config):
    """``(first_train, second_train, val, test, dataset_info)`` of
    ``generate(config.seed, config.data.synthetic_size, data.max_node,
    fidelity=data.synthetic_fidelity)``, split by a permutation drawn from
    ``config.seed``."""
    dataset_info = get_dataset_info(config.data.info_name)
    raw = generate_synthetic(
        seed=config.seed, size=config.data.synthetic_size, max_n=config.data.max_node,
        info_name=config.data.info_name, fidelity=config.data.synthetic_fidelity,
    )
    split_rng = np.random.default_rng(config.seed)
    first, second, val, test = _conditional_splits(split_rng, len(raw["num_atom"]))
    arrays = sweep_arrays(raw)
    ds = ArrayDataset(arrays, np.arange(len(arrays["num_atom"])))
    return ds.select(first), ds.select(second), ds.select(val), ds.select(test), dataset_info
