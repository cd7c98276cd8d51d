"""The QM9S dataset on disk (port of ``diffspectra_tpu/data/qm9s.py``).

``load_qm9s(root)`` reads the packed store ``<root>/packed/*.npy`` (the
dense arrays, a molecule a row, and the four split index files), or else
converts the reference's processed PyG file
``<root>/processed/data_qm9_allspectra.pt`` into it once
(``pack_from_pyg``). ``write_processed_pt`` writes a file in the
reference's ``(Data, slices)`` layout, for tests and smoke runs without the
real download. The result is the raw dict that
``transform.edge_com_spectra_transform`` takes.

The processed file holds PyG ``Data`` objects; without ``torch_geometric``
(which the port never imports) the unpickler needs the class paths, so
``_install_pyg_unpickle_shims`` registers stand-ins under them unless some
already stand there (the real library, or the JAX package's stand-ins in
the same process). The unpickled objects are read through attributes only,
whichever classes made them.
"""

from __future__ import annotations

import os
import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch

RAW_KEYS = ("atom_type", "pos", "edge_type", "fc", "num_atom", "uv", "ir", "raman")
SPLIT_KEYS = ("first_train", "second_train", "valid", "test")
PROCESSED = os.path.join("processed", "data_qm9_allspectra.pt")
SPLIT_FILE = "split_dict_diffspectra_qm9.pt"
SPEC_LENS = {"uv": 701, "ir": 3501, "raman": 3501}


def load_qm9s(root: str, max_n: int = 29) -> Tuple[Dict[str, np.ndarray], tuple]:
    """``(raw, (first_train, second_train, valid, test))`` from
    ``<root>/packed`` (the arrays memory-mapped), converting
    ``<root>/processed/data_qm9_allspectra.pt`` first if there is no packed
    store. A store of another ``N`` than ``max_n`` raises, as does a root
    with neither."""
    packed = os.path.join(root, "packed")
    if os.path.isdir(packed):
        raw = {k: np.load(os.path.join(packed, f"{k}.npy"), mmap_mode="r") for k in RAW_KEYS}
        splits = tuple(np.load(os.path.join(packed, f"split_{k}.npy")) for k in SPLIT_KEYS)
        if raw["atom_type"].shape[1] != max_n:
            raise ValueError(
                f"packed store has N={raw['atom_type'].shape[1]}, config wants {max_n}")
        return raw, splits
    if os.path.exists(os.path.join(root, PROCESSED)):
        return pack_from_pyg(root, max_n)
    raise FileNotFoundError(
        f"No QM9S data found under {root!r}: expected packed/*.npy or {PROCESSED}. For tests "
        f"and smoke runs set config.data.synthetic=True.")


class _ShimStorage:
    """Stands in for ``torch_geometric.data.storage.GlobalStorage``: its
    state is its ``__dict__``, its tensors in ``_mapping``."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __getattr__(self, key):
        mapping = self.__dict__.get("_mapping", {})
        if key in mapping:
            return mapping[key]
        raise AttributeError(key)


class _ShimData:
    """Stands in for ``torch_geometric.data.data.Data``: attributes read
    through its ``_store``."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __getattr__(self, key):
        store = self.__dict__.get("_store")
        if store is not None:
            try:
                return getattr(store, key)
            except AttributeError:
                pass
        mapping = self.__dict__.get("_mapping", {})
        if key in mapping:
            return mapping[key]
        raise AttributeError(key)


# the PyG names, so that the stand-ins also pickle under them
_ShimData.__module__, _ShimData.__qualname__, _ShimData.__name__ = (
    "torch_geometric.data.data", "Data", "Data")
_ShimStorage.__module__, _ShimStorage.__qualname__, _ShimStorage.__name__ = (
    "torch_geometric.data.storage", "GlobalStorage", "GlobalStorage")


def _install_pyg_unpickle_shims() -> None:
    """Register the stand-ins under the PyG module paths the processed file
    names, keeping any module already registered there."""
    mods = {name: types.ModuleType(name) for name in (
        "torch_geometric", "torch_geometric.data", "torch_geometric.data.data",
        "torch_geometric.data.storage")}
    mods["torch_geometric.data.data"].Data = _ShimData
    mods["torch_geometric.data.data"].DataEdgeAttr = type("DataEdgeAttr", (), {})
    mods["torch_geometric.data.data"].DataTensorAttr = type("DataTensorAttr", (), {})
    mods["torch_geometric.data.storage"].GlobalStorage = _ShimStorage
    mods["torch_geometric.data.storage"].BaseStorage = _ShimStorage
    mods["torch_geometric.data"].Data = _ShimData
    for name, mod in mods.items():
        sys.modules.setdefault(name, mod)


def write_processed_pt(root: str, mols, spectra=None):
    """Write ``<root>/processed/data_qm9_allspectra.pt`` in the reference's
    ``(Data, slices)`` PyG-collate layout: node tensors concatenated over
    molecules, ``edge_index`` with global node offsets and both directions
    of each bond, spectra a row a molecule, and each stored key's slices.

    ``mols``: dicts with ``atom_type [n]``, ``pos [n, 3]``, ``fc [n]`` and
    ``bonds`` (``(i, j, order)`` in the molecule's own indices).
    ``spectra``: ``uv [M, 701]``, ``ir [M, 3501]``, ``raman [M, 3501]``
    (uniform random where missing). Returns the stored tensors by key."""
    _install_pyg_unpickle_shims()
    data_cls = sys.modules["torch_geometric.data.data"].Data
    storage_cls = sys.modules["torch_geometric.data.storage"].GlobalStorage

    n_mol = len(mols)
    offsets = np.cumsum([0] + [len(m["atom_type"]) for m in mols])
    ei_cols, et_vals = [], []
    for k, m in enumerate(mols):
        for i, j, o in m["bonds"]:
            ei_cols += [[i + offsets[k], j + offsets[k]], [j + offsets[k], i + offsets[k]]]
            et_vals += [o, o]
    edge_index = (np.asarray(ei_cols, dtype=np.int64).T if ei_cols
                  else np.zeros((2, 0), np.int64))
    mapping = {
        "atom_type": torch.tensor(np.concatenate([m["atom_type"] for m in mols])),
        "pos": torch.tensor(np.concatenate([m["pos"] for m in mols]), dtype=torch.float32),
        "fc": torch.tensor(np.concatenate([m["fc"] for m in mols])),
        "edge_index": torch.tensor(edge_index),
        "edge_type": torch.tensor(np.asarray(et_vals, dtype=np.int64)),
        "num_atom": torch.tensor([len(m["atom_type"]) for m in mols]),
    }
    for key, length in SPEC_LENS.items():
        if spectra is not None and key in spectra:
            mapping[key] = torch.tensor(np.asarray(spectra[key], dtype=np.float32))
        else:
            mapping[key] = torch.rand(n_mol, length)
    storage = storage_cls.__new__(storage_cls)
    storage.__dict__["_mapping"] = mapping
    data = data_cls.__new__(data_cls)
    data.__dict__["_store"] = storage

    atom_off = torch.tensor(offsets)
    edge_off = torch.tensor(np.cumsum([0] + [2 * len(m["bonds"]) for m in mols]))
    per_mol = torch.tensor(np.arange(n_mol + 1))
    slices = {"atom_type": atom_off, "pos": atom_off, "fc": atom_off, "edge_index": edge_off,
              "edge_type": edge_off, "num_atom": per_mol, "uv": per_mol, "ir": per_mol,
              "raman": per_mol}
    os.makedirs(os.path.join(root, "processed"), exist_ok=True)
    torch.save((data, slices), os.path.join(root, PROCESSED))
    return mapping


def pack_from_pyg(root: str, max_n: int = 29):
    """Convert ``<root>/processed/data_qm9_allspectra.pt`` into the packed
    store ``<root>/packed`` and return ``(raw, splits)``. The splits come
    from ``<root>/split_dict_diffspectra_qm9.pt``, else from a permutation
    drawn from seed 42 with 13,000 test and 5,000 validation molecules and
    the train halves of the rest. ``edge_index`` must hold global node
    offsets: a bond outside its molecule after their removal raises."""
    _install_pyg_unpickle_shims()
    data, slices = torch.load(os.path.join(root, PROCESSED), map_location="cpu",
                              weights_only=False)
    n_mol = len(slices["num_atom"]) - 1
    out = {
        "atom_type": np.zeros((n_mol, max_n), np.int64),
        "pos": np.zeros((n_mol, max_n, 3), np.float32),
        "edge_type": np.zeros((n_mol, max_n, max_n), np.int64),
        "fc": np.zeros((n_mol, max_n), np.int64),
        "num_atom": np.zeros((n_mol,), np.int64),
        **{k: np.zeros((n_mol, length), np.float32) for k, length in SPEC_LENS.items()},
    }
    atom_sl = slices["atom_type"].numpy()
    edge_sl = slices["edge_index"].numpy()
    atom_type, pos = data.atom_type.numpy(), data.pos.numpy()
    fc = data.fc.numpy() if hasattr(data, "fc") else None
    edge_index, edge_type = data.edge_index.numpy(), data.edge_type.numpy()
    spectra = {k: getattr(data, k).numpy().reshape(n_mol, -1) for k in SPEC_LENS}
    for m in range(n_mol):
        a0, a1 = atom_sl[m], atom_sl[m + 1]
        n = a1 - a0
        out["num_atom"][m] = n
        out["atom_type"][m, :n] = atom_type[a0:a1]
        out["pos"][m, :n] = pos[a0:a1]
        out["fc"][m, :n] = fc[a0:a1] if fc is not None else 0
        e0, e1 = edge_sl[m], edge_sl[m + 1]
        # the collate offsets each molecule's bonds by its first atom
        ei = edge_index[:, e0:e1] - a0
        if ei.size and (ei.min() < 0 or ei.max() >= n):
            raise ValueError(f"molecule {m}: edge_index outside [0,{n}) after offset removal "
                             "-- unexpected processed-file layout")
        out["edge_type"][m, ei[0], ei[1]] = edge_type[e0:e1]
    for key in SPEC_LENS:
        out[key][:] = spectra[key]

    split_file = os.path.join(root, SPLIT_FILE)
    if os.path.exists(split_file):
        sd = torch.load(split_file, map_location="cpu", weights_only=False)
        splits = tuple(np.asarray(sd[k]) for k in SPLIT_KEYS)
    else:
        perm = np.random.default_rng(42).permutation(n_mol)
        n_test, n_val = 13000, 5000
        n_train = n_mol - n_test - n_val
        splits = (perm[: n_train // 2], perm[n_train // 2 : n_train],
                  perm[n_train : n_train + n_val], perm[n_train + n_val :])

    packed = os.path.join(root, "packed")
    os.makedirs(packed, exist_ok=True)
    for k, v in out.items():
        np.save(os.path.join(packed, f"{k}.npy"), v)
    for k, v in zip(SPLIT_KEYS, splits):
        np.save(os.path.join(packed, f"split_{k}.npy"), v)
    return out, splits


def write_processed_from_raw(root: str, raw: Dict[str, np.ndarray], splits=None) -> None:
    """Write dense raw arrays (``synthetic.generate``'s) as the reference's
    processed file, and ``splits`` (first_train, second_train, valid, test
    indices) as its split file, as ``tools/make_rehearsal_pt.py`` does."""
    mols = []
    for m in range(len(raw["num_atom"])):
        n = int(raw["num_atom"][m])
        iu, ju = np.nonzero(np.triu(raw["edge_type"][m, :n, :n], 1))
        mols.append(dict(atom_type=raw["atom_type"][m, :n], pos=raw["pos"][m, :n],
                         fc=raw["fc"][m, :n],
                         bonds=[(int(i), int(j), int(raw["edge_type"][m, i, j]))
                                for i, j in zip(iu, ju)]))
    write_processed_pt(root, mols, spectra={k: raw[k] for k in SPEC_LENS})
    if splits is not None:
        torch.save({k: torch.tensor(np.asarray(v)) for k, v in zip(SPLIT_KEYS, splits)},
                   os.path.join(root, SPLIT_FILE))
