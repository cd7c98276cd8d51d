"""The port's QM9S loader (``diffspectra_tpu_torch/data/qm9s.py``) and
``get_dataset`` on it, against the JAX package's, on miniature processed
files in the reference's PyG layout.

- Each package's ``write_processed_pt`` writes a file that both packages'
  ``pack_from_pyg`` and ``load_qm9s`` read to the same arrays and splits,
  equal to the molecules written; without a split file, both take the same
  seed-42 fallback split.
- ``get_dataset`` with ``data.synthetic=False`` gives JAX's four splits,
  array for array; another ``exp_type`` gives JAX's original-QM9 split.
- A file whose ``edge_index`` lacks the global node offsets is refused by
  both; a root without data raises ``FileNotFoundError``.
- The synthetic set's cache file is one format: each package reads the
  other's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.data import qm9s as jax_qm9s
from diffspectra_tpu.data import synthetic as jax_synthetic
from diffspectra_tpu.data.pipeline import get_dataset as jax_get_dataset
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.data import qm9s, synthetic
from diffspectra_tpu_torch.data.pipeline import get_dataset

SIZE, MAX_N = 40, 12
RAW = synthetic.generate(seed=3, size=SIZE, max_n=MAX_N, fidelity=1)
_perm = np.random.default_rng(5).permutation(SIZE)
SPLITS = (_perm[:14], _perm[14:28], _perm[28:32], _perm[32:])
WRITERS = {"jax": jax_qm9s.write_processed_pt, "port": qm9s.write_processed_pt}


def _mols(raw):
    out = []
    for m in range(len(raw["num_atom"])):
        n = int(raw["num_atom"][m])
        iu, ju = np.nonzero(np.triu(raw["edge_type"][m, :n, :n], 1))
        out.append(dict(atom_type=raw["atom_type"][m, :n], pos=raw["pos"][m, :n],
                        fc=raw["fc"][m, :n],
                        bonds=[(int(i), int(j), int(raw["edge_type"][m, i, j]))
                               for i, j in zip(iu, ju)]))
    return out


def _write(root, writer, splits=SPLITS):
    WRITERS[writer](str(root), _mols(RAW), spectra={k: RAW[k] for k in ("uv", "ir", "raman")})
    if splits is not None:
        torch.save({k: torch.tensor(v) for k, v in zip(qm9s.SPLIT_KEYS, splits)},
                   os.path.join(root, qm9s.SPLIT_FILE))


def _copies(root, tmp_path):
    dirs = {}
    for reader in ("jax", "port"):
        dirs[reader] = str(tmp_path / f"read_{reader}")
        shutil.copytree(root, dirs[reader])
    return dirs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_processed_file_reads_alike_in_both_packages(writer, tmp_path):
    root = tmp_path / "written"
    _write(root, writer)
    dirs = _copies(root, tmp_path)
    got = {"jax": jax_qm9s.pack_from_pyg(dirs["jax"], MAX_N),
           "port": qm9s.pack_from_pyg(dirs["port"], MAX_N)}
    for reader in ("jax", "port"):
        raw, splits = got[reader]
        for k in qm9s.RAW_KEYS:
            np.testing.assert_array_equal(raw[k], RAW[k].astype(raw[k].dtype), err_msg=k)
        for a, b in zip(splits, SPLITS):
            np.testing.assert_array_equal(a, b)
    # the packed stores each conversion left read back alike in either package
    for load in (jax_qm9s.load_qm9s, qm9s.load_qm9s):
        for reader in ("jax", "port"):
            raw, splits = load(dirs[reader], MAX_N)
            for k in qm9s.RAW_KEYS:
                np.testing.assert_array_equal(np.asarray(raw[k]), got["jax"][0][k], err_msg=k)
            for a, b in zip(splits, SPLITS):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="N=12"):
        qm9s.load_qm9s(dirs["port"], MAX_N + 1)


def test_split_fallback_matches_jax(tmp_path):
    root = tmp_path / "written"
    _write(root, "port", splits=None)
    dirs = _copies(root, tmp_path)
    want = jax_qm9s.pack_from_pyg(dirs["jax"], MAX_N)[1]
    got = qm9s.pack_from_pyg(dirs["port"], MAX_N)[1]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exp_type", ["diffspectra", "vpsde_edge_cond"])
def test_get_dataset_from_qm9s_matches_jax(exp_type, tmp_path):
    root = tmp_path / "written"
    _write(root, "jax")
    dirs = _copies(root, tmp_path)
    jcfg = diffspectra_qm9s.get_config()
    jcfg.exp_type = exp_type
    jcfg.data.root, jcfg.data.max_node, jcfg.data.spectra_version = dirs["jax"], MAX_N, "ir"
    cfg = configs.apply_overrides(configs.get_config(), {
        "exp_type": exp_type, "data.root": dirs["port"], "data.max_node": MAX_N,
        "data.spectra_version": "ir"})
    assert not cfg.data.synthetic and not jcfg.data.synthetic
    want, got = jax_get_dataset(jcfg), get_dataset(cfg)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g.indices, w.indices)
        assert set(g.arrays) == set(w.arrays)
        for k in w.arrays:
            np.testing.assert_array_equal(g.take(np.arange(len(g)))[k],
                                          w.take(np.arange(len(w)))[k], err_msg=k)
    if exp_type == "diffspectra":
        np.testing.assert_array_equal(got[1].indices, SPLITS[1])
    else:
        assert got[0].indices is got[1].indices or np.array_equal(got[0].indices,
                                                                  got[1].indices)
    raw = get_dataset(cfg, transform=False)[1]
    assert set(raw.arrays) == set(qm9s.RAW_KEYS)


def test_layout_without_offsets_is_refused(tmp_path):
    root = tmp_path / "written"
    _write(root, "port")
    path = os.path.join(root, qm9s.PROCESSED)
    data, slices = torch.load(path, weights_only=False)
    ei = data.edge_index.clone()
    atom_sl, edge_sl = slices["atom_type"], slices["edge_index"]
    for m in range(SIZE):  # each molecule's bonds in its own indices
        ei[:, edge_sl[m]:edge_sl[m + 1]] -= atom_sl[m]
    data._store._mapping["edge_index"] = ei
    torch.save((data, slices), path)
    dirs = _copies(root, tmp_path)
    with pytest.raises(ValueError, match="offset"):
        jax_qm9s.pack_from_pyg(dirs["jax"], MAX_N)
    with pytest.raises(ValueError, match="offset"):
        qm9s.pack_from_pyg(dirs["port"], MAX_N)


def test_missing_data_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic=True"):
        qm9s.load_qm9s(str(tmp_path), MAX_N)
    cfg = configs.apply_overrides(configs.get_config(), {"data.root": str(tmp_path)})
    with pytest.raises(FileNotFoundError):
        get_dataset(cfg)


def test_synthetic_cache_is_shared_with_jax(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_synthetic.generate(seed=4, size=6, max_n=MAX_N, cache_dir=jax_dir)
    got = synthetic.generate(seed=4, size=6, max_n=MAX_N, cache_dir=port_dir)
    assert os.listdir(jax_dir) == os.listdir(port_dir)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    name = os.listdir(jax_dir)[0]
    np.savez(os.path.join(jax_dir, name), **{k: v + 1 for k, v in want.items()})
    np.savez(os.path.join(port_dir, name), **{k: v + 2 for k, v in want.items()})
    # each reads the file the other's path holds, not a new draw
    read_jax = synthetic.generate(seed=4, size=6, max_n=MAX_N, cache_dir=jax_dir)
    read_port = jax_synthetic.generate(seed=4, size=6, max_n=MAX_N, cache_dir=port_dir)
    for k in want:
        np.testing.assert_array_equal(read_jax[k], want[k] + 1)
        np.testing.assert_array_equal(read_port[k], want[k] + 2)
