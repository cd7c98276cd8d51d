"""The port's host packer (``diffspectra_tpu_torch/data/native.py``): its
build of ``native/packer.cc`` against the JAX package's numpy packer and
its own, with and without aromatic bonds, with and without spectra; a
failed build raises instead of falling back to numpy."""

import os

import numpy as np
import pytest

from diffspectra_tpu.data import native as jax_native
from diffspectra_tpu_torch.data import native


def _raw_batch(seed=0, B=5, N=9):
    rng = np.random.default_rng(seed)
    num_atom = rng.integers(3, N + 1, size=B).astype(np.int64)
    atom_type = rng.integers(0, 5, size=(B, N)).astype(np.int64)
    pos = rng.normal(size=(B, N, 3)).astype(np.float32)
    edge_type = np.zeros((B, N, N), np.int64)
    for b in range(B):
        for i in range(1, num_atom[b]):
            j = rng.integers(0, i)
            edge_type[b, i, j] = edge_type[b, j, i] = rng.choice([1, 2, 3, 4])
    fc = rng.integers(-1, 2, size=(B, N)).astype(np.int64)
    spectra = np.abs(rng.normal(size=(B, 101))).astype(np.float32)
    return atom_type, pos, edge_type, fc, num_atom, spectra


@pytest.mark.parametrize("include_aromatic", [False, True])
@pytest.mark.parametrize("with_spectra,use_normalize", [(True, True), (True, False),
                                                        (False, True)])
def test_packer_matches_jax_numpy(include_aromatic, with_spectra, use_normalize):
    *args, spectra = _raw_batch(seed=int(include_aromatic))
    kwargs = dict(spectra=spectra if with_spectra else None, include_aromatic=include_aromatic,
                  use_normalize=use_normalize)
    want = jax_native.pack_batch_numpy(*args, **kwargs)
    for got in (native.pack_batch(*args, **kwargs), native.pack_batch_numpy(*args, **kwargs)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert native.LIB_PATH.endswith(os.path.join("diffspectra_tpu_torch", "_build",
                                                 "libdstt_packer.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libdstt_packer.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="building the packer failed"):
        native.pack_batch(*_raw_batch()[:5])
