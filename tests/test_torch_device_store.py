"""The port's device-resident split (``diffspectra_tpu_torch/data/device_store.py``)
against the JAX package's and against the port's host collate, and the
train loop on either input path.

- ``build_batch`` equals JAX's ``build_batch`` and the port's
  ``collate`` of the same rows, with and without ``n_pad`` truncation
  (f32, exactly); ``estimate_bytes`` equals JAX's and the store's bytes.
- ``index_iterator`` gives JAX's ``(n_pad, idx)`` sequence for a seed,
  bucketed and not, and the rows of the port's host iterator.
- ``run_lib.train`` takes the store by default and the host iterator with
  ``data.device_resident=False`` or a split over
  ``data.device_store_max_bytes``; three steps give the same losses
  (1e-6 relative, f32) and weights on either path.
"""

import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffspectra_tpu.configs import smoke
from diffspectra_tpu.data import device_store as jax_store
from diffspectra_tpu.data.pipeline import get_dataset as jax_get_dataset
from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data import device_store
from diffspectra_tpu_torch.data.pipeline import collate, get_batch_iterator, get_dataset

torch.set_num_threads(2)
KEYS = ("atom_one_hot", "edge_one_hot", "positions", "formal_charges", "atom_mask", "edge_mask")


@functools.lru_cache(maxsize=None)
def _splits(spectra_version):
    jcfg = smoke.get_config()
    jcfg.data.spectra_version = spectra_version
    cfg = configs.apply_overrides(configs.get_smoke_config(),
                                  {"data.spectra_version": spectra_version})
    return jax_get_dataset(jcfg)[1], get_dataset(cfg)[1], cfg


@pytest.mark.parametrize("spectra_version,n_pad", [("ir", 0), ("ir", 12), ("allspectra", 10)])
def test_build_batch_matches_jax_and_collate(spectra_version, n_pad):
    jds, ds, cfg = _splits(spectra_version)
    idx = np.asarray([0, 3, 5, 7, 2], dtype=np.int64)
    keys = device_store.SPECTRA_KEYS[spectra_version]
    jstore = jax_store.DeviceStore(jds, spectra_version)
    store = device_store.DeviceStore(ds, spectra_version, torch.device("cpu"))
    want = jax_store.build_batch(jstore.arrays(), jnp.asarray(idx, jnp.int32),
                                 atom_types=cfg.data.atom_types,
                                 include_aromatic=cfg.data.include_aromatic,
                                 spectra_keys=keys, n_pad=n_pad)
    got = device_store.build_batch(store.arrays, torch.from_numpy(idx),
                                   atom_types=cfg.data.atom_types,
                                   include_aromatic=cfg.data.include_aromatic,
                                   spectra_keys=keys, n_pad=n_pad)
    rows = ds.take(idx)
    if n_pad:
        rows = {k: (v[:, :n_pad, :n_pad] if k in ("edge_one_hot", "edge_type")
                    else v[:, :n_pad] if k in ("atom_one_hot", "positions", "atom_type",
                                               "formal_charges") else v)
                for k, v in rows.items()}
    host = collate(rows, spectra_version)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
        assert got[k].dtype == torch.float32
    wctx = want["context"] if isinstance(want["context"], tuple) else (want["context"],)
    assert len(got["context"]) == len(wctx) == len(host["context"])
    for g, w, h in zip(got["context"], wctx, host["context"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), h)
    assert store.nbytes() == device_store.estimate_bytes(ds, spectra_version) \
        == jax_store.estimate_bytes(jds, spectra_version)
    assert {k: v.dtype for k, v in store.arrays.items()}["edge_type"] == torch.int8


@pytest.mark.parametrize("bucket_sizes,drop_last", [((), True), ((), False), ((10, 13, 16), True),
                                                    ((10, 13, 16), False)])
def test_index_iterator_matches_jax(bucket_sizes, drop_last):
    _, ds, _ = _splits("ir")
    num_atom = ds.arrays["num_atom"][ds.indices]
    for seed in (0, 7):
        want = list(jax_store.index_iterator(len(ds), 8, shuffle=True, seed=seed,
                                             drop_last=drop_last, bucket_sizes=bucket_sizes,
                                             num_atom=num_atom))
        got = list(device_store.index_iterator(len(ds), 8, shuffle=True, seed=seed,
                                               drop_last=drop_last, bucket_sizes=bucket_sizes,
                                               num_atom=num_atom))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the host iterator batches the same rows in the same order
        host = list(get_batch_iterator(ds, 8, "ir", shuffle=True, seed=seed,
                                       drop_last=drop_last, bucket_sizes=bucket_sizes))
        assert len(host) == len(got)
        for (_, idx), batch in zip(got, host):
            np.testing.assert_array_equal(batch["num_atom"], num_atom[idx])
    with pytest.raises(ValueError, match="num_atom"):
        next(device_store.index_iterator(len(ds), 8, bucket_sizes=(16,)))


def _train_losses(tmp_path, name, **over):
    config = configs.apply_overrides(configs.get_smoke_config(), {
        "training.n_iters": 2, "training.log_freq": 1, "training.snapshot_sampling": False,
        "training.snapshot_freq": 100, "training.snapshot_freq_for_preemption": 100,
        "data.bucket_sizes": (10, 13, 16), "model.dropout": 0.1, "model.nf": 32,
        "model.n_layers": 2, "model.n_heads": 4, "data.synthetic_size": 96, **over})
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        state = run_lib.train(config, str(tmp_path / name), "cpu")
    finally:
        root.removeHandler(handler)
    losses = [float(m.split("training_loss: ")[1].split(",")[0]) for m in lines
              if "training_loss" in m]
    return losses, lines, state.model.state_dict()


def test_store_and_host_paths_train_alike(tmp_path):
    store, store_lines, store_w = _train_losses(tmp_path, "store")
    host, host_lines, host_w = _train_losses(tmp_path, "host", **{"data.device_resident": False})
    over, over_lines, _ = _train_losses(tmp_path, "over", **{"data.device_store_max_bytes": 1000})
    assert any(m.startswith("device-resident dataset") for m in store_lines)
    assert any("data.device_resident off" in m for m in host_lines)
    assert any("over data.device_store_max_bytes" in m for m in over_lines)
    assert len(store) == len(host) == 3
    np.testing.assert_allclose(store, host, rtol=1e-6)
    np.testing.assert_allclose(over, host, rtol=0)
    # the weights after the three updates, each within 1e-6 of its max |value|
    for k, want in host_w.items():
        err = (store_w[k] - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1e-30), (k, err)
