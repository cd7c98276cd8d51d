"""The port's data-parallel pieces that need no second process
(``diffspectra_tpu_torch/parallel/``, the sharded half of
``data/device_store.py``, ``configs.resolve_runtime_config`` and the
sweep's ``sampling_world``) against the JAX package's, on the CPU:

- ``sampling_world`` gives ``run_lib._sampling_mesh``'s batch and fan-out
  on JAX meshes of 8 and 1 devices for batches 128, 100 and 4;
- the resolved batch sizes equal ``run_lib.resolve_runtime_config``'s at
  1, 2 and 8 devices, and at world size 1 today's (128; 8 in the smoke
  config);
- ``sharded_index_iterator`` and ``sharded_bucket_index_iterator`` give
  JAX's sequences exactly for several seeds, shapes and shuffles (a short
  shard wrapping around, rows carried up, a shard without rows of a
  bucket, a bucket no row of some shard fits), and both refuse rows above
  the last bucket;
- rank ``d``'s ``DeviceStore`` shard equals block ``d`` of JAX's sharded
  store (wrap-padded), and its ``build_batch`` of shard-local indices
  equals JAX's ``build_batch`` inside ``shard_map``, exactly;
- ``shard_batch``, ``global_index_array``, ``rank_seed`` and
  ``create_mesh``'s refusal of a ``num_devices`` other than the world
  size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from diffspectra_tpu import run_lib as jax_run_lib
from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.data import device_store as jax_store
from diffspectra_tpu.data.pipeline import get_dataset as jax_get_dataset
from diffspectra_tpu.parallel import create_mesh as jax_create_mesh
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.data import device_store
from diffspectra_tpu_torch.data.pipeline import get_dataset
from diffspectra_tpu_torch.parallel import create_mesh, rank_seed, shard_batch
from diffspectra_tpu_torch.sampling.harness import sampling_world

torch.set_num_threads(2)


@pytest.mark.parametrize("batch", [128, 100, 4])
def test_sampling_world_matches_jax(batch):
    for n_dev in (8, 1):
        mesh, want = jax_run_lib._sampling_mesh(jax_create_mesh(n_dev), batch)
        fan, got = sampling_world(n_dev, batch)
        assert got == want and (fan > 1) == (mesh is not None), (n_dev, batch)
        assert fan in (1, n_dev)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_resolved_batch_sizes_match_jax(n_dev):
    jcfg = diffspectra_qm9s.get_config()
    jcfg.training.prng_impl = ""  # leave JAX's generator as the suite set it
    jax_run_lib.resolve_runtime_config(jcfg, n_dev)
    cfg = configs.resolve_runtime_config(configs.get_config(), n_dev)
    got = (cfg.training.num_devices, cfg.training.batch_size, cfg.training.eval_batch_size,
           cfg.training.eval_samples, cfg.eval.batch_size)
    want = (jcfg.training.num_devices, jcfg.training.batch_size, jcfg.training.eval_batch_size,
            jcfg.training.eval_samples, jcfg.eval.batch_size)
    assert got == want == (n_dev,) + (128 * n_dev,) * 4
    smoke = configs.resolve_runtime_config(configs.get_smoke_config(), n_dev)
    assert (smoke.training.batch_size, smoke.eval.batch_size) == (8, 8)  # set, not scaled
    # serving resolves for one device whatever the config's training says
    assert configs.resolve_runtime_config(configs.get_config(), 1).eval.batch_size == 128


@pytest.mark.parametrize("shard,n_dev,per_dev,shuffle,seed", [
    (10, 4, 3, True, 1), (37, 2, 8, True, 5), (16, 8, 2, False, 0), (5, 3, 5, True, 9)])
def test_sharded_index_iterator_matches_jax(shard, n_dev, per_dev, shuffle, seed):
    want = list(jax_store.sharded_index_iterator(shard, n_dev, per_dev, shuffle, seed))
    got = list(device_store.sharded_index_iterator(shard, n_dev, per_dev, shuffle, seed))
    assert len(got) == len(want) == shard // per_dev
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _bucket_cases():
    rng = np.random.default_rng(7)
    yield "spread", rng.integers(5, 30, size=4 * 32).astype(np.int32), 32, 4, 3, (18, 23, 29)
    # a sparse tail bucket: its rows carry up, and short shards wrap around
    skewed = np.concatenate([np.full(50, 8), np.full(10, 14), np.full(4, 28)])
    yield "short_shards", rng.permutation(skewed).astype(np.int32), 16, 4, 5, (10, 16, 29)
    # shard 0 has no rows of the 29 bucket (fallback to its smaller rows)
    yield "empty_shard", np.concatenate([np.full(8, 6), [6, 6, 20, 20, 20, 20, 20, 20]]).astype(
        np.int32), 8, 2, 2, (10, 29)
    # no row of shard 1 fits the 10 bucket: it is skipped and carried up
    yield "infeasible", np.concatenate([[6, 7, 8, 9, 20, 21], [20, 22, 24, 26, 28, 29]]).astype(
        np.int32), 6, 2, 2, (10, 29)


@pytest.mark.parametrize("case", [c[0] for c in _bucket_cases()])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_bucket_index_iterator_matches_jax(case, shuffle):
    _, num_atom, shard, n_dev, per_dev, buckets = next(c for c in _bucket_cases() if c[0] == case)
    for seed in (0, 3, 11):
        want = list(jax_store.sharded_bucket_index_iterator(
            num_atom, shard, n_dev, per_dev, buckets, shuffle=shuffle, seed=seed))
        got = list(device_store.sharded_bucket_index_iterator(
            num_atom, shard, n_dev, per_dev, buckets, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) > 0
        per_shard = num_atom.reshape(n_dev, shard)
        for (gp, gi), (wp, wi) in zip(got, want):
            assert gp == wp
            np.testing.assert_array_equal(gi, wi)
            for d in range(n_dev):
                block = device_store.global_index_array(gi, d, n_dev)
                np.testing.assert_array_equal(block, gi[d * per_dev:(d + 1) * per_dev])
                assert per_shard[d][block].max() <= gp


def test_bucketed_iterators_refuse_uncovered_rows():
    num_atom = np.array([10, 12, 26, 29], dtype=np.int32)
    for it in (jax_store.sharded_bucket_index_iterator, device_store.sharded_bucket_index_iterator):
        with pytest.raises(ValueError, match="never be trained"):
            next(it(n_dev=2, shard_size=2, per_dev_batch=1, bucket_sizes=(17, 25),
                    num_atom=num_atom))


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_sharded_store_matches_jax(n_dev):
    jcfg = jax_smoke.get_config()
    jcfg.data.spectra_version = "allspectra"
    cfg = configs.apply_overrides(configs.get_smoke_config(), {"data.spectra_version": "allspectra"})
    jds, ds = jax_get_dataset(jcfg)[1], get_dataset(cfg)[1]
    mesh = jax_create_mesh(n_dev)
    jstore = jax_store.DeviceStore(jds, "allspectra", mesh=mesh)
    kw = dict(atom_types=cfg.data.atom_types, include_aromatic=cfg.data.include_aromatic,
              spectra_keys=device_store.SPECTRA_KEYS["allspectra"])
    shard = jstore.shard_size
    local = np.random.default_rng(0).integers(0, shard, size=(n_dev, 3))
    want = jax.jit(shard_map(
        lambda arrays, i: jax_store.build_batch(arrays, i, n_pad=12, **kw), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=P("data"), check_vma=False,
    ))(jstore.arrays(), jnp.asarray(local.reshape(-1), jnp.int32))
    full = {k: np.asarray(v) for k, v in jstore.arrays().items()}
    for d in range(n_dev):
        store = device_store.DeviceStore(ds, "allspectra", torch.device("cpu"), d, n_dev)
        assert store.shard_size == shard and len(store) == shard
        np.testing.assert_array_equal(store.host_num_atom, jstore.host_num_atom)
        for k, v in store.arrays.items():
            np.testing.assert_array_equal(v.numpy(), full[k][d * shard:(d + 1) * shard], k)
        got = device_store.build_batch(store.arrays, torch.from_numpy(local[d]), n_pad=12, **kw)
        rows = slice(3 * d, 3 * d + 3)
        for k in ("atom_one_hot", "edge_one_hot", "positions", "formal_charges", "atom_mask",
                  "edge_mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k])[rows], k)
        for g, w in zip(got["context"], want["context"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[rows])


def test_shard_batch_index_blocks_and_seeds():
    batch = {"x": np.arange(12).reshape(6, 2), "context": (torch.arange(6.0),)}
    parts = [shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert torch.equal(torch.cat([p["context"][0] for p in parts]), batch["context"][0])
    assert isinstance(parts[1]["context"], tuple)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, 0, 4)
    idx = np.arange(8)
    np.testing.assert_array_equal(device_store.global_index_array(idx, 1, 2), [4, 5, 6, 7])
    assert rank_seed(42, 0) == 42  # one process draws what it always drew
    seeds = {rank_seed(42, r) for r in range(8)}
    assert len(seeds) == 8 and all(0 <= s < 2**63 for s in seeds)
    assert rank_seed(42, 3) == rank_seed(42, 3) != rank_seed(43, 3)


def test_num_devices_must_equal_the_world_size(tmp_path):
    mesh = create_mesh(0, "cpu")
    assert (mesh.rank, mesh.world, mesh.device) == (0, 1, torch.device("cpu"))
    assert create_mesh(1, "cpu").world == 1
    with pytest.raises(ValueError, match="cannot take a subset"):
        create_mesh(2, "cpu")
    from diffspectra_tpu_torch import run_lib

    config = configs.apply_overrides(configs.get_smoke_config(), {"training.num_devices": 8})
    with pytest.raises(ValueError, match="cannot take a subset"):
        run_lib.train(config, str(tmp_path), "cpu")
