"""The training data path of the port against the JAX package's, on the
CPU: Kabsch alignment, the data scaler, the dataset transform, collate and
its masks, and the bucketed batch iterator (equal batches, in order, no
tolerance); the augmentation's rotations, which draw from a
``torch.Generator`` and so not JAX's numbers, by their properties.

Tolerances: Kabsch rotations and aligned positions within 1e-5 (float32
3x3 SVDs); the scaler within 1e-7; everything else exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffspectra_tpu.configs import smoke as jax_smoke
from diffspectra_tpu.data import pipeline as jax_pipeline
from diffspectra_tpu.data.transform import edge_com_spectra_transform as jax_transform
from diffspectra_tpu.ops import kabsch as jax_kabsch
from diffspectra_tpu.utils.scalers import get_data_scaler as jax_data_scaler
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.data import pipeline
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.data.transform import edge_com_spectra_transform
from diffspectra_tpu_torch.ops import kabsch
from diffspectra_tpu_torch.utils.scalers import get_data_scaler

torch.set_num_threads(2)


def _rotation(rng, reflect=False):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    if reflect:
        q = q @ np.diag([1.0, 1.0, -1.0])
    return q


@pytest.mark.parametrize("case", ["rotation", "reflection", "collinear"])
def test_kabsch_matches_jax(case):
    rng = np.random.default_rng(0)
    bs, n = 4, 7
    pos0 = rng.normal(size=(bs, n, 3))
    if case == "collinear":
        pos0 = rng.normal(size=(bs, n, 1)) * rng.normal(size=(bs, 1, 3))
    rots = np.stack([_rotation(rng, case == "reflection") for _ in range(bs)])
    pos_t = np.einsum("bij,bnj->bni", rots, pos0) + 0.05 * rng.normal(size=(bs, n, 3))
    pos0, pos_t = pos0.astype(np.float32), pos_t.astype(np.float32)
    xh = np.concatenate([pos0, rng.normal(size=(bs, n, 6))], -1).astype(np.float32)
    z_t = np.concatenate([pos_t, rng.normal(size=(bs, n, 6))], -1).astype(np.float32)
    want = np.asarray(jax_kabsch.get_align_position(jnp.asarray(z_t), jnp.asarray(xh)))
    got = kabsch.get_align_position(torch.tensor(z_t), torch.tensor(xh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_kabsch.get_align_position_v2(jnp.asarray(pos_t), jnp.asarray(pos0)))
    got = kabsch.get_align_position_v2(torch.tensor(pos_t), torch.tensor(pos0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if case != "collinear":  # a rank-1 frame has no unique rotation
        rot = kabsch.kabsch_batch(torch.tensor(pos_t), torch.tensor(pos0)).numpy()
        want_rot = np.asarray(jax_kabsch.kabsch_batch(jnp.asarray(pos_t), jnp.asarray(pos0)))
        np.testing.assert_allclose(rot, want_rot, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(rot), 1.0, rtol=1e-5)  # proper
    alpha = rng.uniform(0.2, 0.9, bs).astype(np.float32)
    sigma = np.sqrt(1 - alpha**2).astype(np.float32)
    noise = rng.normal(size=xh.shape).astype(np.float32)
    node_mask = np.ones((bs, n, 1), np.float32)
    want = np.asarray(jax_kabsch.get_align_noise(
        *(jnp.asarray(a) for a in (z_t, xh, alpha, sigma, noise, node_mask))))
    got = kabsch.get_align_noise(*(torch.tensor(a) for a in (z_t, xh, alpha, sigma, noise,
                                                             node_mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_kabsch_sends_no_gradient():
    z_t = torch.randn(2, 5, 9, requires_grad=True)
    xh = torch.randn(2, 5, 9, requires_grad=True)
    assert not kabsch.get_align_position(z_t, xh).requires_grad


def test_data_scaler_matches_jax():
    rng = np.random.default_rng(1)
    bs, n = 3, 5
    node_mask = (rng.uniform(size=(bs, n, 1)) > 0.3).astype(np.float32)
    edge_mask = node_mask[:, :, 0, None] * node_mask[:, None, :, 0]
    arrays = (rng.normal(size=(bs, n, 3)), rng.integers(0, 2, (bs, n, 5)),
              rng.integers(-1, 2, (bs, n, 1)), node_mask, rng.integers(0, 2, (bs, n, n, 2)),
              edge_mask)
    arrays = [np.asarray(a, np.float32) for a in arrays]
    want = jax_data_scaler(jax_smoke.get_config())(*(jnp.asarray(a) for a in arrays))
    got = get_data_scaler(configs.get_smoke_config())(*(torch.tensor(a) for a in arrays))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("include_aromatic", [False, True])
def test_transform_matches_jax(include_aromatic):
    raw = generate(seed=3, size=40, max_n=12, fidelity=2)
    raw["edge_type"] = raw["edge_type"].copy()
    raw["edge_type"][0, 0, 1] = raw["edge_type"][0, 1, 0] = 4  # an aromatic bond
    want = jax_transform(raw, include_aromatic=include_aromatic)
    got = edge_com_spectra_transform(raw, include_aromatic=include_aromatic)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _datasets(buckets=()):
    jcfg = jax_smoke.get_config()
    jcfg.data.synthetic_size = 96
    jcfg.data.bucket_sizes = buckets
    cfg = configs.apply_overrides(configs.get_smoke_config(), {
        "data.synthetic_size": 96, "data.bucket_sizes": buckets})
    return jax_pipeline.get_dataset(jcfg)[1], pipeline.get_dataset(cfg)[1]


@pytest.mark.parametrize("buckets,drop_last", [((), True), ((), False), ((8, 12, 16), True),
                                               ((8, 12, 16), False)])
def test_batch_iterator_and_collate_match_jax(buckets, drop_last):
    """Two epochs of batches of 8 (seeds 42 and 43): equal batches in the
    same order, the masks and the spectra included."""
    jds, ds = _datasets(buckets)
    for epoch in range(2):
        kw = dict(shuffle=True, seed=42 + epoch, drop_last=drop_last, bucket_sizes=buckets)
        want = list(jax_pipeline.get_batch_iterator(jds, 8, "ir", **kw))
        got = list(pipeline.get_batch_iterator(ds, 8, "ir", **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["context"] == (g["context"][0],)
            np.testing.assert_array_equal(g["context"][0], w["context"])
            for key in w:
                if key != "context":
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_bucket_sizes_are_validated():
    num_atom = np.array([3, 9, 14])
    assert pipeline.validate_bucket_sizes((16, 8), num_atom) == [8, 16]
    with pytest.raises(ValueError, match="add a bucket >= 14"):
        pipeline.validate_bucket_sizes((8, 12), num_atom)
    node, edge = pipeline.build_masks_np(num_atom, 16)
    want_node, want_edge = jax_pipeline.build_masks_np(num_atom, 16)
    np.testing.assert_array_equal(node, want_node)
    np.testing.assert_array_equal(edge, want_edge)


def test_inf_iterator_restarts_epochs():
    seen = []
    it = pipeline.inf_iterator(lambda epoch: iter([(epoch, 0), (epoch, 1)]))
    for _ in range(5):
        seen.append(next(it))
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0)]


def test_augmentation_rotates_and_translates():
    """Rotations are proper and orthonormal; positions keep their pairwise
    distances under rotation alone; padded atoms stay at 0; the
    translations have the configured scale (std 0.1 within 0.01 over 3000
    draws); the same generator seed gives the same batch."""
    gen = torch.Generator().manual_seed(0)
    rot = pipeline.random_rotation_matrices(gen, 500)
    eye = torch.eye(3).expand(500, 3, 3)
    np.testing.assert_allclose((rot @ rot.transpose(1, 2)).numpy(), eye.numpy(), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(rot).numpy(), 1.0, atol=1e-5)
    pos = torch.randn(1000, 6, 3)
    mask = torch.ones(1000, 6)
    mask[:, 4:] = 0
    pos = pos * mask[..., None]
    out = pipeline.augment_positions(torch.Generator().manual_seed(1), pos, mask, True, False, 0.1)
    d = lambda p: torch.cdist(p, p)
    np.testing.assert_allclose(d(out).numpy(), d(pos).numpy(), atol=1e-4)
    moved = pipeline.augment_positions(torch.Generator().manual_seed(1), pos, mask, True, True, 0.1)
    assert (moved[:, 4:] == 0).all()
    shift = (moved - out)[:, :4].mean(1)
    assert abs(shift.std().item() - 0.1) < 0.01
    again = pipeline.augment_positions(torch.Generator().manual_seed(1), pos, mask, True, True, 0.1)
    assert torch.equal(moved, again)
