"""The atom-count head's training in the port against the JAX package on
the CPU:

- ``save_head``: a head the port wrote is read by JAX's ``load_head``, and a
  head JAX wrote by the port's, with equal metadata and count
  probabilities within 1e-6;
- ``train_head`` from JAX's ``PRNGKey(0)`` initialisation (carried across
  by ``head_from_params``: the port draws its own from a seeded
  ``torch.Generator``) against the loop of ``tools/train_atom_count.py``,
  ``optax.adam(1e-3)`` on ``softmax_cross_entropy_with_integer_labels``:
  each epoch's mean loss and the final parameters within 1e-5; under one
  batch of rows no step is taken in either;
- ``held_out_metrics`` equal to that tool's formulas;
- ``embed_all`` through ``warm_qm9s_f4.npz``'s SpecFormer within 1e-4 of
  JAX's ``encode_spec_pooled``;
- the trainer's ``main`` end to end on the CPU, and its refusal without
  CUDA.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.configs import diffspectra_qm9s
from diffspectra_tpu.models import atom_count as jac
from diffspectra_tpu.models.dmt import DMT as JaxDMT
from diffspectra_tpu.warm_state import _decode
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data.synthetic import generate
from diffspectra_tpu_torch.models import atom_count as ac
from diffspectra_tpu_torch.tools import train_atom_count as tac

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM_F4 = os.path.join(ROOT, "artifacts", "warm_qm9s_f4.npz")
IN_DIM = 32


def _jax_init(in_dim=IN_DIM, max_n=29, hidden=256):
    head = jac.AtomCountHead(max_n=max_n, hidden=hidden)
    return head, head.init(jax.random.PRNGKey(0), jnp.zeros((2, in_dim)))["params"]


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _port_params(head):
    return {k: v.detach().numpy() for k, v in head.state_dict().items()}


def _jax_flat(params):
    return {k.replace("/", "."): np.asarray(v)
            for k, v in traverse_util.flatten_dict(_numpy_tree(params), sep="/").items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_head_files_cross_between_the_packages(tmp_path, writer):
    jhead, jparams = _jax_init(hidden=64)
    # move the biases off zero so that every array is checked
    jparams = jax.tree_util.tree_map(
        lambda v: v + 0.01 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size, jparams)
    meta = {"warm": "w.npz", "fidelity": 4, "spectra": "ir", "test_top1": 0.5}
    path = str(tmp_path / "head.npz")
    if writer == "port":
        ac.save_head(path, ac.head_from_params(_numpy_tree(jparams), 29, 64, "cpu"), meta=meta)
        rhead, rparams, rmeta = jac.load_head(path)
        assert (rhead.max_n, rhead.hidden) == (29, 64)
        emb = np.random.default_rng(1).normal(size=(5, IN_DIM)).astype(np.float32)
        got = np.asarray(jac.predict_count_probs(rhead, rparams, jnp.asarray(emb)))
    else:
        jac.save_head(path, jparams, max_n=29, hidden=64, meta=meta)
        rhead, rmeta = ac.load_head(path, "cpu")
        assert (rhead.max_n, rhead.hidden) == (29, 64)
        emb = np.random.default_rng(1).normal(size=(5, IN_DIM)).astype(np.float32)
        with torch.no_grad():
            got = ac.predict_count_probs(rhead, torch.from_numpy(emb)).numpy()
    want = np.asarray(jac.predict_count_probs(jhead, jparams, jnp.asarray(emb)))
    assert rmeta == {"max_n": 29, "hidden": 64, **meta}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with np.load(path) as npz:  # the same keys, float32 kernels [in, out]
        assert sorted(npz.files) == sorted(["__meta__"] + [
            f"p/{layer}/{leaf}" for layer in ("fc1", "fc2", "out") for leaf in ("kernel", "bias")])
        assert npz["p/fc1/kernel"].shape == (IN_DIM, 64) and npz["p/out/kernel"].dtype == np.float32


def test_saved_head_reloads_bit_for_bit(tmp_path):
    head = ac.init_head(IN_DIM, hidden=16, seed=3, device="cpu")
    path = str(tmp_path / "head.npz")
    ac.save_head(path, head)
    again, meta = ac.load_head(path, "cpu")
    assert meta == {"max_n": 29, "hidden": 16}
    for k, v in head.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _jax_train(x, y, epochs, bs, params):
    """The loop of ``tools/train_atom_count.py:109-137`` on given params."""
    head = jac.AtomCountHead(max_n=29)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            logits = head.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    order_rng = np.random.default_rng(0)
    losses = []
    for _ in range(epochs):
        order = order_rng.permutation(len(x))
        tot, nb = 0.0, 0
        for i in range(0, len(x) - bs + 1, bs):
            rows = order[i:i + bs]
            params, opt_state, loss = step(params, opt_state, jnp.asarray(x[rows]),
                                           jnp.asarray(y[rows]))
            tot += float(loss)
            nb += 1
        losses.append(tot / max(nb, 1))
    return params, losses


@pytest.mark.parametrize("rows", [600, 100])  # 4 steps an epoch; under one batch, none
def test_train_head_matches_the_optax_loop(rows):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(rows, IN_DIM)).astype(np.float32)
    y = rng.integers(2, 30, size=rows).astype(np.int32)
    _, init = _jax_init()
    want_params, want_losses = _jax_train(x, y, 3, 128, init)
    start = ac.head_from_params(_numpy_tree(init), device="cpu")
    head, losses = tac.train_head(x, y, 3, bs=128, init=start, device="cpu")
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
    got, want = _port_params(head), _jax_flat(want_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    moved = any(not np.array_equal(got[k], v) for k, v in _port_params(start).items())
    assert moved == (rows >= 128) and (rows >= 128 or losses == [0.0] * 3)


def test_train_head_fresh_init_is_lecun_normal():
    x = np.zeros((4, 64), np.float32)
    head, losses = tac.train_head(x, np.full(4, 9), 1, bs=128, device="cpu")
    k = head.fc1.kernel.detach().numpy()
    assert losses == [0.0] and float(head.out.bias.detach().abs().sum()) == 0.0
    assert abs(k.std() * np.sqrt(64) - 1.0) < 0.05 and np.abs(k).max() <= 2 / np.sqrt(64) / 0.8796


def test_held_out_metrics_equal_the_tools_formulas():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(64, 30)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[5] = 0.0
    probs[5, [0, 1, 14]] = [0.6, 0.3, 0.1]  # counts under 2 never enter the set
    y = rng.integers(2, 30, size=64)
    y[:8] = probs[:8].argmax(-1)
    # tools/train_atom_count.py:149-161
    pred = probs.argmax(-1)
    top1 = float((pred == y).mean())
    order3 = np.argsort(-probs, axis=-1)[:, :3]
    top3 = float(np.any(order3 == y[:, None], axis=1).mean())
    sets = jac.top_counts(probs, coverage=0.9, cap=4)
    covered = float(np.mean([t in counts for (counts, _), t in zip(sets, y)]))
    set_sizes = np.array([len(c) for c, _ in sets])
    got = tac.held_out_metrics(probs, y)
    assert got == {"top1": top1, "top3": top3, "cover90": covered,
                   "set_size": float(set_sizes.mean())}
    assert 0 < top1 < 1 and 0 < top3 < 1


def test_embed_all_matches_jax_on_the_f4_encoder():
    cfg = configs.get_config()
    cfg.data.spectra_version = "ir"
    el = Elucidator.from_warm_state(WARM_F4, config=cfg, device="cpu")
    raw = generate(seed=42, size=8, max_n=29, fidelity=4)
    idx = np.array([6, 0, 3, 5, 1])
    got = tac.embed_all(el, raw, idx, ("ir",), bs=2)  # three calls, the last short

    jcfg = diffspectra_qm9s.get_config()
    jcfg.data.spectra_version = "ir"
    with np.load(WARM_F4, allow_pickle=False) as npz:
        trees = {tree: {k: np.asarray(v, np.float32) for k, v in _decode(npz, name).items()
                        if k.startswith("cond_encoder/")}
                 for tree, name in (("params", "ema"), ("batch_stats", "batch_stats"))}
    variables = {tree: traverse_util.unflatten_dict(flat, sep="/") for tree, flat in trees.items()}
    spec = jnp.asarray(np.log10(raw["ir"][idx] + 1.0), jnp.float32)
    want = np.asarray(jac.encode_spec_pooled(JaxDMT.from_config(jcfg), variables, spec))
    # in float32, as JAX's without specformer_bf16
    assert el.model.cond_encoder.W_P_1.dtype == torch.float32
    assert got.shape == want.shape == (5, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_trainer_main_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tac, "SYNTH_CACHE", str(tmp_path / "cache"))
    out = tmp_path / "exp" / "head.npz"
    got = tac.main(["--device", "cpu", "--warm-state", WARM_F4, "--size", "160",
                    "--epochs", "2", "--out", str(out)])
    assert os.listdir(tmp_path / "cache") == ["synth_42_160_29_qm9_second_half_f4.npz"]
    jhead, jparams, meta = jac.load_head(str(out))
    assert meta["warm"] == WARM_F4 and meta["spectra"] == "ir" and meta["fidelity"] == 4
    assert meta["test_top1"] == got["top1"] and meta["test_cover90"] == got["cover90"]
    assert jhead.max_n == 29 and jparams["fc1"]["kernel"].shape == (256, 256)
    assert all(0.0 <= v <= 1.0 for k, v in got.items() if k != "set_size")
    assert json.loads(json.dumps(meta)) == meta


def test_trainer_defaults_never_touch_the_committed_head():
    args = tac.parse_args([])
    assert args.out == "exp/atom_count_head.npz"
    assert (args.warm_state, args.size, args.fidelity, args.spectra, args.epochs) == (
        "artifacts/warm_qm9s_f4.npz", 131072, 4, "ir", 8)
    assert tac.SYNTH_CACHE == os.path.join(ROOT, "data", "synthetic_cache")


def test_trainer_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tac.main(["--warm-state", WARM_F4, "--size", "16"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tac.train_head(np.zeros((4, 8), np.float32), np.zeros(4), 1)
