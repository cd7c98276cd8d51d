"""The port on a bare install: in a subprocess whose import system refuses
jax, flax, optax, orbax, ml_collections, ml_dtypes, absl, rdkit, pandas,
triton and the JAX package ``diffspectra_tpu``, every module of
``diffspectra_tpu_torch`` imports, a small-config ``Elucidator`` serves on
the CPU (one request at a known atom count, one through the whole-block
path, and one without the atom count through a count head), and the
evaluation sweep scores a tiny run and writes its files. Also the entry
points' refusals: no CUDA without asking for the CPU, and the modes that
are not ported."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from diffspectra_tpu.data import synthetic as jax_synthetic
from diffspectra_tpu_torch import configs
from diffspectra_tpu_torch.api import Elucidator
from diffspectra_tpu_torch.data import synthetic
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")

BARE_INSTALL = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_collections",
               "ml_dtypes", "absl", "rdkit", "pandas", "triton", "diffspectra_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"not on the card's install: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    try:
        import diffspectra_tpu
    except ImportError:
        pass
    else:
        raise SystemExit("the import block does not hold")

    import torch
    torch.set_num_threads(2)
    import diffspectra_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        diffspectra_tpu_torch.__path__, "diffspectra_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.models.dmt import DMT
    from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

    config = configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "sampling.steps": 3})
    model = DMT.from_config(config)
    load_model_state(model, random_variables(model, seed=0))
    el = Elucidator(config, model.eval(), torch.device("cpu"))
    data = generate(seed=7, size=1, max_n=16, fidelity=4)
    n_atoms = int(data["num_atom"][0])
    result = el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=4, seed=0)
    assert result.num_draws == 4 and result.n_atoms == n_atoms
    assert sum(c.count for c in result.candidates) == 4
    assert all(c.molgraph.n_atoms == n_atoms and c.smiles is None for c in result.candidates)
    assert all(torch.isfinite(torch.from_numpy(c.positions)).all() for c in result.candidates)

    # the whole-block path, and the marginal over atom counts with a count head
    import json, os, tempfile
    import numpy as np
    configs.apply_overrides(config, {"model.pallas_ops": ("block",)})
    block = DMT.from_config(config)
    load_model_state(block, random_variables(block, seed=0))
    el = Elucidator(config, block.eval(), torch.device("cpu"))
    assert el.model.blocks[0].e_block.block_kernel
    result = el.elucidate(data["ir"][0], n_atoms=n_atoms, num_candidates=2, seed=0)
    assert sum(c.count for c in result.candidates) == 2
    rng = np.random.default_rng(0)
    head = {"p/fc1/kernel": rng.normal(size=(32, 16)), "p/fc1/bias": np.zeros(16),
            "p/fc2/kernel": rng.normal(size=(16, 16)), "p/fc2/bias": np.zeros(16),
            "p/out/kernel": rng.normal(size=(16, 17)), "p/out/bias": np.zeros(17)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.npz")
        np.savez(path, __meta__=np.asarray(json.dumps({"max_n": 16, "hidden": 16})),
                 **{k: v.astype(np.float32) for k, v in head.items()})
        el.load_count_head(path)
    result = el.elucidate(data["ir"][0], n_atoms=None, num_candidates=4, seed=0)
    assert result.n_atoms is None and result.num_draws >= 2
    counts, _ = el._predict_counts(el._prepare_context(data["ir"][0], False))
    assert {c.molgraph.n_atoms for c in result.candidates} <= set(counts)

    # the evaluation sweep, its similarity tables written without pandas
    from diffspectra_tpu_torch import run_lib
    configs.apply_overrides(config, {"data.synthetic_size": 64, "eval.num_samples": 6,
                                     "eval.num_candidates": 2})
    with tempfile.TemporaryDirectory() as tmp:
        figures = run_lib.diffspectra_evaluate(config, block.eval(), tmp, "cpu")
        assert [s["decoded"] for s in figures["sweeps"]] == [6, 6]
        from diffspectra_tpu_torch.evaluation import compute_metrics as cm
        from diffspectra_tpu_torch.evaluation.molgraph import from_decoded
        n = n_atoms
        target = from_decoded((data["pos"][0, :n], data["atom_type"][0, :n],
                               data["edge_type"][0, :n, :n], data["fc"][0, :n]),
                              ["H", "C", "N", "O", "F"])
        table = cm.evaluate_jsonl_predictions(([target], [[target]]), os.path.join(tmp, "s.csv"))
        assert table["Top-1 Accuracy"] == "1.0000" and table["MCES"] == "0.0000"
        assert sorted(os.listdir(tmp))[-3:] == [
            "s.csv", "s_detailed_scores.csv", "s_detailed_scores.json"]
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("served", len(names), "modules", len(result.candidates), "candidates")
    """
)


def test_port_imports_and_serves_on_a_bare_install():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", BARE_INSTALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served" in proc.stdout


def test_entry_points_refuse_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Elucidator.from_warm_state(WARM)  # device=None means cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Elucidator.from_warm_state(WARM, device="cuda")


def test_unported_modes_raise():
    config = configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 1, "model.n_heads": 4})
    model = DMT.from_config(config)
    load_model_state(model, random_variables(model, seed=0))
    el = Elucidator(config, model.eval(), torch.device("cpu"))
    with pytest.raises(ValueError):
        el.elucidate(np.ones(3501, np.float32), n_atoms=17)  # above max_node=16
    with pytest.raises(ValueError, match="n_atoms_list"):
        el.elucidate_batch([np.ones(3501, np.float32)], [5, 6])
    configs.apply_overrides(config, {"sde.schedule": "linear"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Elucidator(config, model.eval(), torch.device("cpu"))
    configs.apply_overrides(config, {"sde.schedule": "cosine", "model.pallas_ops": ("mlp",)})
    with pytest.raises(ValueError, match="pallas_ops"):
        DMT.from_config(config)
    with pytest.raises(AttributeError):
        configs.apply_overrides(config, {"model.use_pallas": False})


def test_synthetic_requests_match_the_jax_generator():
    want = jax_synthetic.generate(seed=7, size=3, max_n=29, fidelity=4)
    got = synthetic.generate(seed=7, size=3, max_n=29, fidelity=4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
