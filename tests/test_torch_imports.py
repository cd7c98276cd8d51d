"""The port on a bare install: in a subprocess whose import system refuses
jax, flax, optax, orbax, ml_collections, ml_dtypes, absl, rdkit, triton and
the JAX package ``diffspectra_tpu``, every module of ``diffspectra_tpu_torch``
imports and a small-config ``Elucidator`` serves one request on the CPU.
Also the entry points' refusals: no CUDA without asking for the CPU, no
marginal atom-count mode, no whole-block kernel yet."""

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
               "ml_dtypes", "absl", "rdkit", "triton", "diffspectra_tpu"}

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        el.elucidate(np.ones(3501, np.float32), n_atoms=None)
    with pytest.raises(ValueError):
        el.elucidate(np.ones(3501, np.float32), n_atoms=17)  # above max_node=16
    configs.apply_overrides(config, {"model.pallas_ops": ("block",)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DMT.from_config(config)
    with pytest.raises(AttributeError):
        configs.apply_overrides(config, {"model.use_pallas": False})


def test_synthetic_requests_match_the_jax_generator():
    want = jax_synthetic.generate(seed=7, size=3, max_n=29, fidelity=4)
    got = synthetic.generate(seed=7, size=3, max_n=29, fidelity=4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
