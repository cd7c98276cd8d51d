"""The Mosaic probes (``diffspectra_tpu_torch/ops/probes.py``) against the JAX
tool they replace, ``tools/diag_mosaic_bisect.py``, on the CPU.

The tool is loaded by path and not edited. Its module's ``pl`` is swapped
for a stand-in whose ``pallas_call`` runs the probe's Pallas kernel in
interpret mode on seeded normal operands of the shapes and dtypes the probe
passes (in place of its all-ones arrays) and keeps them, so that the port's
plain version gets the same operands. ``t12`` asks for its VMEM scratch only
when ``pl`` has an attribute ``pallas`` (``tools/diag_mosaic_bisect.py:150-153``),
which ``jax.experimental.pallas`` no longer has (JAX 0.9.0: without it the
kernel misses its scratch argument and raises); the stand-in supplies
``pallas.tpu`` so that t12 runs with its scratch. The tool's ``probe()`` and
``log()``, which append to a log file at a fixed path, are never called.
Loading the tool sets ``jax_compilation_cache_dir`` and ``sys.path``; the
fixture restores both.

Tolerances, plain version against the JAX probe (the same as kernel against
plain version in ``chip_smoke.py``): copies, masks, +1 and x2 (t1-t4, t9,
t11, t12) equal; tanh and softmax (t6, t8) 1e-6; the 18- and 64-wide sums
(t10, t14) 1e-5; the 64- and 252-deep products of unit normals (t5, t13)
and the bf16 product (t7, its inputs rounded to bf16 on both sides and
taken to float32) 1e-4.

The kernels run on the card only; ``chip_smoke.py`` holds them against
these plain versions there.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

from diffspectra_tpu_torch.ops import LAUNCHES, probes
from diffspectra_tpu_torch.ops.probes import PROBES
from diffspectra_tpu_torch.tools import diag_probes, probe_calls

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "diag_mosaic_bisect.py")
NAMES = [f"t{i}" for i in range(1, 15)]
ATOL = {"t1": 0.0, "t2": 0.0, "t3": 0.0, "t4": 0.0, "t9": 0.0, "t11": 0.0, "t12": 0.0,
        "t6": 1e-6, "t8": 1e-6, "t10": 1e-5, "t14": 1e-5,
        "t5": 1e-4, "t13": 1e-4, "t7": 1e-4}


class InterpretPallas:
    """The tool's ``pl``: ``pallas_call`` in interpret mode on seeded
    operands, which it keeps in ``fed``."""

    BlockSpec = pallas.BlockSpec
    pallas = SimpleNamespace(tpu=pltpu)  # the tool's test for a scratch buffer (t12)

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.fed = []

    def pallas_call(self, kernel, **kw):
        def call(*operands):
            self.fed = [jnp.asarray(self.rng.normal(size=o.shape).astype(np.float32), o.dtype)
                        for o in operands]
            return pallas.pallas_call(kernel, interpret=True, **kw)(*self.fed)
        return call


@pytest.fixture(scope="module")
def tool():
    cache_dir, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    spec = importlib.util.spec_from_file_location("diag_mosaic_bisect", TOOL)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    module.pl = InterpretPallas()
    return module


def _to_torch(a):
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_matches_the_jax_probe(tool, name):
    tool.pl.rng = np.random.default_rng(NAMES.index(name))
    want = np.asarray(getattr(tool, name)())
    probe = PROBES[name]
    operands = [_to_torch(a) for a in tool.pl.fed]
    assert [tuple(t.shape) for t in operands] == list(probe.inputs.values())
    assert all(t.dtype == probe.dtype for t in operands)
    got = probe.reference(*operands).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == probe.out_shape
    assert np.isfinite(got).all()
    assert probe.atol == ATOL[name]
    if ATOL[name] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[name])


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_version(name):
    probe = PROBES[name]
    inputs = diag_probes.probe_inputs(name, seed=5)
    before = dict(LAUNCHES)
    got = probe.wrapper(*inputs)
    assert LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, probe.reference(*inputs), rtol=0, atol=0)
    assert got.dtype == torch.float32 and tuple(got.shape) == probe.out_shape


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_refuse_other_shapes_dtypes_and_devices(name):
    probe = PROBES[name]
    inputs = diag_probes.probe_inputs(name, seed=0)
    with pytest.raises(ValueError, match="shape"):
        probe.wrapper(inputs[0][:-1], *inputs[1:])
    wrong = torch.float32 if probe.dtype == torch.bfloat16 else torch.float64
    with pytest.raises(TypeError):
        probe.wrapper(*(t.to(wrong) for t in inputs))
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe.wrapper(*(t.to("meta") for t in inputs))


def test_run_probes_on_the_cpu_passes_every_probe(capsys):
    passed = diag_probes.run_probes(device="cpu", seed=0)
    assert passed == {name: True for name in NAMES}
    assert capsys.readouterr().out.splitlines() == [f"PASS {name}" for name in NAMES]
    assert diag_probes.main(["--device", "cpu"]) == 0


def test_run_probes_reports_a_failure_and_goes_on(monkeypatch, capsys):
    """A wrapper whose result is off fails its probe alone, with the
    element where it is most off; the tool goes on to the next probe and
    exits 1."""
    off = torch.zeros(PROBES["t3"].out_shape)
    off[3, 1, 4, 1] = 0.5
    monkeypatch.setattr(probes, "t3_reference", lambda x: x + 1.5 + off)
    passed = diag_probes.run_probes(device="cpu")
    assert [name for name, ok in passed.items() if not ok] == ["t3"]
    lines = capsys.readouterr().out.splitlines()
    (x,) = diag_probes.probe_inputs("t3")
    at = (3, 1, 4, 1)
    got, want = (x + 1.5 + off)[at].item(), (x + 1.0)[at].item()
    assert len(lines) == 14 and lines[2] == (
        f"FAIL t3: 1.000e+00 > 0e+00 at {at}: x = {x[at].item():.9e}, "
        f"kernel {got:.9e}, plain {want:.9e}")
    assert diag_probes.main(["--device", "cpu"]) == 1


def test_run_probes_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_probes.run_probes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag_probes.main([])


def test_probe_calls_times_the_wrappers_on_the_cpu(capsys):
    """The per-call timing tool on the CPU: the wrappers (plain versions)
    timed, the C entries not measured, one line a probe and a JSON line."""
    assert probe_calls.main(["--device", "cpu", "--calls", "2", "--rounds", "2",
                             "--probes", "t4,t5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines[:2]] == ["[probe_calls] t4", "[probe_calls] t5"]
    assert all(line.endswith("C entry not measured") for line in lines[:2])
    rows = json.loads(lines[2])["probes"]
    assert list(rows) == ["t4", "t5"]
    assert all(set(row) == {"wrapper"} and row["wrapper"]["median_us"] > 0 for row in rows.values())
