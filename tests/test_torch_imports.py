"""The port on a bare install: in a subprocess whose import system refuses
jax, flax, optax, orbax, ml_collections, ml_dtypes, absl, rdkit, pandas,
triton and the JAX package ``diffspectra_tpu``, every module of
``diffspectra_tpu_torch`` imports, a small-config ``Elucidator`` serves on
the CPU (one request at a known atom count, one through the whole-block
path, one without the atom count through a count head, one from a
small DMT_WO_EQ built through the model registry, and one from a small
CDGS on the 2-D path, its candidates without positions), the
evaluation sweep scores a tiny run and writes its files (the moses
metrics, the sub-geometry MMDs, ChemNet, the RMSD and the rescoring CLI run
too, scipy imported where they use it), and the train
loop takes two steps, writes a checkpoint that ``torch.load`` reads with
``weights_only`` and an export a warm start reads, which the tools
``export_warm_state`` and ``warm_to_ckpt`` export and write back as a
checkpoint, the repository's other tools (the identifiability analyses, the
geometry-MMD anchor and the rehearsal file) run at tiny sizes, and ``parallel/``'s
train step takes one step in a gloo process group of one rank. The QM9S loader reads a
processed file without ``torch_geometric`` (its stand-ins registered under
the PyG names, no module of that name imported) and the host packer runs
from the port's own build, never ``native/libdiffspectra_native.so``. Also
the entry points' refusals: no CUDA without asking for the CPU, and the
modes that are not ported."""

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

    # torch's compiler front end, which torch.utils.checkpoint loads, probes
    # optional packages with find_spec, where the blocker below would raise
    # instead of answering "absent": load it first
    import torch._dynamo

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_collections",
               "ml_dtypes", "absl", "rdkit", "pandas", "triton", "diffspectra_tpu",
               "torch_geometric"}

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
    assert "torch_geometric" not in sys.modules

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
    # training: two steps of a tiny run, its checkpoint read back with
    # weights_only, and a warm start from its export
    from diffspectra_tpu_torch import checkpoint
    from diffspectra_tpu_torch.warm_state import warm_start
    configs.apply_overrides(config, {"training.n_iters": 1, "training.snapshot_freq": 1,
                                     "training.snapshot_sampling": False,
                                     "training.batch_size": 2})
    with tempfile.TemporaryDirectory() as tmp:
        state = run_lib.train(config, tmp, "cpu")
        assert state.step == 2
        blob = torch.load(os.path.join(checkpoint.numbered_checkpoint_dir(tmp, 1),
                                       checkpoint.STATE_FILE), weights_only=True)
        assert blob["step"] == 2
        _, fresh = run_lib.init_train_state(config, torch.device("cpu"))
        assert warm_start(fresh, os.path.join(tmp, "warm_state.npz")).step == 2
        # the repository's tools: the checkpoint exported, and written back
        import contextlib, io
        from diffspectra_tpu_torch.tools import export_warm_state, warm_to_ckpt
        small = ["--device", "cpu"] + [f"--config={k}={v}" for k, v in (
            ("model.nf", 32), ("model.n_layers", 2), ("model.n_heads", 4),
            ("data.max_node", 16), ("training.matmul_precision", "float32"))]
        with contextlib.redirect_stdout(io.StringIO()):
            assert export_warm_state.main(
                ["--workdir", tmp, "--out", os.path.join(tmp, "w.npz")] + small) == 0
            assert warm_to_ckpt.main(["--warm", os.path.join(tmp, "w.npz"), "--workdir",
                                      os.path.join(tmp, "back"), "--ckpt", "1"] + small) == 0
        assert os.path.exists(os.path.join(checkpoint.numbered_checkpoint_dir(
            os.path.join(tmp, "back"), 1), checkpoint.STATE_FILE))
    # data parallelism: one step of the parallel train step in a gloo group of one
    import torch.distributed as dist
    from diffspectra_tpu_torch.data.pipeline import collate, get_dataset as port_dataset
    from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
    from diffspectra_tpu_torch.parallel import Mesh, make_parallel_train_step
    from diffspectra_tpu_torch.training.losses import draw
    from diffspectra_tpu_torch.training.step import get_step_fn
    from diffspectra_tpu_torch.utils.scalers import get_data_scaler
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = Mesh(0, 1, torch.device("cpu"))
            tx, state = run_lib.init_train_state(config, mesh.device)
            step = make_parallel_train_step(get_step_fn(
                NoiseScheduleVP.from_config(config), tx, get_data_scaler(config), config,
                mesh=mesh), mesh)
            rows = port_dataset(config)[1].take(np.arange(2))
            batch = run_lib.batch_to_device(collate(rows, config.data.spectra_version), mesh.device)
            gens = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
            state, loss = step(state, batch, lambda shard: (
                shard, draw(*gens, shard, config.model.n_layers)))
            assert state.step == 1 and torch.isfinite(loss)
        finally:
            dist.destroy_process_group()
    # QM9S from a processed file in the reference's layout, and the packer
    from diffspectra_tpu_torch.data import native, qm9s
    from diffspectra_tpu_torch.data.pipeline import get_dataset
    raw = generate(seed=3, size=12, max_n=16, fidelity=1)
    with tempfile.TemporaryDirectory() as tmp:
        qm9s.write_processed_from_raw(tmp, raw, (np.arange(4), np.arange(4, 8), [8, 9], [10, 11]))
        configs.apply_overrides(config, {"data.synthetic": False, "data.root": tmp})
        second = get_dataset(config)[1]
        np.testing.assert_array_equal(second.take(np.arange(4))["atom_type"], raw["atom_type"][4:8])
    shims = sorted(n for n in sys.modules if n.split(".")[0] == "torch_geometric")
    assert shims and all(getattr(sys.modules[n], "__file__", None) is None for n in shims), shims
    out = native.pack_batch(raw["atom_type"], raw["pos"], raw["edge_type"], raw["fc"],
                            raw["num_atom"], raw["ir"])
    assert out["spectra"].shape == raw["ir"].shape
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert "libdstt_packer.so" in maps and "libdiffspectra_native" not in maps
    # the non-equivariant ablation through the registry, served; and the
    # snapshot's molecule files
    from diffspectra_tpu_torch.models.dmt_wo_eq import DMT_WO_EQ
    from diffspectra_tpu_torch.utils.registry import create_model
    from diffspectra_tpu_torch.visualize import visualize_mols
    wo_config = configs.apply_overrides(configs.get_smoke_config(), {
        "model.name": "DMT_WO_EQ", "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4,
        "sampling.steps": 3})
    wo_eq = create_model(wo_config)
    assert type(wo_eq) is DMT_WO_EQ
    load_model_state(wo_eq, random_variables(wo_eq, seed=0))
    result = Elucidator(wo_config, wo_eq.eval(), torch.device("cpu")).elucidate(
        data["ir"][0], n_atoms=n_atoms, num_candidates=2, seed=0)
    assert sum(c.count for c in result.candidates) == 2
    with tempfile.TemporaryDirectory() as tmp:
        written = visualize_mols([c.molgraph for c in result.candidates], tmp)
        assert written == len(result.candidates) == len(os.listdir(tmp))
    # the 2-D path: CDGS through the registry, served without positions
    from diffspectra_tpu_torch.models.cdgs import CDGS
    from diffspectra_tpu_torch.models.layers import sinusoidal_timestep_embedding
    from diffspectra_tpu_torch.utils.masks import get_rw_feat_dense
    cdgs_config = configs.apply_overrides(configs.get_smoke_2d_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "sampling.steps": 3})
    cdgs = create_model(cdgs_config)
    assert type(cdgs) is CDGS
    load_model_state(cdgs, random_variables(cdgs, seed=0))
    result = Elucidator(cdgs_config, cdgs.eval(), torch.device("cpu")).elucidate(
        data["ir"][0], n_atoms=n_atoms, num_candidates=2, seed=0)
    assert all(c.positions is None for c in result.candidates)
    assert sinusoidal_timestep_embedding(torch.zeros(2), 7).shape == (2, 7)
    assert get_rw_feat_dense(3, torch.ones(1, 4, 4)).shape == (1, 4, 4, 4)
    # the rest of the eval stack: the moses metrics, the sub-geometry MMDs
    # (their statistics written), ChemNet, the RMSD, and the saved molecules
    # rescored by the offline CLI
    from diffspectra_tpu_torch.data.info import get_dataset_info
    from diffspectra_tpu_torch.evaluation import base_metrics, cal_geometry, chemnet
    from diffspectra_tpu_torch.evaluation import mose_metric, rmsd
    from diffspectra_tpu_torch.evaluation.mmd import compute_mmd
    from diffspectra_tpu_torch.run_lib import save_molecules
    raw = generate(seed=5, size=12, max_n=16, fidelity=3)
    graphs = [from_decoded((raw["pos"][i, :n], raw["atom_type"][i, :n],
                            raw["edge_type"][i, :n, :n], raw["fc"][i, :n]),
                           ["H", "C", "N", "O", "F"]) for i, n in enumerate(raw["num_atom"])]
    moses = mose_metric.get_moses_metrics(graphs[:8])(graphs[8:])
    assert np.isnan(moses["FCD"]) and moses["FCD_proxy"] >= 0 and 0 <= moses["SNN"] <= 1
    with tempfile.TemporaryDirectory() as tmp:
        geo = cal_geometry.get_sub_geometry_metric(
            graphs[:8], get_dataset_info("qm9_second_half"), tmp, "cpu")(graphs[8:])
        assert geo["bond_length_mean"] >= 0
        assert os.path.exists(os.path.join(tmp, "target_geometry_stat.pk"))
        save_molecules(tmp, "1", graphs[8:], graphs[8:], graphs[8:])
        tables = base_metrics.main(["--base_path", tmp, "--ckpt", "1"])
        assert tables["2d"]["Top-1 Accuracy"] == tables["3d"]["Top-1 Accuracy"] == "1.0000"
    assert abs(compute_mmd([1.0, 2.0, 3.0], [1.0, 2.0, 3.0], device="cpu")) < 1e-6
    assert chemnet.random_chemnet(0).features(["CCO", "c1ccccc1"], device="cpu").shape == (2, 24)
    assert rmsd.hungarian_rmsd_batch(graphs[:2], graphs[:2])[1] == 1.0
    # the rest of the repository's tools, host-only but the anchor, tiny
    from diffspectra_tpu_torch.tools import (ceiling_analysis, f4_continuity, gt_mmd_anchor,
                                             make_rehearsal_pt, protocol_ceiling,
                                             unseen_env_analysis)
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        assert ceiling_analysis.main(["--fidelity", "4", "16"])[0]["n"] == 16
        assert protocol_ceiling.main(["--size", "64", "--cache-dir", tmp])["test"] == 6
        assert unseen_env_analysis.main(["--size", "64"])["test"] == 6
        assert f4_continuity.main(["--n-molecules", "4"])["f4"]
        anchor = gt_mmd_anchor.main(["--size", "64", "--n-gen", "4", "--cache-dir", tmp,
                                     "--device", "cpu"])
        assert set(anchor["gt_vs_test_stats"]) == set(gt_mmd_anchor.MEANS)
        make_rehearsal_pt.main(["--size", "16", "--root", os.path.join(tmp, "r")])
        assert os.path.exists(os.path.join(tmp, "r", qm9s.PROCESSED))
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in BLOCKED and n.split(".")[0] != "torch_geometric")
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
    # every schedule of the JAX package is ported; an unknown one raises, as
    # does 'discrete', whose betas no config holds (the JAX package's too)
    configs.apply_overrides(config, {"sde.schedule": "sigmoid"})
    with pytest.raises(ValueError, match="Unsupported noise schedule"):
        Elucidator(config, model.eval(), torch.device("cpu"))
    configs.apply_overrides(config, {"sde.schedule": "discrete"})
    with pytest.raises(ValueError, match="betas"):
        Elucidator(config, model.eval(), torch.device("cpu"))
    configs.apply_overrides(config, {"sde.schedule": "cosine", "model.remat_policy": "dots_all"})
    with pytest.raises(ValueError, match="remat_policy"):
        DMT.from_config(config)
    configs.apply_overrides(config, {"model.remat_policy": "full", "model.gbf_name": "Gauss"})
    with pytest.raises(ValueError, match="gbf_name"):
        DMT.from_config(config)
    configs.apply_overrides(config, {"model.gbf_name": "GaussianLayer",
                                     "model.pallas_ops": ("mlp",)})
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
