"""SpecFormer's masked-patch pretraining and the pretrained-encoder restore
in the port (``training/pretrain.py``, ``models/pretrained.py``) against the
JAX package's, on the CPU.

- SpecFormer's ``patch_masks`` and ``return_tokens`` against flax.
- ``masked_recon_loss`` against JAX's; one and three pretrain steps from
  the same weights and masks (dropout 0) against JAX's jitted step: the
  loss within 1e-5 relative at each step; each parameter within 1e-5 of the
  largest |parameter|, but the four biases of zero exact gradient, which
  Adam moves by rounding noise, within twice the learning rates' sum, and
  the running means (which those biases shift) within 1e-5 of their max
  plus those biases' largest difference; the learning rate against
  optax's ``warmup_cosine_decay_schedule`` at 50 counts.
- Each package's ``.npz`` is read by the other, and merged into a DMT by
  either package to the same encoder; a Lightning-layout reference
  checkpoint (allspectra and IR) is merged by both to SpecFormer
  embeddings within 1e-5; a file of which nothing matches leaves the model
  as it was.
- ``run_lib.init_train_state`` applies ``model.pretrained_specformer_path``
  before the train state and its EMA exist; ``--mode pretrain`` runs end
  to end and its file warm-starts a train run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from diffspectra_tpu.models.pretrained import load_pretrained_specformer as jax_load_pretrained
from diffspectra_tpu.models.specformer import SpecFormer as JaxSpecFormer
from diffspectra_tpu.training import pretrain as jp
from diffspectra_tpu_torch import configs, main, run_lib
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.models.pretrained import load_pretrained_specformer
from diffspectra_tpu_torch.models.specformer import SPECTRUM_LENGTHS, SpecFormer, patch_count
from diffspectra_tpu_torch.training import pretrain as tp
from diffspectra_tpu_torch.training.train_state import params_of
from diffspectra_tpu_torch.warm_state import flax_variables, init_variables, load_model_state

torch.set_num_threads(2)
PATCH, STRIDE = (20, 50, 50), (10, 25, 25)
USED = {"ir": (1,), "allspectra": (0, 1, 2)}
B, OUT = 4, 32
# the biases whose exact gradient is zero in training mode (a key bias shifts
# a softmax row; the value, to_out and ff2 biases add constants a train-mode
# BatchNorm removes): their gradient is rounding noise
NOISE_ONLY = ("self_attn/W_K/bias", "self_attn/W_V/bias", "self_attn/to_out/bias", "ff2/bias")


def _specs(version, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(np.log10(rng.gamma(1.0, 2.0, (B, SPECTRUM_LENGTHS[i])) + 1).astype(np.float32)
                 for i in USED[version])


def _jax_masks(rng, specs, version, ratio=0.4):
    """The masks JAX's pretrain step draws from ``rng``."""
    keys = jax.random.split(rng, len(specs) + 1)
    return tuple(
        jax.random.bernoulli(keys[slot], ratio,
                             (s.shape[0], patch_count(s.shape[-1], PATCH[i], STRIDE[i])))
        .astype(s.dtype) for slot, (i, s) in enumerate(zip(USED[version], specs)))


def _flat(variables):
    return {f"{tree}/{k}": np.asarray(v) for tree in ("params", "batch_stats")
            for k, v in traverse_util.flatten_dict(variables.get(tree, {}), sep="/").items()}


def _pretrainers(version, key=0):
    jmodel = jp.SpecFormerPretrainer(patch_len=PATCH, stride=STRIDE, output_dim=OUT,
                                     spectra_version=version, dropout=0.0)
    specs = _specs(version)
    masks0 = tuple(jnp.zeros((B, patch_count(s.shape[-1], PATCH[i], STRIDE[i])))
                   for i, s in zip(USED[version], specs))
    variables = jmodel.init(jax.random.PRNGKey(key), specs, masks0, deterministic=True)
    model = tp.SpecFormerPretrainer(PATCH, STRIDE, OUT, version, dropout=0.0)
    load_model_state(model, _flat(variables))
    return jmodel, variables, model, specs


@pytest.mark.parametrize("version", ["ir", "allspectra"])
def test_masked_specformer_and_loss_match_flax(version):
    jmodel, variables, model, specs = _pretrainers(version)
    masks = _jax_masks(jax.random.PRNGKey(3), specs, version)
    want = jmodel.apply(variables, specs, masks, deterministic=True)
    model.eval()
    tmasks = tuple(torch.from_numpy(np.asarray(m)) for m in masks)
    with torch.no_grad():
        got = model(tuple(torch.from_numpy(s) for s in specs), tmasks)
        pooled, tokens = model.cond_encoder(tuple(torch.from_numpy(s) for s in specs),
                                            return_tokens=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    enc = JaxSpecFormer(patch_len=PATCH, stride=STRIDE, output_dim=OUT, spectra_version=version)
    jvars = {t: variables[t]["cond_encoder"] for t in ("params", "batch_stats")}
    wp, wt = enc.apply(jvars, specs, deterministic=True, return_tokens=True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(wp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(wt), rtol=1e-5, atol=1e-5)
    # the loss over masked patches, against JAX's on the same predictions
    jl = jp.masked_recon_loss(want, specs, masks, PATCH, STRIDE, USED[version])
    tl = tp.masked_recon_loss(tuple(torch.from_numpy(np.asarray(w)) for w in want),
                              tuple(torch.from_numpy(s) for s in specs), tmasks, PATCH, STRIDE,
                              USED[version])
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)


def _pcfg(**over):
    pcfg = configs.get_smoke_config().pretrain
    pcfg.lr, pcfg.warmup, pcfg.n_iters, pcfg.weight_decay, pcfg.grad_clip = 1e-3, 2, 40, 1e-2, 1.0
    for k, v in over.items():
        setattr(pcfg, k, v)
    return pcfg


def _tx(pcfg):
    return optax.chain(optax.clip_by_global_norm(pcfg.grad_clip), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, pcfg.lr, pcfg.warmup,
                                           max(pcfg.n_iters, pcfg.warmup + 1)),
        weight_decay=pcfg.weight_decay))


@pytest.mark.parametrize("version,steps", [("ir", 1), ("ir", 3), ("allspectra", 3)])
def test_pretrain_steps_match_jax(version, steps):
    jmodel, variables, model, _ = _pretrainers(version)
    pcfg = _pcfg()
    tx = _tx(pcfg)
    jstep = jax.jit(jp.make_pretrain_step(jmodel, tx, pcfg.mask_ratio))
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    ttx = tp.PretrainOptimizer(pcfg)
    t_opt = ttx.init(params_of(model))
    step = tp.get_pretrain_step(model, ttx)
    rng = jax.random.PRNGKey(11)
    for i in range(steps):
        specs = _specs(version, seed=i + 1)
        rng, k = jax.random.split(rng)
        params, stats, opt_state, jloss = jstep(params, stats, opt_state, specs, k)
        masks = tuple(torch.from_numpy(np.asarray(m)) for m in _jax_masks(k, specs, version))
        t_opt, tloss = step(t_opt, tuple(torch.from_numpy(s) for s in specs),
                            {"masks": masks, "seed": None})
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = _flat({"params": params, "batch_stats": stats})
    got = flax_variables(model)
    assert set(got) == set(want)
    err = {k: float(np.abs(got[k] - w).max()) for k, w in want.items()}
    top = max(float(np.abs(w).max()) for k, w in want.items() if k.startswith("params/"))
    # Adam turns the rounding noise of a zero gradient into steps of up to
    # about the learning rate, whose sign neither package fixes
    moved = 2 * sum(tp.warmup_cosine_lr(pcfg, c) for c in range(steps))
    noise = max([err[k] for k in want if k.endswith(NOISE_ONLY)] + [0.0])
    assert noise <= moved, noise
    for k, w in want.items():
        if k.endswith(NOISE_ONLY):
            continue
        if k.endswith("/mean"):  # a running mean moves with the biases above it
            assert err[k] <= 1e-5 * np.abs(w).max() + noise, (k, err[k])
        else:
            assert err[k] <= 1e-5 * top, (k, err[k], top)
    if steps == 1:  # the first update's learning rate is 0: no noise yet
        assert noise == 0.0 and all(np.array_equal(got[k], want[k]) or err[k] <= 1e-5 * top
                                    for k in want)
    assert t_opt["count"] == steps


def test_learning_rate_matches_optax():
    for pcfg in (_pcfg(), _pcfg(warmup=5, n_iters=3)):
        sched = optax.warmup_cosine_decay_schedule(0.0, pcfg.lr, pcfg.warmup,
                                                   max(pcfg.n_iters, pcfg.warmup + 1))
        for count in range(50):
            np.testing.assert_allclose(tp.warmup_cosine_lr(pcfg, count), float(sched(count)),
                                       rtol=1e-6, atol=1e-12)
    assert tp.warmup_cosine_lr(_pcfg(), 0) == 0.0


def test_npz_reads_across_packages_and_merges_alike(tmp_path):
    jmodel, variables, model, _ = _pretrainers("ir", key=5)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jp.save_specformer_ckpt(jpath, variables["params"], variables["batch_stats"])
    tp.save_specformer_ckpt(tpath, model)
    for path in (jpath, tpath):
        jparams, jstats = jp.load_specformer_npz(path)
        tparams, tstats = tp.load_specformer_npz(path)
        for nested, flat in ((jparams, tparams), (jstats, tstats)):
            want = traverse_util.flatten_dict(nested, sep="/")
            assert set(want) == set(flat) and want
            for k in want:
                np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    # merged into a smoke DMT (IR, nf=32) by either package from either file
    config = configs.apply_overrides(configs.get_smoke_config(), {"model.nf": OUT,
                                                                  "model.n_layers": 1})
    for path in (jpath, tpath):
        dmt = DMT.from_config(config)
        load_model_state(dmt, init_variables(dmt, seed=0))
        before = {k: v.copy() for k, v in flax_variables(dmt).items()}
        n = load_pretrained_specformer(dmt, path, "ir")
        after = flax_variables(dmt)
        jtree = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in before.items()})
        merged = _flat(jax_load_pretrained(jtree, path, "ir"))
        assert n == sum(k.split("/")[1] == "cond_encoder" for k in after)
        for k, v in merged.items():
            np.testing.assert_array_equal(after[k], v, err_msg=k)
        assert any(not np.array_equal(after[k], before[k]) for k in after
                   if "cond_encoder" in k)


def _lightning_state(enc_params, enc_stats, version):
    """A reference checkpoint's state dict from flax SpecFormer variables
    (the inverse of the loader's key map)."""
    prefix = "model.representation_spec_model"
    sd = {}

    def put(dst, p):
        sd[f"{dst}.weight"] = torch.tensor(np.asarray(p["kernel"]).T.copy())
        sd[f"{dst}.bias"] = torch.tensor(np.asarray(p["bias"]).copy())

    for k, i in enumerate(USED[version]):
        put(f"{prefix}.backbone.W_P.{k}", enc_params[f"W_P_{i}"])
    for name in ([n for n in enc_params if n.startswith("W_pos")]):
        sd[f"{prefix}.backbone.{name}"] = torch.tensor(np.asarray(enc_params[name]).copy())
    for layer in range(3):
        lp, ls = enc_params[f"encoder_layer_{layer}"], enc_stats[f"encoder_layer_{layer}"]
        base = f"{prefix}.backbone.encoder.layers.{layer}"
        for qkv in ("W_Q", "W_K", "W_V"):
            put(f"{base}.self_attn.{qkv}", lp["self_attn"][qkv])
        put(f"{base}.self_attn.to_out.0", lp["self_attn"]["to_out"])
        put(f"{base}.ff.0", lp["ff1"])
        put(f"{base}.ff.3", lp["ff2"])
        for norm in ("norm_attn", "norm_ffn"):
            sd[f"{base}.{norm}.1.weight"] = torch.tensor(np.asarray(lp[norm]["scale"]).copy())
            sd[f"{base}.{norm}.1.bias"] = torch.tensor(np.asarray(lp[norm]["bias"]).copy())
            sd[f"{base}.{norm}.1.running_mean"] = torch.tensor(
                np.asarray(ls[norm]["mean"]) + 0.1)
            sd[f"{base}.{norm}.1.running_var"] = torch.tensor(np.asarray(ls[norm]["var"]) * 1.5)
            sd[f"{base}.{norm}.1.num_batches_tracked"] = torch.tensor(7)
    put(f"{prefix}.head.linear", enc_params["head_linear"])
    sd["model.representation_model.out_norm.weight"] = torch.tensor(
        np.asarray(enc_params["out_norm"]["scale"]).copy())
    sd["model.representation_model.out_norm.bias"] = torch.tensor(
        np.asarray(enc_params["out_norm"]["bias"]).copy())
    return sd


@pytest.mark.parametrize("version", ["ir", "allspectra"])
def test_reference_checkpoint_merges_alike(version, tmp_path):
    enc = JaxSpecFormer(patch_len=PATCH, stride=STRIDE, output_dim=OUT, spectra_version=version)
    specs = _specs(version, seed=9)
    init = enc.init(jax.random.PRNGKey(0), specs)
    donor = enc.init(jax.random.PRNGKey(99), specs)
    path = str(tmp_path / "specformer.ckpt")
    torch.save({"state_dict": _lightning_state(donor["params"], donor["batch_stats"], version)},
               path)
    jvars = jax_load_pretrained({t: {"cond_encoder": init[t]} for t in init}, path, version)
    want = enc.apply({t: jvars[t]["cond_encoder"] for t in jvars}, specs)

    holder = torch.nn.Module()
    holder.cond_encoder = SpecFormer(version, PATCH, STRIDE, output_dim=OUT)
    load_model_state(holder.cond_encoder, _flat(init))
    n = load_pretrained_specformer(holder, path, version)
    assert n == len(holder.cond_encoder.state_dict())
    with torch.no_grad():
        got = holder.cond_encoder(tuple(torch.from_numpy(s) for s in specs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    first = np.asarray(enc.apply(init, specs))
    assert np.abs(got.numpy() - first).max() > 1e-3  # the donor, not the init

    # a file of which nothing matches leaves the model as it was
    torch.save({"state_dict": {"other.weight": torch.zeros(3)}}, path)
    before = {k: v.clone() for k, v in holder.cond_encoder.state_dict().items()}
    assert load_pretrained_specformer(holder, path, version) == 0
    assert all(torch.equal(v, holder.cond_encoder.state_dict()[k]) for k, v in before.items())


def test_pretrain_mode_feeds_a_train_run(tmp_path):
    over = ["model.nf=32", "model.n_layers=1", "model.n_heads=4", "pretrain.n_iters=4",
            "pretrain.log_freq=2", "pretrain.snapshot_freq=100", "data.synthetic_size=96"]
    args = ["--smoke", "--device", "cpu"] + [a for o in over for a in ("--config", o)]
    pre = str(tmp_path / "pre")
    model = main.main(["--mode", "pretrain", "--workdir", pre, *args])
    path = os.path.join(pre, tp.CKPT_NAME)
    with open(os.path.join(pre, "pretrain_stdout.txt")) as f:
        log = f.read()
    assert "pretrain step: 4, loss:" in log and "spectra/sec" in log
    saved, _ = tp.load_specformer_npz(path)
    encoder = flax_variables(model.cond_encoder)
    for k, v in saved.items():
        np.testing.assert_array_equal(v, encoder[f"params/{k}"])

    config = configs.get_smoke_config()
    configs.apply_overrides(config, main.parse_overrides(config, over + [
        f"model.pretrained_specformer_path={path}"]))
    _, state = run_lib.init_train_state(config, torch.device("cpu"))
    got = flax_variables(state.model)
    shadow = flax_variables(state.model, state.ema.shadow_params)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[f"params/cond_encoder/{k}"], v)
        np.testing.assert_array_equal(shadow[f"params/cond_encoder/{k}"], v)
    train = str(tmp_path / "train")
    state = main.main(["--mode", "train", "--workdir", train, *args, "--config",
                       f"model.pretrained_specformer_path={path}", "--config",
                       "training.n_iters=1", "--config", "training.snapshot_sampling=false"])
    assert state.step == 2
    with open(os.path.join(train, "stdout.txt")) as f:
        assert "Load pretrained SpecFormer" in f.read()
    with pytest.raises(ValueError, match="KEY=VALUE"):
        main.main(["--mode", "pretrain", "--workdir", pre, "--config", "pretrain.n_iters"])
