"""Plain-Python configuration of serving, the evaluation sweep and training.

Replaces ``diffspectra_tpu/configs/diffspectra_qm9s.py``, ``base_qm9.py``,
``smoke.py`` and ``smoke_2d.py`` (all ``ml_collections``) with nested
``SimpleNamespace`` trees holding only the values that serving, the sweep
and its metrics, the train loop and SpecFormer's pretraining read, at the
JAX package's defaults. ``apply_overrides`` takes the same dotted
``{"model.nf": 64}`` overrides as the JAX ``Elucidator``;
``resolve_runtime_config`` sizes the batches for the ranks that run.
"""

from __future__ import annotations

from types import SimpleNamespace as NS
from typing import Optional

import torch


def get_config() -> NS:
    """The QM9S allspectra flagship: DMT nf=256, 8 blocks, 16 heads (2 of
    them adjacency heads), N <= 29, 1000 ancestral steps, the cosine
    schedule. The model keys ``name``, ``trans_ver``, ``specformer_bf16``,
    ``include_fc_charge``, ``cond_time``, ``dist_gbf``, ``gbf_name`` and
    ``rw_depth`` and the schedules of ``sde.schedule`` take the JAX
    config's values; the port runs what the JAX config fixes as
    compress_edge=True, so that is no key here. The model runs in
    bfloat16, as the JAX config's ``training.matmul_precision``."""
    return NS(
        seed=42,
        # diffuse the bonds beside the atoms; False selects the node loss
        # (training/losses.py), which no model of the JAX package runs
        pred_edge=True,
        # the 2-D path: atoms and bonds, no positions (CDGS, get_smoke_2d_config)
        only_2D=False,
        # 'diffspectra': the 4-way conditional split; else the original-QM9 split
        exp_type="diffspectra",
        data=NS(
            # the QM9S store (data/qm9s.py): <root>/packed/*.npy, or the
            # reference's processed/data_qm9_allspectra.pt converted once
            root="data/QM9S",
            # True: the synthetic set below in place of QM9S (tests, smoke runs)
            synthetic=False,
            info_name="qm9_second_half",
            centered=True,
            atom_types=5,
            fc_scale=(-1.0, 1.0),
            max_node=29,
            spectra_version="allspectra",
            # the sweep's synthetic dataset: generate(seed, synthetic_size,
            # max_node, fidelity=synthetic_fidelity), split by seed
            synthetic_size=4096,
            synthetic_fidelity=1,
            # a directory to keep generated synthetic sets in ('' keeps none)
            synthetic_cache="",
            # the train split on the device, each batch gathered there from
            # an index vector (data/device_store.py), when it fits
            # device_store_max_bytes; else the host iterator
            device_resident=True,
            device_store_max_bytes=6_000_000_000,
            # the dataset transform and the training batches
            include_aromatic=False,
            use_normalize=True,
            aug_translation_scale=0.1,
            # atom-count buckets of the training batches (empty: one static N)
            bucket_sizes=(),
        ),
        # 'cosine', 'linear' (with the betas below) or 'discrete_poly'
        sde=NS(schedule="cosine", continuous_beta_0=0.1, continuous_beta_1=20.0),
        model=NS(
            # the registered model (utils/registry.py): 'DMT', the
            # equivariant flagship, 'DMT_WO_EQ', its non-equivariant
            # ablation, or 'CDGS', the 2-D model of only_2D
            name="DMT",
            # DMT_WO_EQ's attention: 'v1' (per-head q/k/v, tanh edge gates),
            # 'v2' (fused qkv, additive edge key and value) or 'optim' (fused
            # qkv, tanh edge gates)
            trans_ver="v2",
            # the DMT's SpecFormer in the working dtype (its products in
            # bfloat16 under training.matmul_precision='bfloat16'); off, as
            # in the JAX config
            specformer_bf16=False,
            pred_data=True,
            # the formal charge as the last node channel
            include_fc_charge=True,
            # the time embedding and its adaLN modulation of every block
            cond_time=True,
            # the Gaussian basis of distances ('CondGaussianLayer', time
            # conditioned, or 'GaussianLayer'); False: the raw distance
            dist_gbf=True,
            gbf_name="CondGaussianLayer",
            normalize_factors="1, 4, 4, 1",
            edge_ch=2,
            nf=256,
            n_layers=8,
            n_heads=16,
            n_extra_heads=2,
            self_cond=True,
            self_cond_type="ori",
            edge_quan_th=0.0,
            CoM=True,
            mlp_ratio=2,
            spatial_cut_off=2.0,
            softmax_inf=True,
            patch_len=(20, 50, 50),
            stride=(10, 25, 25),
            # CDGS's random-walk steps (its landing probabilities and
            # shortest-path one-hot)
            rw_depth=8,
            # the JAX package's use_pallas=True with these pallas_ops: the
            # kernels always run for CUDA tensors. ('attn', 'equi'): the
            # attention and equi-update kernels; ('block',): the whole-block
            # kernel in every block, where the JAX block takes it (cond_time
            # and dist_gbf on; else its XLA branch, no kernel)
            pallas_ops=("attn", "equi"),
            # training
            dropout=0.1,
            ema_decay=0.999,
            loss_weights="1., 0.25, 0.1",
            noise_align=True,
            # encode the spectra once a train step for both self-conditioning
            # forwards (training/losses.py)
            reuse_cond_emb=True,
            # 'full': each block recomputed in the backward pass
            # (torch.utils.checkpoint); 'dots': the 2-D weight products'
            # outputs kept, the rest recomputed; 'none': activations kept
            remat_policy="full",
            # a pretrained SpecFormer merged into cond_encoder before the
            # train state is built: the reference's Lightning checkpoint or
            # the .npz of --mode pretrain (models/pretrained.py)
            pretrained_specformer_path="",
        ),
        # 'ancestral', 'dpm_solver' (DPM-Solver++(2M)) or 'dpm_solver_sde'
        sampling=NS(steps=1000, method="ancestral"),
        training=NS(
            # the DMT's working dtype, as the JAX config's: 'bfloat16' (its
            # production default) or 'float32' (MATMUL_PRECISIONS)
            matmul_precision="bfloat16",
            # the ranks (one process a device) training and sweeping; 0: all
            # of them (the process group's world size, 1 without one); any
            # other value must equal it
            num_devices=0,
            # 0 in batch_size, eval_batch_size, eval_samples and
            # eval.batch_size: base_batch_size x num_devices
            # (resolve_runtime_config), 128 on one device
            base_batch_size=128,
            batch_size=0,
            n_iters=2000000,
            log_freq=500,
            snapshot_freq=50000,
            snapshot_freq_for_preemption=10000,
            snapshot_sampling=True,
            eval_batch_size=0,
            eval_samples=0,
            reduce_mean=False,
            # a warm-state .npz to start from when the workdir has no checkpoint
            warm_start="",
            # restore only the leaves of the same path and shape (say, an
            # allspectra model from an IR-only state), the rest fresh
            warm_start_partial=False,
            # comma-separated substrings of flax paths: fresh leaves matching
            # one are zeroed (e.g. 'cond_encoder/head_linear/kernel')
            warm_start_zero_fresh="",
            # a torch.profiler trace of steps [init+10, init+15) to <workdir>/profile
            profile=False,
        ),
        optim=NS(optimizer="AdamW", lr=2e-4, beta1=0.9, eps=1e-8, warmup=100000,
                 grad_clip=10.0, weight_decay=0.0),
        # SpecFormer's masked-patch pretraining (training/pretrain.py);
        # batch_size 0 means training.base_batch_size
        pretrain=NS(mask_ratio=0.4, n_iters=200000, batch_size=0, lr=1e-4, warmup=10000,
                    weight_decay=1e-4, grad_clip=1.0, dropout=0.1, log_freq=500,
                    snapshot_freq=20000),
        eval=NS(
            # False: --mode eval loads each checkpoint and samples nothing
            enable_sampling=True,
            # the sub-geometry MMDs (bond lengths, angles, dihedrals) of the
            # 2D-checked molecules against <data.root>/target_geometry_stat.pk
            sub_geometry=True,
            # "true": pickle the sweep's 3D, 2D and target molecules under
            # <eval_dir>/molecules_ckpt_<ckpt> (evaluation/base_metrics.py)
            save_mols="false",
            bucket_sizes=(17, 21, 25, 29),
            # the sweep: num_samples test targets in rounds of batch_size
            # (0: training.base_batch_size x training.num_devices), each
            # drawn num_candidates times
            num_samples=10000,
            batch_size=0,
            num_candidates=1,
            sampling_temperature=1.0,
            # the numbered checkpoints --mode eval sweeps: ckpts ("1,2"), or
            # begin_ckpt ... end_ckpt
            ckpts="",
            begin_ckpt=40,
            end_ckpt=40,
        ),
    )


def get_base_qm9_config() -> NS:
    """The original-QM9 configuration of ``configs/base_qm9.py``, whose
    only use is the metric reference sets of the sweep: ``exp_type``
    ``'vpsde_edge_cond'`` (the original-QM9 split), ``data.info_name``
    ``'qm9_with_h'``, allspectra."""
    config = get_config()
    config.exp_type = "vpsde_edge_cond"
    config.data.spectra_version = "allspectra"
    config.data.info_name = "qm9_with_h"
    return config


# the data keys get_base_qm9_config sets itself
BASE_QM9_DATA_KEYS = ("info_name", "spectra_version")


def original_qm9_config(config: NS, overrides: Optional[dict] = None) -> NS:
    """``get_base_qm9_config()`` with the ``data`` keys of ``config`` but
    those it sets itself (``BASE_QM9_DATA_KEYS``), then ``overrides``: the
    original-QM9 reference config that follows the main config's data (a
    synthetic set's size, fidelity and cache, or QM9S's root)."""
    original = get_base_qm9_config()
    for key, value in vars(config.data).items():
        if key not in BASE_QM9_DATA_KEYS:
            setattr(original.data, key, value)
    return apply_overrides(original, overrides)


def get_smoke_config() -> NS:
    """The small test model of ``configs/smoke.py``: IR only, N <= 16,
    nf=64, 4 blocks, 8 heads, 50 steps, float32, no buckets; a sweep of 8
    targets in rounds of 8 over 256 synthetic molecules, of checkpoint 1;
    training at batch 8, dropout 0, warmup 10, 20 steps (a log line every
    5, a snapshot at 20, a preemption checkpoint every 10); pretraining 10
    steps at batch 8, warmup 2, dropout 0."""
    config = get_config()
    config.data.synthetic = True
    config.data.spectra_version = "ir"
    config.data.max_node = 16
    config.model.nf = 64
    config.model.n_layers = 4
    config.model.n_heads = 8
    config.sampling.steps = 50
    config.training.matmul_precision = "float32"
    config.data.synthetic_size = 256
    config.eval.bucket_sizes = ()
    config.eval.num_samples = 8
    config.eval.batch_size = 8
    config.model.dropout = 0.0
    t = config.training
    t.batch_size = t.eval_batch_size = t.eval_samples = 8
    t.n_iters, t.log_freq, t.snapshot_freq, t.snapshot_freq_for_preemption = 20, 5, 20, 10
    t.base_batch_size = 8
    config.optim.warmup = 10
    p = config.pretrain
    p.n_iters, p.batch_size, p.warmup, p.log_freq, p.snapshot_freq, p.dropout = 10, 8, 2, 5, 10, 0.0
    config.eval.begin_ckpt = config.eval.end_ckpt = 1
    return config


def get_smoke_2d_config() -> NS:
    """The 2-D path of ``configs/smoke_2d.py``: the smoke config with
    ``only_2D``, CDGS (a noise-prediction model: no data prediction, no
    self-conditioning, no noise alignment, no charge channel) and 4
    random-walk steps."""
    config = get_smoke_config()
    config.only_2D = True
    m = config.model
    m.name = "CDGS"
    m.pred_data = m.self_cond = m.noise_align = m.include_fc_charge = False
    m.rw_depth = 4
    return config


def resolve_runtime_config(config: NS, n_devices: int) -> NS:
    """The JAX package's device-count scaling, in place: ``training.
    num_devices`` 0 becomes ``n_devices``, and a batch size of 0
    (``training.batch_size``, ``eval_batch_size``, ``eval_samples``,
    ``eval.batch_size``) becomes ``base_batch_size x num_devices``; returns
    ``config``. SpecFormer's pretraining scales nothing."""
    t = config.training
    if t.num_devices == 0:
        t.num_devices = n_devices
    per_run = t.base_batch_size * t.num_devices
    for node, key in ((t, "batch_size"), (t, "eval_batch_size"), (t, "eval_samples"),
                      (config.eval, "batch_size")):
        if getattr(node, key) == 0:
            setattr(node, key, per_run)
    return config


MATMUL_PRECISIONS = ("bfloat16", "float32")


def model_dtype(config: NS) -> torch.dtype:
    """The model's working dtype, from ``training.matmul_precision``; any other
    value than those of MATMUL_PRECISIONS raises."""
    precision = config.training.matmul_precision
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"training.matmul_precision is {precision!r}; takes one of "
                         f"{MATMUL_PRECISIONS}")
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


def apply_overrides(config: NS, overrides: Optional[dict]) -> NS:
    """Set ``{"a.b.c": value}`` entries in place; unknown paths raise."""
    for dotted, value in (overrides or {}).items():
        node = config
        *path, leaf = dotted.split(".")
        for part in path:
            node = getattr(node, part)
        if not hasattr(node, leaf):
            raise AttributeError(f"unknown config key {dotted!r}")
        setattr(node, leaf, value)
    return config
