"""Plain-Python configuration of the serving path and the evaluation sweep.

Replaces ``diffspectra_tpu/configs/diffspectra_qm9s.py`` and
``configs/smoke.py`` (both ``ml_collections``) with nested
``SimpleNamespace`` trees holding only the values that serving and the
sweep read, at the JAX package's defaults.
``apply_overrides`` takes the same dotted ``{"model.nf": 64}`` overrides as
the JAX ``Elucidator``.
"""

from __future__ import annotations

from types import SimpleNamespace as NS
from typing import Optional

import torch


def get_config() -> NS:
    """The QM9S allspectra flagship: DMT nf=256, 8 blocks, 16 heads (2 of
    them adjacency heads), N <= 29, 1000 ancestral steps. The port serves
    what the JAX config fixes as pred_edge=True, only_2D=False,
    compress_edge=True, include_fc_charge=True, cond_time=True, dist_gbf=True
    and gbf_name='CondGaussianLayer', so those are no keys here. The DMT
    runs in bfloat16, as the JAX config's ``training.matmul_precision``."""
    return NS(
        seed=42,
        data=NS(
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
        ),
        sde=NS(schedule="cosine"),
        model=NS(
            pred_data=True,
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
            # the JAX package's use_pallas=True with these pallas_ops: the
            # kernels always run for CUDA tensors. ('attn', 'equi'): the
            # attention and equi-update kernels; ('block',): the whole-block
            # kernel in every block
            pallas_ops=("attn", "equi"),
        ),
        # 'ancestral', 'dpm_solver' (DPM-Solver++(2M)) or 'dpm_solver_sde'
        sampling=NS(steps=1000, method="ancestral"),
        # the DMT's working dtype, as the JAX config's: 'bfloat16' (its
        # production default) or 'float32' (MATMUL_PRECISIONS)
        training=NS(matmul_precision="bfloat16"),
        eval=NS(
            bucket_sizes=(17, 21, 25, 29),
            # the sweep: num_samples test targets in rounds of batch_size
            # (the JAX default 0 resolves to 128 on one device), each drawn
            # num_candidates times
            num_samples=10000,
            batch_size=128,
            num_candidates=1,
            sampling_temperature=1.0,
        ),
    )


def get_smoke_config() -> NS:
    """The small test model of ``configs/smoke.py``: IR only, N <= 16,
    nf=64, 4 blocks, 8 heads, 50 steps, float32, no buckets; a sweep of 8
    targets in rounds of 8 over 256 synthetic molecules."""
    config = get_config()
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
    return config


MATMUL_PRECISIONS = ("bfloat16", "float32")


def model_dtype(config: NS) -> torch.dtype:
    """The DMT's working dtype, from ``training.matmul_precision``; any other
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
