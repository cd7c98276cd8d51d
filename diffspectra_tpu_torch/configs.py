"""Plain-Python configuration of the serving path.

Replaces ``diffspectra_tpu/configs/diffspectra_qm9s.py`` and
``configs/smoke.py`` (both ``ml_collections``) with nested
``SimpleNamespace`` trees holding only the values that serving reads.
``apply_overrides`` takes the same dotted ``{"model.nf": 64}`` overrides as
the JAX ``Elucidator``.
"""

from __future__ import annotations

from types import SimpleNamespace as NS
from typing import Optional


def get_config() -> NS:
    """The QM9S allspectra flagship: DMT nf=256, 8 blocks, 16 heads (2 of
    them adjacency heads), N <= 29, 1000 ancestral steps. The port serves
    what the JAX config fixes as pred_edge=True, only_2D=False,
    compress_edge=True, include_fc_charge=True, cond_time=True, dist_gbf=True
    and gbf_name='CondGaussianLayer', so those are no keys here."""
    return NS(
        data=NS(
            info_name="qm9_second_half",
            centered=True,
            atom_types=5,
            fc_scale=(-1.0, 1.0),
            max_node=29,
            spectra_version="allspectra",
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
        eval=NS(bucket_sizes=(17, 21, 25, 29)),
    )


def get_smoke_config() -> NS:
    """The small test model of ``configs/smoke.py``: IR only, N <= 16,
    nf=64, 4 blocks, 8 heads, 50 steps, no buckets."""
    config = get_config()
    config.data.spectra_version = "ir"
    config.data.max_node = 16
    config.model.nf = 64
    config.model.n_layers = 4
    config.model.n_heads = 8
    config.sampling.steps = 50
    config.eval.bucket_sizes = ()
    return config


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
