"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, serve.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name, power limit); TF32 off for matmuls and convolutions;
  2. build the CUDA kernels from ``diffspectra_tpu_torch/csrc`` with nvcc
     (registers and spills of each kernel from ``-Xptxas=-v``);
  3. each kernel (mix_attention, equi_update, block_fused) against its plain
     PyTorch version at the serving shape (B=10 draws, N=29, flagship
     widths) on a seeded ragged batch, with the kernel's, the plain
     version's and the bound's times; each also at B=10, N=17, 21, 25, 29,
     B=80, N=21, 29 and the sweep's B=128, N=17, 21, 25, 29 (ragged, every
     output and padding held to its tolerance), timed with L2 cold (64 MB written before each call) as
     well as warm, with each launch's device time from the profiler (five
     for block_fused); for mix_attention and equi_update also the blocks an
     SM the card gives them against their launch plan, and the cuBLAS time
     (torch.matmul, TF32 off) of their dominant products at the same shape
     as a yardstick the port never calls;
  3b. the Mosaic probes t1 ... t14 (``ops/probes.py``): the probe tool
     ``run_probes`` on cuda, each probe kernel launched once and no plain
     version on cuda; then each probe kernel against its plain version on
     cuda, with the kernel's, the plain version's, the library call's and
     the bound's times (CUDA events over 200 calls, and the kernel's and
     the library call's device time from the profiler); for every probe
     also the device time with L2 cold, the kernel's name and launch shape
     (grid, block, shared bytes, registers) as the profiler recorded them
     in that window, every block resident at once, the kernel's device
     time over the library call's, the bound's share of it and the rate it
     reaches (TB/s where bytes bound it, TFLOP/s where operations do);
  4. full-width DMT forwards from ``artifacts/warm_qm9s_as.npz`` on cuda
     (kernels) against the same models on the CPU (plain versions), for
     ``pallas_ops=('attn','equi')`` and ``('block',)``, and the two cuda
     paths against each other;
  5. serve: ``Elucidator.from_warm_state(...).elucidate(...)`` for 3 synthetic
     requests (fidelity-4 spectra) at their true atom counts, 10 candidates,
     1000 ancestral steps, once per path; each path's launch counters must
     rise by 8 blocks x steps x requests, the other path's by 0. Then on the
     block path (100 steps, cut from 1000 to keep the run short): one
     request without its atom count through the count head
     (``artifacts/atom_count_head.npz``), one without it and without the
     head (every plausible count of the train histogram, 2 draws each at 20
     steps, each count's launches counted), ``elucidate_batch`` over 8 queries
     (2 without their count), and one request each with DPM-Solver++ (ODE
     and SDE, 50 steps);
  6. a profile of DMT forwards of both paths at the serving shape (kernel
     time by name and the device's busy share);
  7. the evaluation sweep (``run_lib.evaluate``, graph mode) from
     ``artifacts/warm_qm9s_as.npz`` on the block path: 128 test targets of
     ``generate(seed=42, size=1280, fidelity=4)``'s split in rounds of 128
     (buckets 17, 21, 25, 29), K=10 sweeps of 1000 ancestral steps at
     temperature 1.0; its rounds, each sweep's wall time and mols/s, its
     rounds' seconds of sampling and of host decoding, the host scoring's
     phase times, and every figure beside round 5's (the JAX
     package in bf16 on 10k targets; the port runs f32) with the binomial
     standard error at this run's count. Gates: block_fused launched
     8 x steps x rounds x K times and no other kernel, every target decoded
     in every sweep, every figure finite and in [0, 1] (MCES >= 0), and
     Top-10 2D >= 0.85 (about 7 standard errors under round 5's 0.9664).
Then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that last line; without CUDA it exits 2.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")
HEAD = os.path.join(ROOT, "artifacts", "atom_count_head.npz")
B, N = 10, 29  # draws per request, padded atoms at the largest bucket
REQUESTS, CANDIDATES, STEPS = 3, 10, 1000
SHORT_STEPS, DPM_STEPS = 100, 50  # the count-head, batch and DPM-Solver phases
MARGINAL_STEPS, MARGINAL_DRAWS = 20, 2  # the marginal over the histogram's counts
# phase 7, the eval sweep: tools/tpu_eval_10k.py's batch of 128; a synthetic
# set of 1280 molecules, whose test split holds exactly 128 targets
SWEEP = {"seed": 42, "data.synthetic_size": 1280, "data.synthetic_fidelity": 4,
         "eval.num_samples": 128, "eval.batch_size": 128, "eval.num_candidates": 10,
         "eval.bucket_sizes": (17, 21, 25, 29), "eval.sampling_temperature": 1.0,
         "sampling.steps": 1000, "sampling.method": "ancestral", "model.pallas_ops": ("block",)}
TOP10_2D_FLOOR = 0.85  # round 5 read 0.9664: about 7 standard errors lower at 128 targets
# round 5: the JAX package (bf16) on warm_qm9s_as.npz, 10k targets of
# generate(seed=42, size=131072, fidelity=4), K=10, 1000 steps, graph mode
# (tools/pipeline_logs/r5/as_topk_10k.log:106-109, 833-860); figure name ->
# (round-5 value, whether it is a proportion of targets or of valid pairs)
ROUND5 = {
    "Metric-3D atom stability": (0.9355, None), "Metric-3D mol stability": (0.4840, "targets"),
    "Metric-3D validity": (0.8784, "targets"), "Metric-3D complete": (0.8769, "targets"),
    "Metric-2D atom stability": (0.9993, None), "Metric-2D mol stability": (0.9876, "targets"),
    "Metric-2D validity": (0.9876, "targets"), "Metric-2D complete": (0.9858, "targets"),
    # Top-1 over all targets: the Generalization lines' seen + unseen hits
    "Top-1 2D": ((5046 + 2444) / 10000, "targets"), "Top-1 3D": ((3058 + 929) / 10000, "targets"),
    "Top-10 2D": (0.9664, "targets"), "Top-10 3D": (0.4806, "targets"),
    "Consensus 2D": (0.8446, "targets"), "Consensus 3D": (0.4377, "targets"),
    "2D Top-1 Accuracy": (0.7584, "valid_2d"), "3D Top-1 Accuracy": (0.4539, "valid_3d"),
    "2D MCES": (0.8424, None), "3D MCES": (1.6808, None),
    "2D Tanimoto Similarity (Morgan)": (0.8931, None),
    "3D Tanimoto Similarity (Morgan)": (0.7131, None),
    "2D Cosine Similarity (Morgan)": (0.9918, None), "3D Cosine Similarity (Morgan)": (0.9779, None),
    "2D Functional Group Similarity": (0.9863, None),
    "3D Functional Group Similarity": (0.8679, None),
}
# not comparable with round 5: distinct structures over all targets fall as
# the target count grows, and novelty and the memorization bound count
# against each set's own train split
NOT_COMPARABLE = {"Metric-2D unique & valid": (0.7428, "distinct structures of 10k, not 128"),
                  "Metric-2D novelty": (0.4210, "against each set's own train split"),
                  "memorization bound": (0.5564, "against each set's own train split")}
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12  # H100 SXM bf16 on the tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
# block_fused: four LayerNorms and 512-deep sums in another order
KERNEL_ATOL = {"mix_attention": 1e-5, "equi_update": 1e-5, "block_fused": 1e-4}
# the probes, kernel against plain version: copies, masks, +1 and x2 exact;
# tanh and softmax 1e-6; the 18- and 64-wide sums (t10, t14) 1e-5; the
# 64- and 252-deep products of unit normals (t5, t13) and the bf16
# product (t7) 1e-4
PROBE_ATOL = {"t1": 0.0, "t2": 0.0, "t3": 0.0, "t4": 0.0, "t9": 0.0, "t11": 0.0, "t12": 0.0,
              "t6": 1e-6, "t8": 1e-6, "t10": 1e-5, "t14": 1e-5,
              "t5": 1e-4, "t13": 1e-4, "t7": 1e-4}
FORWARD_RTOL = 1e-3  # of the largest |value|: 8 blocks sum in another order
PATHS = {"attn_equi": ("attn", "equi"), "block": ("block",)}
PATH_KERNELS = {"attn_equi": ("mix_attention", "equi_update"), "block": ("block_fused",)}
# each probe's source under diffspectra_tpu_torch/csrc/ and kernel, by the
# profiler's kernel name (t3, t4: grid_step_kernel<PlusOne>, t1, t11:
# grid_step_kernel<Times2>, t6: grid_step_kernel<Tanh>, t2:
# map_kernel<Times2>, t9: map_kernel<Where>)
PROBE_KERNELS = {"t1": ("probe_tiles.cu", "grid_step_kernel"),
                 "t2": ("probe_tiles.cu", "map_kernel"),
                 "t3": ("probe_tiles.cu", "grid_step_kernel"),
                 "t4": ("probe_tiles.cu", "grid_step_kernel"),
                 "t5": ("probe_tiles.cu", "tile_product_kernel"),
                 "t6": ("probe_tiles.cu", "grid_step_kernel"),
                 "t7": ("probe_tiles.cu", "mma_tile_kernel"),
                 "t8": ("probe_tiles.cu", "row_softmax_kernel"),
                 "t9": ("probe_tiles.cu", "map_kernel"),
                 "t10": ("probe_tiles.cu", "segment_stage_kernel"),
                 "t11": ("probe_tiles.cu", "grid_step_kernel"),
                 "t12": ("probe_tiles.cu", "stage_kernel"),
                 "t13": ("probe_tiles.cu", "dot_rows_kernel"),
                 "t14": ("probe_tiles.cu", "dot_rows_kernel")}
# the template argument each probe's instance of a templated kernel must
# name: its operation, or its lanes an output
PROBE_OPS = {"t1": "Times2", "t2": "Times2", "t3": "PlusOne", "t4": "PlusOne", "t6": "Tanh",
             "t9": "Where", "t11": "Times2", "t13": "<32>", "t14": "<16>"}


def say(*parts):
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


N_NODES = (29, 21, 17, 29, 5, 25, 12, 29, 1, 19)  # a ragged batch of B graphs
# each kernel's shapes: the request buckets at B=10, elucidate_batch's
# rounds of 80 draws, where rows a tile straddle odd N and tiles are partial,
# and the eval sweep's rounds of 128 draws at each bucket (phase 7)
BLOCK_SHAPES = ((10, 17), (10, 21), (10, 25), (10, 29), (80, 21), (80, 29),
                (128, 17), (128, 21), (128, 25), (128, 29))
FLUSH_BYTES = 64 * 2**20  # written between calls to time a kernel with L2 cold
# the CUDA kernels each wrapper launches, by the profiler's names
KERNEL_STAGES = {
    "mix_attention": ("mix_attention_kernel",),
    "equi_update": ("equi_update_kernel",),
    "block_fused": ("attn_stage", "node_in_stage", "node_out_stage", "node_proj_stage",
                    "pair_stage"),
}


def ragged_masks(device, n_nodes=N_NODES, n=N):
    node = (torch.arange(n)[None] < torch.tensor(n_nodes)[:, None]).float()
    edge = node[:, :, None] * node[:, None, :] * (1.0 - torch.eye(n))
    return edge.to(device)


def attention_case(gen, dev, n_nodes=N_NODES, N=N):
    """mix_attention inputs for graphs of ``n_nodes`` atoms padded to N (the
    serving shape by default), and the work they need."""
    B = len(n_nodes)
    de, n_sub, sub_c, heads, out_ch, n_extra = 64, 14, 18, 16, 16, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    extra = (torch.rand(B, N, N, n_extra, generator=gen) > 0.5).float().to(dev)
    args = (r(B, N, n_sub, sub_c), r(B, N, n_sub, sub_c), r(B, N, heads, out_ch),
            r(B, N, N, de), r(de, n_sub * sub_c, scale=de**-0.5),
            r(de, heads * out_ch, scale=de**-0.5), extra, ragged_masks(dev, n_nodes, N))
    ec, hc = n_sub * sub_c, heads * out_ch
    # per pair: two gate projections, their tanh, q*k*e0 and the head sums,
    # the softmax, alpha*v*e1 and the j sum (dense over all N x N pairs)
    flops = B * N * N * (2 * de * (ec + hc) + (ec + hc) + 3 * ec + 3 * heads + 3 * hc)
    nbytes = 4 * (sum(a.numel() for a in args) + B * N * hc)
    return args, {"set_inf": True}, flops, nbytes


def equi_case(gen, dev, n_nodes=N_NODES, N=N):
    """equi_update inputs for graphs of ``n_nodes`` atoms padded to N (the
    serving shape by default), and the work they need."""
    B = len(n_nodes)
    de, dd, dh, n_adj = 64, 64, 256, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    adj = (torch.rand(B, N, N, n_adj, generator=gen) > 0.5).float().to(dev)
    args = (r(B, N, dh), r(B, N, dh), r(B, N, N, de), r(B, N, N, dd), r(B, N, N, 3),
            adj, ragged_masks(dev, n_nodes, N), r(de, dh, scale=de**-0.5), r(dd, dh, scale=dd**-0.5),
            r(dh, scale=0.1), r(B, dh, scale=0.1), r(B, dh, scale=0.1),
            r(dh, dh, scale=dh**-0.5), r(dh, scale=0.1), r(dh, 1 + n_adj, scale=dh**-0.5))
    # per pair: the two gate projections, the W0 product, the W1 product, and
    # about 12 operations per channel for sums, LayerNorm, modulation, silu
    flops = B * N * N * (2 * (de + dd) * dh + 2 * dh * dh + 2 * dh * (1 + n_adj) + 12 * dh)
    nbytes = 4 * (sum(a.numel() for a in args) + B * N * 3)
    return args, {}, flops, nbytes


def block_case(gen, dev, n_nodes=N_NODES, N=N):
    """block_fused inputs at flagship widths for graphs of ``n_nodes``
    atoms padded to N (the serving shape by default), and the work they
    need."""
    from diffspectra_tpu_torch.ops.block_fused import _DATA, _WEIGHTS

    B = len(n_nodes)
    dh, de, heads, out_ch, n_extra = 256, 64, 16, 16, 2
    n_sub = heads - n_extra
    ec, hc, rn, re = n_sub * (heads * out_ch // n_sub), heads * out_ch, 2 * dh, 2 * de
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    edge_mask = ragged_masks(dev, n_nodes, N)
    node_mask = (torch.arange(N)[None] < torch.tensor(n_nodes)[:, None]).float()[..., None]
    data = dict(
        h=r(B, N, dh), q=r(B, N, ec), k=r(B, N, ec), v=r(B, N, dh), edge_in=r(B, N, N, de),
        d2=r(B, N, N, 1, scale=2.0).abs(), normed_diff=r(B, N, N, 3, scale=0.1),
        adj=(torch.rand(B, N, N, n_extra, generator=gen) > 0.5).float().to(dev),
        edge_mask=edge_mask, node_mask=node_mask.to(dev), node_mods4=r(B, 4, dh, scale=0.2),
        edge_mods6=r(B, 6, de, scale=0.2), eq_ss=r(B, 2, dh, scale=0.2),
        gbf_ss=r(B, 1, 2, scale=0.2),
    )
    shapes = dict(
        emb_kd=(de, de), emb_ke=(de, de), emb_b=(de,), w0a=(de, ec), w1a=(de, dh),
        n2e_k=(dh, de), n2e_b=(de,), fn1_k=(dh, rn), fn1_b=(rn,), fn2_k=(rn, dh),
        fn2_b=(dh,), fe1_k=(de, re), fe1_b=(re,), fe2_k=(re, de), fe2_b=(de,),
        w_hi=(dh, dh), w_hj=(dh, dh), w_e=(de, dh), w_d=(de, dh), eq_bias=(dh,),
        eq_k0=(dh, dh), eq_b0=(dh,), eq_k1=(dh, 1 + n_extra),
    )
    weights = {k: r(*s, scale=s[0] ** -0.5 if len(s) == 2 else 0.1) for k, s in shapes.items()}
    weights["gbf_means"] = (torch.rand(de - 1, generator=gen) * 3).to(dev)
    weights["gbf_stds"] = (0.5 + torch.rand(de - 1, generator=gen) * 2.5).to(dev)
    args = [data[k] for k in _DATA] + [weights[k] for k in _WEIGHTS]
    # per pair: the GBF (about 8 operations a basis function), edge_emb, its
    # LayerNorm and modulation, the two gate products and their tanh, the
    # logits, alpha * v * e1, the edge residual, LayerNorm and FFN, W_e and
    # W_d, the LayerNorm and modulation of the pair, W0 and silu, W1, the
    # gate and the coordinate sum (dense over all N x N pairs)
    pair = (8 * de + 4 * de * de + 10 * de + 2 * de * (ec + hc)
            + (ec + hc) + 3 * ec + 3 * heads + 3 * hc + 12 * de + 4 * de * re + re
            + 4 * de * dh + 10 * dh + 2 * dh * dh + dh + 2 * dh * (1 + n_extra) + 12)
    # per node: n2e, the residual, LayerNorm and modulation, the node FFN,
    # W_hi and W_hj
    node = 2 * dh * de + 12 * dh + 4 * dh * rn + rn + 4 * dh * dh
    flops = B * N * N * pair + B * N * node
    nbytes = 4 * (sum(a.numel() for a in args) + B * N * dh + B * N * N * de + B * N * 3)
    return args, dict(n_heads=heads, n_extra=n_extra, out_ch=out_ch), flops, nbytes


def phase_kernels(dev):
    from diffspectra_tpu_torch.ops.block_fused import block_fused, block_fused_reference
    from diffspectra_tpu_torch.ops.equi_update import equi_update, equi_update_reference
    from diffspectra_tpu_torch.ops.mix_attention import mix_attention, mix_attention_reference

    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, kernel, plain, case, source, replaces in (
        ("mix_attention", mix_attention, mix_attention_reference, attention_case,
         "diffspectra_tpu_torch/csrc/mix_attention.cu", "diffspectra_tpu/ops/pallas_attention.py:147"),
        ("equi_update", equi_update, equi_update_reference, equi_case,
         "diffspectra_tpu_torch/csrc/equi_update.cu", "diffspectra_tpu/ops/pallas_equi_update.py:139"),
        ("block_fused", block_fused, block_fused_reference, block_case,
         "diffspectra_tpu_torch/csrc/block_fused.cu", "diffspectra_tpu/ops/pallas_block.py:230"),
    ):
        args, kw, flops, nbytes = case(gen, dev)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = 0.0
        for g, w in zip(got, want):  # every output, padded rows and pairs included
            e = (g - w).abs().max().item()
            say(f"[kernels] {name}: {tuple(g.shape)} max |kernel - plain| = {e:.3e} "
                f"(tolerance {KERNEL_ATOL[name]:.0e}, max |plain| = {w.abs().max().item():.3e})")
            assert torch.isfinite(g).all() and e <= KERNEL_ATOL[name], name
            err = max(err, e)
        ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=200)
        plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=50)
        t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        say(f"[kernels] {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain version, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   max_abs_err=err, max_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        row.update(kernel_extras(name, kernel, plain, case, dev, gen, lambda: kernel(*args, **kw)))
        row["max_abs_err"] = row["max_err"] = max(err, row["shapes_max_err"])
        if name != "block_fused":
            row.update(row_tile_extras(name, args, dev))
        rows.append(row)
    return rows


def kernel_extras(name, kernel, plain, case, dev, gen, call):
    """A kernel beyond the serving shape: against its plain version at each
    of BLOCK_SHAPES (ragged: one graph of N atoms, the rest 1..N; every
    output, padding included), then ``call`` (the serving shape) with L2
    cold (FLUSH_BYTES written before each call): CUDA events a call, and
    each launch's device time from the profiler, warm and cold."""
    err, shape_errs = 0.0, {}
    for batch, n in BLOCK_SHAPES:
        n_nodes = [n] + torch.randint(1, n + 1, (batch - 1,), generator=gen).tolist()
        args, kw, _, _ = case(gen, dev, n_nodes, n)
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        outs = ("h_out", "edge_out", "agg") if name == "block_fused" else ("out",)
        for out, g, w in zip(outs, got, want):
            e = (g - w).abs().max().item()
            say(f"[kernels] {name} B={batch} N={n}: {out} {tuple(g.shape)} max |kernel - "
                f"plain| = {e:.3e} (tolerance {KERNEL_ATOL[name]:.0e}, max |plain| = "
                f"{w.abs().max().item():.3e})")
            assert torch.isfinite(g).all() and e <= KERNEL_ATOL[name], (name, batch, n, out)
            err = max(err, e)
            shape_errs[f"B={batch} N={n}"] = max(shape_errs.get(f"B={batch} N={n}", 0.0), e)
        del args, got, want

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(50)]
    call()
    for start, end in pairs:
        flush.fill_(1.0)
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    cold_ms = sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)
    stages = KERNEL_STAGES[name]
    warm, cold = stage_ms(call, stages), stage_ms(call, stages, flush)
    fmt = lambda d: "not measured" if d is None else ", ".join(f"{k} {v:.4f}" for k, v in d.items())
    total = lambda d: None if d is None else sum(d.values())
    say(f"[kernels] {name} B={B} N={N}: {cold_ms:.4f} ms a call with L2 cold (CUDA events, "
        f"{FLUSH_BYTES >> 20} MB written before each call); device ms a call, L2 warm: "
        f"{ms_or_none(total(warm))} ({fmt(warm)}); L2 cold: {ms_or_none(total(cold))} ({fmt(cold)})")
    return dict(shapes_max_err=err, shape_errs=shape_errs, cold_ms=cold_ms, device_ms=total(warm),
                cold_device_ms=total(cold), stage_ms=warm, cold_stage_ms=cold)


def row_tile_extras(name, args, dev):
    """A row-tile kernel's launch plan at the serving shape, the blocks an
    SM the card gives it (which must be the plan's), and the cuBLAS time
    (torch.matmul, TF32 off; CUDA events over 200 calls and device time from
    the profiler) of its dominant products at the same shape: a yardstick
    the port never calls, not a library call of the kernel's function."""
    import ctypes

    from diffspectra_tpu_torch.ops import _lib
    from diffspectra_tpu_torch.ops.equi_update import launch_plan as equi_plan
    from diffspectra_tpu_torch.ops.mix_attention import launch_plan as attn_plan

    gen = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if name == "equi_update":
        dh, de, dd = args[0].shape[-1], args[2].shape[-1], args[3].shape[-1]
        plan, sizes = equi_plan(B, N, de, dd, dh), (B, N, de, dd, dh)
        x1, w1, x2, w2 = r(B * N * N, de + dd), r(de + dd, dh), r(B * N * N, dh), r(dh, dh)
        products = lambda: (x1 @ w1, x2 @ w2)
        shapes = f"[{B * N * N}, {de + dd}] @ [{de + dd}, {dh}] + [{B * N * N}, {dh}] @ [{dh}, {dh}]"
    else:
        q, v, edge = args[0], args[2], args[3]
        ec, hc, heads, de = q.shape[2] * q.shape[3], v.shape[2] * v.shape[3], v.shape[2], edge.shape[-1]
        plan, sizes = attn_plan(B, N, de, ec, hc, heads), (B, N, de, ec, hc, heads)
        x, w = r(B * N * N, de), r(de, ec + hc)
        products = lambda: x @ w
        shapes = f"[{B * N * N}, {de}] @ [{de}, {ec + hc}]"
    blocks = ctypes.c_int(0)
    _lib.check_rc(f"{name} occupancy", getattr(_lib.build(), f"dstt_{name}_occupancy")(
        *sizes, ctypes.byref(blocks)))
    cublas_ms = cuda_time_ms(products, iters=200)
    cublas_device_ms = device_ms(products)
    say(f"[kernels] {name} B={B} N={N}: plan {plan.grid} blocks of {plan.threads} threads, "
        f"tiles of {plan.tile_rows} pair rows holding {plan.rows_per_tile} rows of a molecule, "
        f"{plan.smem} bytes of shared memory, "
        f"{plan.blocks_per_sm} blocks an SM planned, {blocks.value} on the card; cuBLAS "
        f"yardstick {shapes}: {cublas_ms:.4f} ms, {ms_or_none(cublas_device_ms)} on the device")
    assert blocks.value == plan.blocks_per_sm, (name, blocks.value, plan)
    return dict(blocks=plan.grid, tile_rows=plan.tile_rows, smem=plan.smem, blocks_per_sm=blocks.value,
                cublas_ms=cublas_ms, cublas_device_ms=cublas_device_ms)


def stage_ms(call, stages, flush=None, iters: int = 20, tries: int = 3):
    """Device time a call of each of a kernel's launches (profiler), with
    ``flush`` written before each call when given; None after ``tries``
    windows in which some kernel events did not arrive."""
    return profile_stages(call, stages, flush, iters, tries)[0]


def profile_stages(call, stages, flush=None, iters: int = 20, tries: int = 3):
    """``stage_ms``'s times, and the profile of the window they came from
    (of the last window when they are None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.fill_(1.0)
                call()
            torch.cuda.synchronize()
        times, counts = {}, {}
        for e in prof.key_averages():
            for stage in stages:
                if e.device_type.name == "CUDA" and stage in e.key:
                    times[stage] = times.get(stage, 0.0) + e.device_time_total / iters / 1e3
                    counts[stage] = counts.get(stage, 0) + e.count
        if all(counts.get(stage, 0) >= iters for stage in stages):
            return {stage: times[stage] for stage in stages}, prof
    return None, prof


def launch_shape(prof, kernel):
    """Full name, grid, block, shared bytes and registers a thread of the
    launches of the kernel whose name holds ``kernel`` in a profile, as
    CUPTI recorded them in the profiler's trace (written to the build
    directory and read back); None where the trace carries no launch shape.
    Fails if two launches differ."""
    from diffspectra_tpu_torch.ops import _lib

    _lib.BUILD_DIR.mkdir(exist_ok=True)
    path = _lib.BUILD_DIR / f"trace.{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    shapes = set()
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "kernel" and kernel in e.get("name", "") and "grid" in args:
            shapes.add((e["name"], tuple(args["grid"]), tuple(args["block"]),
                        args.get("shared memory"), args.get("registers per thread")))
    if not shapes:
        say(f"[probes] {kernel}: no launch shape in the profiler's trace")
        return None
    assert len(shapes) == 1, (kernel, shapes)
    name, grid, block, smem, registers = shapes.pop()
    return dict(name=name, grid=grid, block=block, smem=smem, registers=registers)


def device_ms(fn, iters: int = 20, tries: int = 3):
    """Device time of the CUDA kernels ``fn`` launches, a call, from the
    profiler's kernel events: what the card spends, without the host's
    launch overhead that back-to-back calls of a small kernel measure. A window
    whose kernel events did not all arrive (seen once on the card) is taken
    again; None (not measured) after ``tries`` such windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if kernels and min(e.count for e in kernels) >= iters:
            return sum(e.device_time_total for e in kernels) / iters / 1e3
    return None


def ms_or_none(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def probe_library(dev):
    """One PyTorch call a probe that computes the same function, timed
    beside the kernel as a yardstick and used nowhere in the port."""
    one, two = torch.ones((), device=dev), torch.full((), 2.0, device=dev)
    times2, plus1 = (lambda x: x * 2.0), (lambda x: x + 1.0)
    return {
        "t1": times2, "t2": times2, "t11": times2, "t3": plus1, "t4": plus1,
        "t5": lambda x, w: x @ w, "t6": torch.tanh,
        "t8": lambda x: torch.softmax(x, -1),
        "t9": lambda x, m: torch.where(m > 0, x, -1e10),  # with the comparison
        "t10": lambda x: x.view(29, 29, 14, 18).sum(-1),
        "t12": lambda x: torch.addcmul(one, x, two),  # 1 + 2x in one call
        "t13": lambda q, k: q @ k.T, "t14": lambda q, k: q @ k.T,
        "t7": lambda x, w: torch.mm(x, w, out_dtype=torch.float32),  # bf16 in, f32 out
    }


def phase_probes(dev):
    """This slice's path, the probe tool, with every count at 0 just before
    it: ``run_probes`` on cuda (its kernel against the plain version on the
    CPU), each probe kernel launched once, the serving kernels never, and no
    plain version called with cuda tensors. Then each probe kernel against
    its plain version on cuda on other inputs, and their times."""
    from diffspectra_tpu_torch.ops import LAUNCHES, probes, reset_launches
    from diffspectra_tpu_torch.tools.diag_probes import probe_inputs, run_probes

    assert PROBE_ATOL == {name: p.atol for name, p in probes.PROBES.items()}
    assert PROBE_KERNELS.keys() == probes.PROBES.keys()
    plain_on_cuda, originals = [], {}

    def spy(name, plain):
        def counted(*args):
            if any(a.is_cuda for a in args):
                plain_on_cuda.append(name)
            return plain(*args)
        return counted

    for name in probes.PROBES:  # the wrappers call their plain version by this name
        originals[name] = getattr(probes, f"{name}_reference")
        setattr(probes, f"{name}_reference", spy(name, originals[name]))
    try:
        reset_launches()
        t0 = time.perf_counter()
        passed = run_probes(dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        for name, plain in originals.items():
            setattr(probes, f"{name}_reference", plain)
    say(f"[probes] run_probes on cuda: {sum(passed.values())} of {len(passed)} passed in "
        f"{wall:.3f} s; launches {nonzero(launches)}; plain versions on cuda {plain_on_cuda}")
    assert all(passed.values()), passed
    assert not plain_on_cuda, plain_on_cuda
    launched_only([f"probe_{name}" for name in probes.PROBES], launches, 1)

    library = probe_library(dev)
    rows = []
    for name, p in probes.PROBES.items():
        args = [a.to(dev) for a in probe_inputs(name, seed=1)]
        got, want = p.wrapper(*args), p.reference(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        say(f"[probes] {name}: {tuple(got.shape)} max |kernel - plain| = {err:.3e} "
            f"(tolerance {PROBE_ATOL[name]:.0e}, max |plain| = {want.abs().max().item():.3e})")
        assert got.shape == want.shape and torch.isfinite(got).all() and err <= PROBE_ATOL[name], name
        ms = cuda_time_ms(lambda: p.wrapper(*args), iters=200)
        kernel_device_ms = device_ms(lambda: p.wrapper(*args))
        plain_ms = cuda_time_ms(lambda: p.reference(*args), iters=200)
        call = library[name]
        lib_err = (call(*args).float() - want).abs().max().item()
        library_ms = cuda_time_ms(lambda: call(*args), iters=200)
        library_device_ms = device_ms(lambda: call(*args))
        lib_note = (f"{library_ms:.4f} ms library call, {ms_or_none(library_device_ms)} of it on "
                    f"the device (|library - plain| {lib_err:.1e})")
        nbytes = sum(a.numel() * a.element_size() for a in args) + got.numel() * got.element_size()
        assert nbytes == p.nbytes, (name, nbytes, p.nbytes)
        tensor_cores = p.dtype == torch.bfloat16  # t7's kernel runs mma.sync on bf16
        peak = BF16_PEAK if tensor_cores else F32_PEAK
        t_ops, t_bytes = p.flops / peak * 1e3, nbytes / HBM_RATE * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        say(f"[probes] {name}: {ms:.4f} ms kernel, {ms_or_none(kernel_device_ms)} of it on the device; "
            f"{plain_ms:.4f} ms plain version; {lib_note}; "
            f"bound {bound_ms:.6f} ms by {bound_by} ({p.flops / 1e6:.3f} MFLOP "
            f"{'bf16 tensor cores' if tensor_cores else 'f32'}, {nbytes / 1e6:.4f} MB)")
        row = dict(name=f"probe_{name}", route="cuda",
                   source=f"diffspectra_tpu_torch/csrc/{PROBE_KERNELS[name][0]}", replaces=p.replaces,
                   launches=launches[f"probe_{name}"], max_abs_err=err, max_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, device_ms=kernel_device_ms,
                   library_device_ms=library_device_ms)
        row.update(probe_extras(name, p, lambda: p.wrapper(*args), row, dev))
        rows.append(row)
    return rows


def probe_extras(name, p, call, row, dev):
    """A probe kernel: its device time with L2 cold (FLUSH_BYTES written
    before each call; profiler) and its name and launch shape in that
    window, from the profiler's trace (t5's must be its launch plan; a
    templated kernel's must name the probe's operation; every block of each
    must fit on the card's SMs at once, as far as threads go), its warm
    device time over the library call's, the bound's share of it, and the
    rate it reaches warm in what bounds it (``row["bound_by"]``): bytes, or
    operations."""
    kernel = PROBE_KERNELS[name][1]
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    cold, prof = profile_stages(call, (kernel,), flush)
    cold_ms = None if cold is None else sum(cold.values())
    shape = launch_shape(prof, kernel)
    if shape is None:
        kernel_name = blocks = threads = smem = registers = None
        launch = "launch shape not measured"
    else:
        blocks, threads = math.prod(shape["grid"]), math.prod(shape["block"])
        kernel_name, smem, registers = shape["name"], shape["smem"], shape["registers"]
        launch = (f"{kernel_name}: grid {shape['grid']} ({blocks} blocks) of {shape['block']} "
                  f"threads, {smem} bytes of shared memory, {registers} registers a thread")
        props = torch.cuda.get_device_properties(dev)
        assert blocks <= props.multi_processor_count * (
            props.max_threads_per_multi_processor // threads), (name, shape)
        assert PROBE_OPS.get(name, "") in kernel_name, (name, kernel_name)
    if p.plan is not None:  # t5
        plan = p.plan(*p.sizes(p.out_shape, *p.inputs.values()))
        launch += f" (plan: {plan.grid} tiles of {plan.rows} x {plan.cols})"
        assert shape is None or (blocks, threads, smem) == (plan.grid, plan.threads, plan.smem), (
            shape, plan)
    warm, library = row["device_ms"], row["library_device_ms"]
    ratio = None if warm is None or library is None else warm / library
    share = None if warm is None else row["bound_ms"] / warm
    work, unit = (p.flops, "TFLOP/s") if row["bound_by"] == "operations" else (p.nbytes, "TB/s")
    rate = None if warm is None else work / (warm * 1e-3) / 1e12
    say(f"[probes] {name}: {launch} (profiler); device time {ms_or_none(warm)} warm, "
        f"{ms_or_none(cold_ms)} with L2 cold; library call {ms_or_none(library)} on the device; "
        f"kernel / library {'not measured' if ratio is None else f'{ratio:.3f}'}; bound / kernel "
        f"{'not measured' if share is None else f'{share:.3f}'}; "
        f"{'not measured' if rate is None else f'{rate:.3f}'} {unit}")
    return dict(kernel=kernel_name, blocks=blocks, threads=threads, smem=smem, registers=registers,
                cold_device_ms=cold_ms, device_over_library=ratio, bound_share=share, rate=rate,
                rate_unit=unit)


def forward_inputs(dev, has_cond: bool):
    """One reverse step's inputs in the warm model's operating range: noisy
    positions and features, conditioning inside its clamp range, spectra of
    synthetic molecules, noise levels across the schedule."""
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.utils import masks as M

    rng = np.random.default_rng(1)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    node_mask, edge_mask = M.build_masks(torch.tensor(N_NODES), N)
    xh = T(rng.normal(size=(B, N, 9))) * node_mask
    e = T(rng.normal(size=(B, N, N, 2)))
    edge_x = (e + e.transpose(1, 2)) * edge_mask[..., None]
    cond_x = cond_e = None
    if has_cond:
        cond_x = torch.cat([T(rng.normal(size=(B, N, 3)) * 1.5),
                            T(rng.uniform(-0.25, 0.25, size=(B, N, 6)))], -1) * node_mask
        c = T(rng.uniform(-1, 1, size=(B, N, N, 2)))
        cond_e = 0.5 * (c + c.transpose(1, 2)) * edge_mask[..., None]
    data = generate(seed=3, size=B, max_n=N, fidelity=4)
    specs = [T(np.log10(data[k] + 1.0)) for k in ("uv", "ir", "raman")]
    t = torch.full((B,), 0.5)
    nl = torch.linspace(-9, 9, B)
    move = lambda x: None if x is None else x.to(dev)
    return [move(x) for x in (t, xh, node_mask, edge_mask, edge_x, nl, cond_x, cond_e)], \
        [s.to(dev) for s in specs]


def compare(tag, got, want):
    """Assert each output within FORWARD_RTOL x max|want|."""
    for name, g, w in zip(("pred", "edge_pred"), got, want):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        say(f"[forward] {tag} {name}: max |diff| = {err:.3e}, max |value| = {scale:.3e}, "
            f"tolerance {FORWARD_RTOL:.0e} x max")
        assert torch.isfinite(g).all() and err <= FORWARD_RTOL * scale, (tag, name)


def phase_forward(dev):
    """Both paths' full-width forwards on cuda against the CPU, and the two
    cuda paths against each other. Returns the cuda models by path."""
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import load_dmt

    gpu_models, cuda_outs = {}, {}
    for path, ops in PATHS.items():
        config = configs.apply_overrides(configs.get_config(), {"model.pallas_ops": ops})
        cpu_model = load_dmt(WARM, config, "cpu")
        gpu_models[path] = gpu_model = copy.deepcopy(cpu_model).to(dev)
        assert all(b.e_block.block_kernel == (path == "block") for b in gpu_model.blocks)
        for has_cond in (True, False):
            outs = []
            for model, device in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
                args, specs = forward_inputs(device, has_cond)
                with torch.no_grad():
                    ctx = model.encode_context(specs)
                    outs.append([o.cpu() for o in model(*args, has_cond, ctx)])
            compare(f"{path} has_cond={has_cond} cuda vs cpu", *outs)
            cuda_outs[path, has_cond] = outs[0]
    for has_cond in (True, False):
        compare(f"has_cond={has_cond} cuda block vs cuda attn_equi",
                cuda_outs["block", has_cond], cuda_outs["attn_equi", has_cond])
    return gpu_models


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def launched_only(path_kernels, launches, expected):
    """The kernels of the path launched ``expected`` times, the others never."""
    want = {k: (expected if k in path_kernels else 0) for k in launches}
    assert launches == want, (launches, want)


def serve_path(path, dev, data):
    """Serve the REQUESTS through one path; the counts are this path's."""
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.info import get_dataset_info
    from diffspectra_tpu_torch.evaluation.molgraph import MolGraph
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    el = Elucidator.from_warm_state(
        WARM, overrides={"sampling.steps": STEPS, "model.pallas_ops": PATHS[path]}, device=dev)
    say(f"[serve {path}] loaded {WARM} in {time.perf_counter() - t0:.2f} s; "
        f"pallas_ops={el.config.model.pallas_ops}, steps={el.config.sampling.steps}, "
        f"candidates={CANDIDATES}, requests={REQUESTS}")
    decoder = get_dataset_info("qm9_second_half")["atom_decoder"]
    reset_launches()  # counts from here on are this path's
    per_request = []
    for m in range(REQUESTS):
        n = int(data["num_atom"][m])
        spectra = {k: data[k][m] for k in ("uv", "ir", "raman")}
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = el.elucidate(spectra, n_atoms=n, num_candidates=CANDIDATES, seed=m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        target = MolGraph([decoder[int(a)] for a in data["atom_type"][m, :n]],
                          np.zeros(n, np.int64), data["edge_type"][m, :n, :n])
        finite = all(np.isfinite(c.positions).all() for c in result.candidates)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        hit = result.best.molgraph.wl_hash() == target.wl_hash()
        say(f"[serve {path}] request {m}: n_atoms={n} wall={wall:.3f} s "
            f"({CANDIDATES / wall:.3f} sampled mols/s), {len(result.candidates)} distinct "
            f"candidates, best frequency {result.best.frequency:.2f}, finite={finite}, "
            f"top-1 WL hash equals target={hit}, launches={nonzero(launched)}")
        assert finite and sum(c.count for c in result.candidates) == CANDIDATES
        assert all(c.molgraph.n_atoms == n for c in result.candidates)
        per_request.append(dict(n_atoms=n, wall_s=wall, mols_per_s=CANDIDATES / wall,
                                distinct=len(result.candidates), top1_hit=hit))
    launches = dict(LAUNCHES)
    expected = el.config.model.n_layers * STEPS * REQUESTS
    say(f"[serve {path}] launches {nonzero(launches)}, expected {expected} for {PATH_KERNELS[path]}, "
        "0 for the others")
    launched_only(PATH_KERNELS[path], launches, expected)
    total = sum(r["wall_s"] for r in per_request)
    say(f"[serve {path}] " + json.dumps({"requests": per_request,
                                         "mols_per_s": REQUESTS * CANDIDATES / total}))
    return el, launches


def serve_more(el, dev, data, queries):
    """The rest of serving on the block path, at SHORT_STEPS (DPM_STEPS for
    DPM-Solver) steps: the count head and DPM-Solver on the requests of
    ``data``, elucidate_batch on the 8 ``queries``."""
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    def elucidator(**overrides):
        config = configs.apply_overrides(copy.deepcopy(el.config), overrides)
        return Elucidator(config, el.model, dev)

    n_layers = el.config.model.n_layers
    as_spectra = lambda d: [{k: d[k][m] for k in ("uv", "ir", "raman")} for m in range(len(d["ir"]))]
    spectra = as_spectra(data)

    # the count head: one request without its atom count
    short = elucidator(**{"sampling.steps": SHORT_STEPS})
    meta = short.load_count_head(HEAD)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = short.elucidate(spectra[0], n_atoms=None, num_candidates=CANDIDATES, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, probs = short._predict_counts(short._prepare_context(spectra[0], False))
    K = max(2, CANDIDATES // len(counts))
    say(f"[count head] {HEAD} (held-out top-1 {meta.get('test_top1')}); steps={SHORT_STEPS} "
        f"(cut from {STEPS}); true n_atoms={int(data['num_atom'][0])}, predicted counts "
        f"{counts} with probabilities {[round(probs[c], 4) for c in counts]}, {K} draws each; "
        f"wall={wall:.3f} s; {len(result.candidates)} distinct candidates, best n_atoms "
        f"{result.best.molgraph.n_atoms} at frequency {result.best.frequency:.2f}; "
        f"launches {nonzero(LAUNCHES)}")
    assert result.n_atoms is None and result.num_draws == K * len(counts)
    assert sum(c.count for c in result.candidates) == K * len(counts)
    assert all(c.molgraph.n_atoms in counts for c in result.candidates)
    assert all(np.isfinite(c.positions).all() for c in result.candidates)
    launched_only(("block_fused",), dict(LAUNCHES), n_layers * SHORT_STEPS * len(counts))

    # the marginal without a head: every plausible count of the train
    # histogram, MARGINAL_DRAWS draws each, each count's round counted alone
    marginal = elucidator(**{"sampling.steps": MARGINAL_STEPS})
    plain_round, per_count = marginal._round, {}

    def counted_round(contexts, n_atoms, n_pad, generator):
        before = LAUNCHES["block_fused"]
        mols = plain_round(contexts, n_atoms, n_pad, generator)
        per_count[n_atoms[0]] = LAUNCHES["block_fused"] - before
        return mols

    marginal._round = counted_round
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = marginal.elucidate(spectra[0], n_atoms=None, num_candidates=CANDIDATES, seed=0,
                                draws_per_n=MARGINAL_DRAWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ns = marginal._plausible_n()
    say(f"[marginal] no head: counts tried {sorted(per_count)} (plausible {ns}), "
        f"{MARGINAL_DRAWS} draws each, steps={MARGINAL_STEPS} (cut from {STEPS}); "
        f"wall={wall:.3f} s; {len(result.candidates)} distinct candidates, best n_atoms "
        f"{result.best.molgraph.n_atoms}; launches per count {per_count}")
    assert len(per_count) > 1 and sorted(per_count) == ns
    assert all(v == n_layers * MARGINAL_STEPS for v in per_count.values()), per_count
    assert result.n_atoms is None and result.num_draws == MARGINAL_DRAWS * len(ns)
    assert sum(c.count for c in result.candidates) == MARGINAL_DRAWS * len(ns)
    assert all(c.molgraph.n_atoms in ns and np.isfinite(c.positions).all()
               for c in result.candidates)
    launched_only(("block_fused",), dict(LAUNCHES), n_layers * MARGINAL_STEPS * len(ns))

    # elucidate_batch: 8 queries, 2 without their atom count
    given = [int(n) for n in queries["num_atom"]]
    given[2] = given[5] = None
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = short.elucidate_batch(as_spectra(queries), given, num_candidates=CANDIDATES,
                                    seed=1, queries_per_round=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pads = {short._bucket(r.n_atoms) for r in results}
    say(f"[batch] 8 queries, given counts {given}, served at {[r.n_atoms for r in results]}; "
        f"{len(pads)} rounds of {8 * CANDIDATES} draws (buckets {sorted(pads)}), "
        f"steps={SHORT_STEPS} (cut from {STEPS}); wall={wall:.3f} s "
        f"({8 * CANDIDATES / wall:.3f} sampled mols/s of the 8 queries); launches {nonzero(LAUNCHES)}")
    assert len(results) == 8
    for r, g in zip(results, given):
        assert g is None or r.n_atoms == g
        assert r.num_draws == CANDIDATES and sum(c.count for c in r.candidates) == CANDIDATES
        assert all(c.molgraph.n_atoms == r.n_atoms and np.isfinite(c.positions).all()
                   for c in r.candidates)
    launched_only(("block_fused",), dict(LAUNCHES), n_layers * SHORT_STEPS * len(pads))

    # DPM-Solver++, ODE and SDE
    for method in ("dpm_solver", "dpm_solver_sde"):
        dpm = elucidator(**{"sampling.steps": DPM_STEPS, "sampling.method": method})
        n = int(data["num_atom"][1])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = dpm.elucidate(spectra[1], n_atoms=n, num_candidates=CANDIDATES, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        say(f"[{method}] steps={DPM_STEPS}, n_atoms={n}: wall={wall:.3f} s, "
            f"{len(result.candidates)} distinct candidates, best frequency "
            f"{result.best.frequency:.2f}; launches {nonzero(LAUNCHES)}")
        assert sum(c.count for c in result.candidates) == CANDIDATES
        assert all(np.isfinite(c.positions).all() and c.molgraph.n_atoms == n
                   for c in result.candidates)
        launched_only(("block_fused",), dict(LAUNCHES), n_layers * DPM_STEPS)


def phase_profile(path, model, dev):
    """Kernel time by name over 5 forwards at the serving shape, and the
    device's busy share of the window (from the profiler's kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    args, specs = forward_inputs(dev, True)
    with torch.no_grad():
        ctx = model.encode_context(specs)
        fwd = lambda: model(*args, True, ctx)
        say(f"[profile {path}] one DMT forward (B={B}, N={N}, has_cond): "
            f"{cuda_time_ms(fwd, iters=20):.3f} ms by CUDA events")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fwd()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy_us = sum(e.device_time_total for e in rows if e.device_type.name == "CUDA")
    rows.sort(key=lambda e: -e.device_time_total)
    say(f"[profile {path}] window {window_us:.0f} us, kernel time {busy_us:.0f} us "
        f"(busy share {busy_us / window_us:.3f})")
    for e in rows[:14]:  # block_fused's five launches among them
        say(f"[profile {path}]   {e.device_time_total / 5:10.1f} us/forward  "
            f"x{e.count // 5:<4d} {e.key[:90]}")


def sweep_figures(fig):
    """The sweep's figures by the names of ROUND5 and NOT_COMPARABLE."""
    m3, m2 = fig["metric_3d"], fig["metric_2d"]
    out = {"Metric-3D atom stability": m3["atom_stable"], "Metric-3D mol stability": m3["mol_stable"],
           "Metric-3D validity": m3["Validity"], "Metric-3D complete": m3["Complete"],
           "Metric-2D atom stability": m2["atom_stable"], "Metric-2D mol stability": m2["mol_stable"],
           "Metric-2D validity": m2["Validity"], "Metric-2D complete": m2["Complete"],
           "Metric-2D unique & valid": m2["Unique"], "Metric-2D novelty": m2["Novelty"],
           "Top-1 2D": fig["top1_2d"], "Top-1 3D": fig["top1_3d"],
           "Top-10 2D": fig["topk_2d"], "Top-10 3D": fig["topk_3d"],
           "Consensus 2D": fig["consensus_2d"], "Consensus 3D": fig["consensus_3d"],
           "memorization bound": fig["generalization"]["seen"] / fig["generalization"]["targets"]}
    for dim in ("2D", "3D"):
        for name, value in fig[f"similarity_{dim.lower()}"].items():
            out[f"{dim} {name}"] = value
    return out


def phase_sweep(dev):
    """Phase 7: the eval sweep on the block path; its gates raise."""
    import logging

    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="[sweep log] %(message)s",
                        force=True)
    config = configs.apply_overrides(configs.get_config(), dict(SWEEP))
    say(f"[sweep] settings {json.dumps(SWEEP)}")
    eval_dir = tempfile.mkdtemp(prefix="eval_sweep_")  # the similarity tables
    reset_launches()  # counts from here on are the sweep's
    t0 = time.perf_counter()
    fig = run_lib.evaluate(config, WARM, eval_dir, dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    K, steps, targets = SWEEP["eval.num_candidates"], SWEEP["sampling.steps"], fig["targets"]
    rounds = fig["rounds"]
    draws = SWEEP["eval.batch_size"] * len(rounds)
    say(f"[sweep] rounds (draws, n_pad): {rounds}; phase wall {wall:.1f} s")
    for k, sw in enumerate(fig["sweeps"]):
        sampling_s, decode_s = (sum(r) for r in zip(*sw["round_seconds"]))
        say(f"[sweep] sweep {k + 1}/{K}: wall {sw['seconds']:.3f} s, {sw['decoded']} of {targets} "
            f"targets decoded, {draws / sw['seconds']:.3f} sampled mols/s; sampling "
            f"{sampling_s:.3f} s and host decode {decode_s:.4f} s over {len(rounds)} rounds "
            f"({decode_s / len(rounds):.4f} s a round)")
    sweep_s = sum(sw["seconds"] for sw in fig["sweeps"])
    ph = fig["phase_seconds"]
    say(f"[sweep] sampling {sweep_s:.1f} s over {K} sweeps ({K * draws / sweep_s:.3f} sampled "
        f"mols/s); host scoring: metrics-3d {ph['metrics-3d']:.2f} s, metrics-2d "
        f"{ph['metrics-2d']:.2f} s, the extra sweeps' scoring "
        f"{ph[f'topk-extra-sweeps(x{K - 1})'] - sum(s['seconds'] for s in fig['sweeps'][1:]):.2f} s, "
        f"similarity {ph['similarity']:.2f} s; phase-time {json.dumps(ph)}")
    expected = config.model.n_layers * steps * len(rounds) * K
    say(f"[sweep] launches {nonzero(launches)}, expected {expected} for block_fused "
        f"(8 blocks x {steps} steps x {len(rounds)} rounds x {K} sweeps), 0 for the others")
    launched_only(("block_fused",), launches, expected)
    assert all(sw["decoded"] == targets for sw in fig["sweeps"]) and len(fig["sweeps"]) == K

    figures = sweep_figures(fig)
    counts = {"targets": targets}
    for dim in ("2d", "3d"):  # the valid pairs: one detailed score each
        name = f"similarity_metrics_{dim}_ckpt_warm_qm9s_as_detailed_scores.json"
        with open(os.path.join(eval_dir, name)) as f:
            counts[f"valid_{dim}"] = len(json.load(f)["Top-1 Accuracy"])
    shutil.rmtree(eval_dir)
    say(f"[sweep] figures, the port (f32) on {targets} targets (valid pairs: 2D "
        f"{counts['valid_2d']}, 3D {counts['valid_3d']}) against round 5 (the JAX package, bf16, "
        "10k targets); SE = binomial standard error of round 5's proportion at this run's count:")
    for name, (r5, over) in ROUND5.items():
        se = "" if over is None else \
            f", SE {math.sqrt(r5 * (1 - r5) / counts[over]):.4f} at n={counts[over]}"
        say(f"[sweep]   {name}: {figures[name]:.4f} (round 5 {r5:.4f}{se})")
    for name, (r5, why) in NOT_COMPARABLE.items():
        say(f"[sweep]   {name}: {figures[name]:.4f} (round 5 {r5:.4f}; not comparable: {why})")
    for name, value in figures.items():
        if "MACCS" in name or "Fraggle" in name:
            assert math.isnan(value), (name, value)  # RDKit-only
        elif "MCES" in name:
            assert math.isfinite(value) and value >= 0, (name, value)
        else:
            assert math.isfinite(value) and 0 <= value <= 1, (name, value)
    assert figures["Top-10 2D"] >= TOP10_2D_FLOOR, figures["Top-10 2D"]
    say(f"[sweep] gates held: launches, {targets} of {targets} decoded in each of {K} sweeps, "
        f"figures in range, Top-10 2D {figures['Top-10 2D']:.4f} >= {TOP10_2D_FLOOR}")
    print(json.dumps({"sweep": {"figures": figures, "rounds": rounds, "wall_s": wall,
                                "sweep_s": [sw["seconds"] for sw in fig["sweeps"]],
                                "round_s": [sw["round_seconds"] for sw in fig["sweeps"]],
                                "phase_s": ph}}), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from diffspectra_tpu_torch.ops import _lib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    _lib.build()
    say(f"[build] nvcc built {_lib.LIB_NAME} in {time.perf_counter() - t0:.2f} s")
    kernel = "?"
    for line in _lib.build_log.splitlines():  # ptxas -v: registers and spills by kernel
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            say(f"[build] {kernel}: {line.strip()}")

    rows = phase_kernels(dev)
    probe_rows = phase_probes(dev)
    models = phase_forward(dev)
    from diffspectra_tpu_torch.data.synthetic import generate

    data = generate(seed=7, size=REQUESTS, max_n=29, fidelity=4)
    launches, serving = {}, {}
    for path in PATHS:
        el, counts = serve_path(path, dev, data)
        launches.update({k: counts[k] for k in PATH_KERNELS[path]})
        serving.update({k: serving.get(k, 0) + counts[k] for k in counts})
    serve_more(el, dev, data, generate(seed=9, size=8, max_n=29, fidelity=4))
    for path, model in models.items():
        phase_profile(path, model, dev)
    sweep = phase_sweep(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["sweep_launches"] = sweep[row["name"]]
    for row in probe_rows:  # launches: the probe tool's run; none on the serving paths
        row["serving_launches"] = serving[row["name"]] + sweep[row["name"]]
        assert row["serving_launches"] == 0, row
    say(f"[probes] launches in the probe tool's run "
        f"{ {r['name']: r['launches'] for r in probe_rows} }, on the serving paths 0 each")
    print(json.dumps({"kernels": rows + probe_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
