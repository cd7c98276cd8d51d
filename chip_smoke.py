"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, serve,
sweep, train, pretrain, score, train and sweep over two ranks, elucidate
without the atom count, and run the repository's tools through the command
line.

    python3 chip_smoke.py

The port serves in the JAX package's production dtype, bf16
(``training.matmul_precision``, the default), or in f32 on the override;
the phases drive both.

Phases, each printing its own lines:
  1. the card (name, power limit); TF32 off for matmuls and convolutions,
     and bf16 matmuls' reduced-precision sums off;
  2. build the CUDA kernels from ``diffspectra_tpu_torch/csrc`` with nvcc,
     one process a source at once (registers and spills of each kernel
     from ``-Xptxas=-v``);
  3. each kernel (mix_attention, equi_update, block_fused, and equi_update
     on the 1-wide dist of ``dist_gbf=False``, its ``_dd1`` rows), on f32
     operands and (its ``_bf16`` row) on the bf16 operands the JAX DMT in
     bf16 passes it, against its plain PyTorch version at the serving shape (B=10
     draws, N=29, flagship widths) on a seeded ragged batch, with the
     kernel's, the plain version's and the bound's times (the bf16 gate
     products at the tensor cores' 989 TFLOP/s, the rest at 67), and each
     instance's registers from ``ptxas``; each also at B=10, N=17, 21, 25, 29,
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
     ``pallas_ops=('attn','equi')`` and ``('block',)``: in f32 within 1e-3
     of the largest value, and the two cuda paths against each other; in
     bf16 within BF16_FORWARD_RATIO of the CPU's own bf16-against-f32
     difference (the ratio printed), while the same cuda forward with
     each kernel's gate product short of its last k step of 16 (the
     ``drop_k`` control of ``tools/bf16_noise.py``) must read above it;
  5. serve: ``Elucidator.from_warm_state(...).elucidate(...)`` for the first
     of 3 synthetic requests (fidelity-4 spectra) at its true atom count, 10
     candidates, ancestral steps (1000 in bf16, the default; 200 in f32,
     the override, 1000 before phase 15 came), on each path in each dtype;
     each path's kernels in that dtype
     must be launched 8 blocks x steps x requests times, every other
     kernel 0. Then on the
     bf16 block path (100 steps, cut from 1000 to keep the run short): one
     request without its atom count through the count head
     (``artifacts/atom_count_head.npz``), one without it and without the
     head (every plausible count of the train histogram, 2 draws each at 20
     steps, each count's launches counted), ``elucidate_batch`` over 8 queries
     (2 without their count), and one request each with DPM-Solver++ (ODE
     and SDE, 50 steps);
  6. a profile of DMT forwards of both paths in both dtypes at the serving
     shape (kernel time by name and the device's busy share);
  7. the evaluation sweep (``run_lib.evaluate``, graph mode) from
     ``artifacts/warm_qm9s_as.npz`` on the block path, in bf16 and then in
     f32, each: 128 test targets of
     ``generate(seed=42, size=1280, fidelity=4)``'s split in rounds of 128
     (buckets 17, 21, 25, 29), K sweeps of ancestral steps at temperature
     1.0 (K=10 at 500 steps in bf16, K=1 at 1000 in f32: SWEEP_K,
     SWEEP_STEPS); its rounds, each sweep's wall time and mols/s, its
     rounds' seconds of sampling and of host decoding, the host scoring's
     phase times, and every figure beside round 5's (the JAX package in
     bf16 on 10k targets) with the binomial standard error at this run's
     count; then both sweeps' figures side by side with round 5's. Gates,
     each sweep: block_fused in its dtype launched 8 x steps x rounds x K
     times and no other kernel, every target decoded in every sweep, every
     figure finite and in [0, 1] (MCES >= 0), and Top-10 2D >= 0.85 (about
     7 standard errors under round 5's 0.9664; at K=1, Top-1 2D >= 0.60,
     about 4 under round 5's 0.7490).
  8. training on the card, the flagship at full width (bf16, dropout 0.1,
     batch 128, buckets 17, 21, 25, 29) on the sweep's synthetic set,
     warm-started from ``artifacts/warm_qm9s_as.npz``: (a) one f32 step at
     dropout 0 on cuda and on the CPU from the same state and draws, the
     loss within 1e-4 relative and each parameter's gradient within 1e-3
     of its max |grad|; (b) ``run_lib.train`` for 20 steps, every loss
     finite, params and EMA moved; (c) its snapshot, 128 draws at 200
     steps (1000 before phase 14 came, 400 before phase 15) from the EMA weights, launching each bf16 per-op kernel 8 x
     steps x rounds times and the steps none (and no port kernel among a
     profiled step's kernel names), its stability figures finite in
     [0, 1], the xyz files of its samples and targets written; timed steps (the median over the last 12 of 20, graphs/s, peak
     memory) with ``remat_policy='full'``, then 10 with ``'none'``, and the
     busy share over two profiled steps; (d) a checkpoint written and
     restored (every tensor equal), and a warm-state export serving one
     request through ``Elucidator.from_warm_state`` at 100 steps.
  9. the DMT's other configurations at full width (nf=256, 8 blocks), random
     weights from seed 0: (a) forwards (B=10, N=29, self-conditioned) of
     ``dist_gbf=False`` + ``GaussianLayer`` and ``cond_time=False`` on
     ``('attn','equi')``, ``GaussianLayer`` and ``cond_time=False`` on
     ``('block',)``, each in f32 and bf16 on cuda against the CPU (phase 4's
     tolerances), launching 8 of each per-op kernel (equi_update's ``_dd1``
     for the 1-wide dist), 8 of block_fused, and none (the JAX block's XLA
     branch without cond_time) a forward; (b) ``dist_gbf=False`` +
     ``GaussianLayer`` under the linear schedule, bf16, dropout 0.1, batch
     128, trained from a fresh init for 10 steps through ``run_lib.train``
     (a checkpoint at the last), served through ``Elucidator.from_workdir``
     (the restored tensors equal to the trained EMA and batch statistics):
     one fidelity-4 request at K=10 with 100 ancestral steps, then with
     DPM-Solver++, each launching the bf16 per-op kernels 8 x 100 times;
     step times, peak memory and serve times beside the card's line.
 10. training as the JAX flagship config trains (bf16, dropout 0.1, batch
     128, buckets 17, 21, 25, 29): (a) the sweep's set written as the
     reference's processed QM9S file with its split file, read through
     ``load_qm9s`` (``data.synthetic=False``), 16 steps from
     ``warm_qm9s_as.npz`` through the device store with
     ``training.profile`` (the trace written; numbered checkpoints every 8
     steps), then 8 through the host iterator: finite losses, the store's
     bytes on the card equal to ``estimate_bytes``, its first batch equal
     to the host collate's (max |diff| 0), each path's median step time and
     graphs/s; (b) ``pretrain_specformer`` at the flagship's widths
     (allspectra, batch 128) for 20 steps, warmup 5 (finite losses,
     spectra/s), then a fresh DMT with the file as
     ``model.pretrained_specformer_path`` (its SpecFormer equal to the
     file's) trained 5 finite steps; (c) the allspectra flagship from
     ``warm_qm9s_ir.npz``, partial, ``cond_encoder/head_linear/kernel``
     zeroed: the logged restored, fresh and zeroed counts equal the CPU's,
     5 finite steps; (d) ``remat_policy='dots'`` for 6 steps, its median
     step and peak memory beside phase 8's ``full`` and ``none``, the peak
     between theirs; (e) ``evaluate_checkpoints`` over (a)'s first numbered
     checkpoint (two until phase 16 came), 8 targets, K=1, 100 steps: finite
     figures, the bf16 per-op kernels launched 8 x steps x rounds times; (f) the host
     packer built on the card's host, against ``pack_batch_numpy``.
 11. DMT_WO_EQ, the non-equivariant ablation, which runs on PyTorch ops and
     no port kernel, at full width (nf=256, 8 blocks, 16 heads), random
     weights from seed 0: (a) the forwards (B=10, N=29, self-conditioned)
     of ``trans_ver`` v1, v2 and optim, each in f32 and bf16 on cuda against
     the CPU (phase 4's tolerances: FORWARD_RTOL, and in bf16 the per-op
     bound of the CPU's own bf16-against-f32 difference), no port kernel
     launched and none among a profiled forward's kernels; (b) v2 in bf16,
     dropout 0.1, batch 128, trained from a fresh init for 10 steps through
     ``run_lib.train`` with a snapshot of 16 draws at 100 steps (its xyz
     files written), served from its workdir through
     ``Elucidator.from_workdir`` (one fidelity-4 request at K=10, 100
     ancestral steps, then DPM-Solver++) and swept by
     ``evaluate_checkpoints`` (8 targets, K=1, 100 steps): finite losses and
     figures, no port kernel launched, the step times, graphs/s, peak
     memory and serve seconds; (c) the flagship from ``warm_qm9s_as.npz``
     with ``model.specformer_bf16`` in bf16, one request at 100 steps on
     each path (its bf16 kernels 8 x 100 launches), the spectra embedding on
     cuda against the CPU's within SPECFORMER_BF16_RATIO of the CPU's own
     difference between SpecFormer in bf16 and in f32.
 12. CDGS on the 2-D path (``only_2D``: atoms and bonds, no positions),
     which runs on PyTorch ops and no port kernel, at the flagship's widths
     (nf=256, 8 blocks, 16 heads, ``rw_depth`` 8) with ``smoke_2d``'s
     overrides, random weights from seed 0: (a) the forwards (B=10, N=29)
     in f32 and bf16 on cuda against the CPU (phase 11's tolerances), each
     timed, no port kernel launched and none among a profiled forward's
     kernels; (b) bf16, dropout 0.1, batch 128, trained from a fresh init
     for 10 steps through ``run_lib.train`` with a snapshot of 16 draws at
     100 steps (2-D figures only, its targets' xyz files and none of its
     samples): finite losses, params and EMA moved, the step times,
     graphs/s and peak memory; (c) served from its workdir through
     ``Elucidator.from_workdir`` (one fidelity-4 request at K=10, 100
     ancestral steps, then DPM-Solver++): every candidate without positions
     and with a decoded graph; (d) swept by ``evaluate_checkpoints`` (8
     targets, K=1, 100 steps, ``eval.sub_geometry`` off: 2-D molecules
     have no positions): the 2-D figures alone, finite, in [0, 1]; no port
     kernel launched in any of it.
 13. the rest of the eval stack: (a) ``run_lib.evaluate`` from
     ``warm_qm9s_as.npz`` on the block path in bf16, 8 targets of phase 7's
     set, K=2 at 100 steps, with the sub-geometry MMDs (``data.root`` a
     temporary directory: the statistics computed from the test split and
     written there), ``eval.save_mols`` and the original-QM9 reference
     sets (``configs.original_qm9_config``): ``block_fused_bf16`` launched
     8 x steps x rounds x K times and no other kernel, the reference-set
     line naming original-QM9, FCD NaN, ``FCD_proxy`` finite and >= 0, SNN,
     IntDiv and Filters in [0, 1], Frag and Scaf in [0, 1] or NaN exactly
     where both count vectors are empty, weight > 0, each MMD mean finite
     and >= 0, the statistics file written, the ``base_metrics`` CLI on the
     saved pickles writing the sweep's own 2D and 3D tables, and the
     Hungarian RMSD of the 3D samples against their targets finite; (b) the
     MMD's kernel sums on cuda against the float64 plain version at 2,000
     a side (identical, shifted, and of another width: each of xx/n^2,
     yy/m^2, xy/nm within 1e-5 relative, the MMD within 1e-5 x (xx/n^2 +
     yy/m^2)), then timed at the 10,000-a-side cap with its peak memory;
     (c) ChemNet (``random_chemnet``) on cuda against the CPU on 64
     SMILES, within 1e-5 of the largest activation.
 14. the mesh, data parallelism over ``torch.distributed``: (a) at world
     size 1 over NCCL in this process, 3 steps of ``make_parallel_train_step``
     at full width from ``warm_qm9s_as.npz`` (batch 128, bf16, dropout 0.1)
     equal bit for bit (losses, parameters, EMA, optimizer state, batch
     statistics) to the one-device step from the same state and draws;
     (b) two ranks spawned over gloo, both on ``cuda:0`` (one card; NCCL
     refuses two ranks on one device), each joined under its own time limit
     and loading phase 2's build: ``run_lib.train`` for 6 steps from the
     warm state at a global batch of 128 (64 a rank, buckets 17, 21, 25,
     29, the device store sharded), then a snapshot of 16 draws at 100
     steps (8 a rank): every loss finite and equal on both ranks, every
     tensor of the state equal across the ranks (digests gathered), the
     checkpoint, export and xyz files written by rank 0 alone, each bf16
     per-op kernel launched 8 x 100 x that rank's rounds times on each rank
     and no other kernel, each rank's median step time, graphs/s and peak
     memory; then one f32 step at dropout 0 within 1e-5 of each parameter's
     largest |value| of one process averaging both shards' gradients;
     (c) ``run_lib.evaluate`` over those ranks on the block path in bf16,
     phase 13's 8 targets, K=2, 100 steps: ``block_fused_bf16`` launched 8
     x 100 x that rank's rounds x K times on each rank and no other kernel,
     every target decoded, the same figures on both ranks, finite and in
     [0, 1] (MCES >= 0), and each rank's draws equal bit for bit to one
     process's ``sample_round`` of its rows with its generator. The phase's
     budget is 90 s.
 15. atom-count-free elucidation on the flagship's per-op bf16 path: (a)
     ``tools/train_atom_count.py``'s ``embed_all`` and ``train_head`` (2
     epochs at batch 128) on the sweep's set through the SpecFormer of
     ``warm_qm9s_as.npz`` (allspectra, trained on fidelity-4 spectra as the
     set is), the held-out metrics, ``save_head`` and
     ``Elucidator.load_count_head`` (every tensor equal), no port kernel
     launched; (b) ``tools/nfree_eval.py``'s protocols A, B and C from
     ``warm_qm9s_ir.npz`` with the committed ``atom_count_head.npz`` at 8
     targets of a 256-molecule fidelity-2 set, 20 steps, K_KNOWN 2,
     K_PER_N 1: each protocol's JSON entry and wall time, every figure in
     [0, 1], ``mix_attention_bf16`` and ``equi_update_bf16`` launched 8 x
     steps x rounds times and no other kernel; (c) ``tools/elucidate_demo.py``
     on one target at 10 steps, with its atom count (one round) and without
     (12 rounds, 2 draws a plausible count): its printed draws, the same
     launch rule. The phase's budget is 60 s.
 16. the repository's last tools through the port's command line, the
     flagship at full width (nf=256, 8 blocks, 16 heads, N <= 29, bf16): (a)
     ``tools/make_rehearsal_pt.py`` writes 512 molecules (its 2048 cut) as
     the reference's processed file with its split file; (b)
     ``diffspectra_tpu_torch/scripts/real_data.sh`` on it, its own
     processes: 9 train steps from a fresh init at batch 128 with a
     checkpoint at the last (``checkpoint_1``), then ``--mode eval`` of that
     checkpoint, 8 targets, K=1, 100 steps on the per-op bf16 path: exit 0,
     finite losses in ``stdout.txt``, ``warm_state.npz`` written, the eval's
     figures finite and in [0, 1]; the same eval again in this process
     (``main.main``): its figures equal the script's, ``mix_attention_bf16``
     and ``equi_update_bf16`` launched 8 x 100 x rounds times and no other
     kernel; (c) ``tools/export_warm_state.py`` on that workdir: every array
     of its npz equal to the train's own ``warm_state.npz`` (max |diff| 0);
     (d) ``tools/warm_to_ckpt.py`` of that npz into a fresh workdir: the
     restored EMA tensors equal the npz's, and ``main.py --mode eval`` there
     gives the figures of ``--mode eval --warm-start`` on the npz (the npz
     holds the weights rounded to bf16, so (b)'s figures are printed beside,
     not held), the same launch rule; (e) ``tools/gt_mmd_anchor.py --size
     512 --n-gen 64`` on cuda within 1e-5 (relative, or absolute near 0) of
     its run on the CPU. Each sub-phase's seconds on a ``[clock]`` line; the
     phase's budget is 75 s.
Then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that last line; without CUDA it exits 2.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import functools
import io
import itertools
import json
import math
import os
import pickle
import re
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
# requests served a path by dtype: the first of them in bf16 (the default) and
# in f32 (the override), to keep the script inside its time limit on a slower
# card host (1287 s with three f32 requests a path on an H100 whose host ran
# the host-bound phases 1.3x slower; 925 s with one: PERF.md §6); bf16 went to
# one request a path when phase 14 came
SERVED = {"bf16": 1, "f32": 1}
# their depth by dtype: f32's cut from 1000 steps when phase 15 came, to pay
# for it; bf16, the production dtype, keeps the reference's 1000
SERVED_STEPS = {"bf16": STEPS, "f32": 200}
SHORT_STEPS, DPM_STEPS = 100, 50  # the count-head, batch and DPM-Solver phases
MARGINAL_STEPS, MARGINAL_DRAWS = 20, 2  # the marginal over the histogram's counts
# phase 7, the eval sweep: tools/tpu_eval_10k.py's batch of 128; a synthetic
# set of 1280 molecules, whose test split holds exactly 128 targets
# the synthetic sets are generated once a run and read back from here (the
# sweep's set of 1280 molecules takes about 16 s a build)
SYNTH_CACHE = os.path.join(tempfile.gettempdir(), f"chip_smoke_synth_{os.getpid()}")
# data.root: the committed upstream statistics of the sub-geometry MMDs
SWEEP = {"seed": 42, "data.synthetic": True, "data.synthetic_cache": SYNTH_CACHE,
         "data.root": os.path.join(ROOT, "data", "QM9S"),
         "data.synthetic_size": 1280, "data.synthetic_fidelity": 4,
         "eval.num_samples": 128, "eval.batch_size": 128, "eval.num_candidates": 10,
         "eval.bucket_sizes": (17, 21, 25, 29), "eval.sampling_temperature": 1.0,
         "sampling.steps": 1000, "sampling.method": "ancestral", "model.pallas_ops": ("block",)}
TOP10_2D_FLOOR = 0.85  # round 5 read 0.9664: about 7 standard errors lower at 128 targets
# a sweep of fewer candidates has no Top-10: its Top-1 2D is held instead
# (round 5 read 0.7490: about 4 standard errors lower at 128 targets)
TOP1_2D_FLOOR = 0.60
# candidates a sweep by dtype: bf16 (the default, as round 5) at K=10; f32
# at K=1, to keep the script inside its time limit (with both at K=10 it ran
# 997 s on an H100; with f32 at K=2 and phase 9, 1166 s: PERF.md §6)
SWEEP_K = {"bf16": 10, "f32": 1}
# ancestral steps a sweep by dtype: bf16's K=10 sweeps cut from round 5's
# 1000 to 500 when phase 16 came, to keep the script inside its time (at
# 1000 they took 250-280 s of it: PERF.md §6); f32's one sweep keeps 1000
SWEEP_STEPS = {"bf16": 500, "f32": 1000}
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
# phase 8, training: the flagship at full width (bf16, dropout 0.1, batch
# 128) on the sweep's synthetic set in buckets, warm-started from WARM; its
# snapshot's depth (1000 steps until phase 14 came, 400 until phase 15, each
# cut to keep the script inside its time)
SNAPSHOT_STEPS = 200
TRAIN = {"seed": 42, "data.synthetic": True, "data.synthetic_cache": SYNTH_CACHE,
         "data.synthetic_size": 1280, "data.synthetic_fidelity": 4,
         "data.bucket_sizes": (17, 21, 25, 29), "training.batch_size": 128,
         "training.eval_batch_size": 128, "training.eval_samples": 128,
         "training.log_freq": 1, "sampling.steps": SNAPSHOT_STEPS, "training.warm_start": WARM}
# the run of checks (b) and (c), remat_policy='full' (30 steps until phase 9
# came, PERF.md §6)
TRAIN_STEPS = 20
TIMED_TAIL = 12  # the steps the median step time is taken over
PROFILED = 2  # the steps of that run under torch.profiler, out of the median
NONE_STEPS = 10  # the run with remat_policy='none'
CHECK_BATCH = 4  # check (a): one f32 step on cuda and on the CPU
CHECK_SET = 64  # check (a)'s synthetic set, whose train split gives its batch
CHECK_LOSS_RTOL, CHECK_GRAD_RTOL = 1e-4, 1e-3  # the latter of each parameter's max |grad|
# SpecFormer's biases whose exact gradient is zero in training mode (a key
# bias shifts a softmax row; the value, to_out and ff2 biases add constants
# a train-mode BatchNorm removes): their gradient is rounding noise, held to
# CHECK_GRAD_RTOL of the model's largest |grad| instead of their own
NOISE_ONLY_GRADS = ("self_attn.W_K.bias", "self_attn.W_V.bias", "self_attn.to_out.bias",
                    "ff2.bias")
SNAPSHOT_SERVE_STEPS = 100  # check (d): one request from the exported warm state
# phase 9, the DMT's other configurations at full width, random weights from
# seed 0: (a) forwards of four variants on cuda against the CPU, each with
# the kernels a forward of it must launch (the JAX block's dispatch: no
# block_fused without cond_time and dist_gbf, and then no kernel at all)
VARIANTS = {
    "dist_gbf_off_gaussian_attn_equi": ({"model.dist_gbf": False,
                                         "model.gbf_name": "GaussianLayer"},
                                        ("attn", "equi"), ("mix_attention", "equi_update_dd1")),
    "cond_time_off_attn_equi": ({"model.cond_time": False}, ("attn", "equi"),
                                ("mix_attention", "equi_update")),
    "gaussian_block": ({"model.gbf_name": "GaussianLayer"}, ("block",), ("block_fused",)),
    "cond_time_off_block": ({"model.cond_time": False}, ("block",), ()),
}
# (b) one variant trained from a fresh init through run_lib.train and served
# from its workdir: dist_gbf off, GaussianLayer, the linear schedule, bf16,
# dropout 0.1, batch 128 (one bucket, n_pad 29, on a 320-molecule set whose
# train split, 136 molecules, holds one batch); a checkpoint at the last of
# 10 steps
VARIANT_TRAIN = {"seed": 42, "model.dist_gbf": False, "model.gbf_name": "GaussianLayer",
                 "sde.schedule": "linear", "data.synthetic": True,
                 "data.synthetic_cache": SYNTH_CACHE, "data.synthetic_size": 320,
                 "data.synthetic_fidelity": 4, "data.bucket_sizes": (),
                 "training.batch_size": 128, "training.n_iters": 9, "training.log_freq": 1,
                 "training.snapshot_freq": 9, "training.snapshot_freq_for_preemption": 10**9,
                 "training.snapshot_sampling": False, "sampling.steps": 100}
VARIANT_TRAIN_STEPS = 10
# phase 10, training as the JAX flagship config trains: the sweep's set
# written as the reference's processed QM9S file (with its conditional split)
# and read with data.synthetic=False, bf16, dropout 0.1, batch 128, buckets
FLAGSHIP = {"seed": 42, "data.synthetic": False, "data.bucket_sizes": (17, 21, 25, 29),
            "training.batch_size": 128, "training.log_freq": 1,
            "training.snapshot_sampling": False, "training.snapshot_freq_for_preemption": 10**9,
            "training.snapshot_freq": 10**9}
WARM_IR = os.path.join(ROOT, "artifacts", "warm_qm9s_ir.npz")
# (a): through the store (profiled), then the host iterator (12 until phase 14 came)
STORE_STEPS, HOST_STEPS = 16, 8
STORE_SNAPSHOT_FREQ = 8  # (a) writes two numbered checkpoints; (e) evaluates the first
PRETRAIN = {"pretrain.n_iters": 20, "pretrain.warmup": 5, "pretrain.batch_size": 128,
            "pretrain.log_freq": 1, "pretrain.snapshot_freq": 20}
RESTORE_STEPS = PARTIAL_STEPS = 5  # (b) from the pretrained SpecFormer, (c) partial
ZERO_FRESH = "cond_encoder/head_linear/kernel"
DOTS_STEPS = 6  # 10 until phase 14 came
EVAL_LOOP = {"eval.num_samples": 8, "eval.batch_size": 8, "eval.num_candidates": 1,
             "sampling.steps": 100}
# phase 11, DMT_WO_EQ (the non-equivariant ablation; no port kernel) at full
# width, random weights from seed 0: (a) the forwards of each trans_ver in
# f32 and bf16, (b) v2 trained from a fresh init, served and swept, (c) the
# flagship with model.specformer_bf16 served on both paths
WO_EQ = {"model.name": "DMT_WO_EQ"}
WO_EQ_TRANS_VERS = ("v1", "v2", "optim")
# (b): bf16, dropout 0.1, batch 128 on phase 9's 320-molecule set (one
# bucket, n_pad 29), 10 steps, the last with a checkpoint and a snapshot of
# 16 draws at 100 steps; then one request on each sampler and the sweep of
# its checkpoint at 8 targets, K=1, 100 steps
WO_EQ_TRAIN = {**WO_EQ, "seed": 42, "data.synthetic": True,
               "data.synthetic_cache": SYNTH_CACHE, "data.synthetic_size": 320,
               "data.synthetic_fidelity": 4, "data.bucket_sizes": (),
               "training.batch_size": 128, "training.n_iters": 9, "training.log_freq": 1,
               "training.snapshot_freq": 9, "training.snapshot_freq_for_preemption": 10**9,
               "training.eval_samples": 16, "training.eval_batch_size": 16,
               "sampling.steps": 100, "eval.ckpts": "1", **EVAL_LOOP}
WO_EQ_TRAIN_STEPS = 10
SPECFORMER_BF16_STEPS = 100  # (c): one request a path
# phase 12, CDGS on the 2-D path (only_2D; no port kernel) at the flagship's
# widths with configs/smoke_2d.py's overrides, random weights from seed 0:
# (a) the forwards in f32 and bf16, (b) trained from a fresh init as phase
# 11 (b) trains, (c) served from its workdir, (d) swept
CDGS_PATH = {"only_2D": True, "model.name": "CDGS", "model.pred_data": False,
             "model.self_cond": False, "model.noise_align": False,
             "model.include_fc_charge": False}
# the 2-D sweep without the sub-geometry MMDs: 2-D molecules carry no
# positions (as the JAX package's tests/test_2d_run_lib.py sets it)
CDGS_TRAIN = {**WO_EQ_TRAIN, **CDGS_PATH, "eval.sub_geometry": False}
CDGS_TRAIN_STEPS = 10
# phase 13, the rest of the eval stack: (a) the flagship eval through
# run_lib.evaluate on 8 targets of phase 7's synthetic set, K=2 at 100 steps
# on the block path in bf16, with the sub-geometry MMDs (data.root set to a
# temporary directory in the phase, so the statistics are computed from the
# test split and written there), save_mols and the original-QM9 reference
# sets of the same synthetic data
EVAL_STACK = {**SWEEP, "eval.num_samples": 8, "eval.batch_size": 8, "eval.num_candidates": 2,
              "sampling.steps": 100, "training.matmul_precision": "bfloat16",
              "eval.sub_geometry": True, "eval.save_mols": "true"}
# phase 14, the mesh (data parallelism over torch.distributed): (a) at world
# size 1 over NCCL in this process, MESH_STEPS steps of make_parallel_train_step
# at full width, batch 128, bf16, dropout 0.1, from WARM, against the
# one-device step; (b) two ranks over gloo, both on cuda:0 (the card is one
# device, and NCCL refuses two ranks on one), spawned with their own time limit:
# run_lib.train for MESH_TRAIN_STEPS steps at a global batch of 128 (64 a rank),
# the device store sharded, then a snapshot of 16 draws (8 a rank) at 100 steps;
# then one f32 step at dropout 0 against its one-process emulation, each
# parameter within MESH_F32_RTOL of its largest |value|; (c) run_lib.evaluate
# on those ranks: phase 13's 8 targets, K=2, 100 steps, the block path in bf16
MESH_STEPS, MESH_TRAIN_STEPS = 3, 6
MESH_TRAIN = {**TRAIN, "training.eval_samples": 16, "training.eval_batch_size": 16,
              "training.snapshot_freq_for_preemption": 10**9, "sampling.steps": 100}
MESH_CHECK_BATCH = 4  # (b)'s f32 step: rows a rank
MESH_F32_RTOL = 1e-5
MESH_SWEEP = {**SWEEP, "eval.num_samples": 8, "eval.batch_size": 8, "eval.num_candidates": 2,
              "sampling.steps": 100, "training.matmul_precision": "bfloat16"}
MESH_RANKS, MESH_RANK_TIMEOUT, MESH_BUDGET_S = 2, 240, 90
# phase 15, atom-count-free elucidation: (a) a count head trained by
# tools/train_atom_count.py's train_head for NFREE_HEAD_EPOCHS epochs at
# batch NFREE_HEAD_BS on the SpecFormer embeddings of the sweep's set, through
# WARM's encoder (the allspectra flagship, trained on fidelity-4 spectra as that
# set is; the trainer's default, warm_qm9s_f4.npz, would make the script read
# a third warm state), saved and reloaded bit for bit; (b) tools/nfree_eval.py's
# protocols A, B and C on the committed head at NFREE_EVAL's depth, on a set of
# NFREE_SIZE molecules at the fidelity warm_qm9s_ir.npz trained on; (c) the
# demo on one target, with and without its atom count, at DEMO_STEPS steps
NFREE_HEAD_EPOCHS, NFREE_HEAD_BS = 2, 128
NFREE_SIZE, NFREE_FIDELITY = 256, 2
NFREE_EVAL = {"--nt": 8, "--steps": 20, "--k-known": 2, "--k-per-n": 1}
DEMO_STEPS, NFREE_BUDGET_S = 10, 60
# phase 16, the repository's last tools through the port's command line: (a)
# make_rehearsal_pt writes REHEARSAL_SIZE molecules (its default of 2048 cut
# to keep the phase short); (b) diffspectra_tpu_torch/scripts/real_data.sh
# trains the flagship from a fresh init (bf16, batch 128) for 9 steps, a
# checkpoint at the last, and evaluates that checkpoint (8 targets, K=1, 100
# steps on the per-op bf16 path); the same eval then runs in this process,
# where the launches can be counted; (c) export_warm_state on that workdir;
# (d) warm_to_ckpt of its npz and main.py --mode eval on the new workdir,
# against main.py --mode eval --warm-start on the npz; (e) gt_mmd_anchor on
# cuda against the CPU, within ANCHOR_TOL (relative or absolute: the floor's
# MMDs lie near 0, and float32 kernel sums in another order move them by
# ~1e-7 of the sums, which are of order 1)
REHEARSAL_SIZE = 512
REAL_DATA_TRAIN = ["training.n_iters=8", "training.snapshot_freq=8",
                   "training.snapshot_sampling=false", "training.log_freq=1"]
REAL_DATA_EVAL = ["eval.num_samples=8", "eval.batch_size=8", "eval.num_candidates=1",
                  "sampling.steps=100"]
REAL_DATA_TIMEOUT = 300
ANCHOR = ["--size", "512", "--n-gen", "64"]
ANCHOR_TOL, TOOLS_BUDGET_S = 1e-5, 75
# (b) the MMD's kernel sums on cuda against the float64 plain version: each
# of xx/n^2, yy/m^2 and xy/nm within MMD_RTOL relative, the MMD within
# MMD_RTOL x (xx/n^2 + yy/m^2), at MMD_SIDE samples a side; then the sums
# timed at the sub-geometry MMDs' cap, 10,000 a side (the plain version is
# not run there: 2e9 exps in numpy)
MMD_SIDE, MMD_CAP, MMD_RTOL = 2000, 10000, 1e-5
# (c) ChemNet (random_chemnet) on cuda against the CPU on 64 SMILES strings,
# within CHEMNET_RTOL of the largest activation
CHEMNET_SMILES, CHEMNET_RTOL = 64, 1e-5
# round 5's moses lines (tools/pipeline_logs/r5/as_topk_10k.log:107-111): the
# JAX package in bf16 on 10k targets; not comparable with a run of 128
ROUND5_MOSES = {"2d": {"FCD_proxy": 0.0174, "SNN": 0.9096, "Frag": 1.0000, "Scaf": 0.0000,
                       "IntDiv": 0.8001, "Filters": 1.0000, "weight": 115.7354},
                "3d": {"FCD_proxy": 3.2275}}
# (c): the spectra embedding on cuda against the CPU, over the CPU's own
# difference between SpecFormer in bf16 and in f32 (both DMTs bf16). No
# kernel runs in SpecFormer: the bound catches an encoder that is not the
# CPU's, not the bf16 rounding noise of two correct ones (cuda's and the
# CPU's exp and sums in another order flip roundings of the softmax
# weights: on the CPU, against JAX, 0.58 of that difference)
SPECFORMER_BF16_RATIO = 2.0
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
# bf16 forwards, cuda against the CPU: the largest |difference| over the
# CPU's own largest |bf16 - f32|, by path. Each bound lies between what
# correct kernels read and what the drop_k control reads: on an H100
# (python -m diffspectra_tpu_torch.tools.bf16_noise, 8 seeds), the kernels'
# outputs changed by 2^-22 relative noise read up to 0.21 on the block
# path and 1.56 on the per-op path, drop_k at least 31.3 and 25.9. The
# block path rounds to bf16 only q, k and v, so the kernels' f32 sums in
# another order move it little. The per-op path rounds the pair grid to
# bf16 in every block (the edge embedding, its LayerNorm and modulation,
# the FFN inputs), so a one-ulp difference in a kernel's sum flips
# roundings downstream and the forward is fixed only up to its own bf16
# rounding noise, about the gap itself. The bound catches a wrong kernel,
# not that noise, nor a kernel that rounds its outputs to bf16 (it reads
# 0.51-2.76, within the noise); phase 3 holds each kernel to 1e-5.
BF16_FORWARD_RATIO = {"block": 0.5, "attn_equi": 2.0}
PATHS = {"attn_equi": ("attn", "equi"), "block": ("block",)}
PATH_KERNELS = {"attn_equi": ("mix_attention", "equi_update"), "block": ("block_fused",)}
# training.matmul_precision of each dtype the port serves in; bf16 is the
# default, as in the JAX package
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def kernels_of(path, dt):
    """The LAUNCHES keys of a path's kernels in a dtype (a serving kernel's
    launches on bfloat16 operands count under its name + "_bf16")."""
    return tuple(k + ("_bf16" if dt == "bf16" else "") for k in PATH_KERNELS[path])


def base_name(kernel):
    """The CUDA kernel of a row: its name without ``_bf16`` (the dtype of its
    operands) and ``_dd1`` (equi_update on a 1-wide dist, ``dist_gbf=False``)."""
    return kernel.removesuffix("_bf16").removesuffix("_dd1")
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


def nbytes_of(args, *outs):
    """Bytes a call must move: each input read once, each output written once."""
    return sum(a.numel() * a.element_size() for a in (*args, *outs))


def bound_of(work):
    """The least time the card could take for ``work`` (tensor-core FLOP,
    f32 FLOP, bytes), ms, and what bounds it: the products on the tensor
    cores at 989 TFLOP/s plus the rest at 67, against the bytes at
    3.35 TB/s."""
    tc, f32, nbytes = work
    t_ops = (tc / BF16_PEAK + f32 / F32_PEAK) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_case(gen, dev, n_nodes=N_NODES, N=N, bf16=False):
    """mix_attention inputs for graphs of ``n_nodes`` atoms padded to N (the
    serving shape by default), q, k, v, edge_attr, w0 and w1 in bfloat16
    when ``bf16`` (as the JAX DMT in bfloat16 passes them), and the work they
    need: (tensor-core FLOP, f32 FLOP, bytes)."""
    B = len(n_nodes)
    de, n_sub, sub_c, heads, out_ch, n_extra = 64, 14, 18, 16, 16, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    extra = (torch.rand(B, N, N, n_extra, generator=gen) > 0.5).float().to(dev)
    args = [r(B, N, n_sub, sub_c), r(B, N, n_sub, sub_c), r(B, N, heads, out_ch),
            r(B, N, N, de), r(de, n_sub * sub_c, scale=de**-0.5),
            r(de, heads * out_ch, scale=de**-0.5), extra, ragged_masks(dev, n_nodes, N)]
    if bf16:
        args[:6] = [a.to(torch.bfloat16) for a in args[:6]]
    ec, hc = n_sub * sub_c, heads * out_ch
    # per pair: two gate projections (on the tensor cores in bf16), their
    # tanh, q*k*e0 and the head sums, the softmax, alpha*v*e1 and the j sum
    # (dense over all N x N pairs)
    products = B * N * N * 2 * de * (ec + hc)
    rest = B * N * N * ((ec + hc) + 3 * ec + 3 * heads + 3 * hc)
    work = (products, rest) if bf16 else (0, products + rest)
    return args, {"set_inf": True}, (*work, nbytes_of(args) + 4 * B * N * hc)


def equi_case(gen, dev, n_nodes=N_NODES, N=N, bf16=False, dd=64):
    """equi_update inputs for graphs of ``n_nodes`` atoms padded to N (the
    serving shape by default), node_i, node_j, edge_attr, dist, w_e, w_d and
    the bias in bfloat16 when ``bf16``, dist ``dd`` wide (64, or 1 for
    ``dist_gbf=False``), and the work they need (tensor-core FLOP, f32 FLOP,
    bytes)."""
    B = len(n_nodes)
    de, dh, n_adj = 64, 256, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    adj = (torch.rand(B, N, N, n_adj, generator=gen) > 0.5).float().to(dev)
    args = [r(B, N, dh), r(B, N, dh), r(B, N, N, de), r(B, N, N, dd), r(B, N, N, 3),
            adj, ragged_masks(dev, n_nodes, N), r(de, dh, scale=de**-0.5), r(dd, dh, scale=dd**-0.5),
            r(dh, scale=0.1), r(B, dh, scale=0.1), r(B, dh, scale=0.1),
            r(dh, dh, scale=dh**-0.5), r(dh, scale=0.1), r(dh, 1 + n_adj, scale=dh**-0.5)]
    if bf16:
        for i in (0, 1, 2, 3, 7, 8, 9):
            args[i] = args[i].to(torch.bfloat16)
    # per pair: the two gate projections (on the tensor cores in bf16, but
    # a 1-wide dist's, an outer product the bf16 kernel folds into its f32
    # epilogue), the W0 product, the W1 product, and about 12 operations per
    # channel for sums, LayerNorm, modulation, silu
    folded = B * N * N * 2 * dd * dh if bf16 and dd == 1 else 0
    products = B * N * N * 2 * (de + dd) * dh - folded
    rest = B * N * N * (2 * dh * dh + 2 * dh * (1 + n_adj) + 12 * dh) + folded
    work = (products, rest) if bf16 else (0, products + rest)
    return args, {}, (*work, nbytes_of(args) + 4 * B * N * 3)


def block_case(gen, dev, n_nodes=N_NODES, N=N, bf16=False):
    """block_fused inputs at flagship widths for graphs of ``n_nodes``
    atoms padded to N (the serving shape by default), q, k and v in
    bfloat16 when ``bf16``, and the work they need (tensor-core FLOP, f32
    FLOP, bytes: its products stay f32)."""
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
    if bf16:
        for key in ("q", "k", "v"):
            data[key] = data[key].to(torch.bfloat16)
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
    nbytes = nbytes_of(args) + 4 * (B * N * dh + B * N * N * de + B * N * 3)
    return args, dict(n_heads=heads, n_extra=n_extra, out_ch=out_ch), (0, flops, nbytes)


def phase_kernels(dev):
    from diffspectra_tpu_torch.ops.block_fused import block_fused, block_fused_reference
    from diffspectra_tpu_torch.ops.equi_update import equi_update, equi_update_reference
    from diffspectra_tpu_torch.ops.mix_attention import mix_attention, mix_attention_reference

    gen = torch.Generator().manual_seed(0)
    registers = ptxas_registers()
    rows = []
    specs = (
        ("mix_attention", mix_attention, mix_attention_reference, attention_case,
         "diffspectra_tpu_torch/csrc/mix_attention.cu", "diffspectra_tpu/ops/pallas_attention.py:147"),
        ("equi_update", equi_update, equi_update_reference, equi_case,
         "diffspectra_tpu_torch/csrc/equi_update.cu", "diffspectra_tpu/ops/pallas_equi_update.py:139"),
        # dist_gbf=False: a 1-wide dist (in bf16 folded into the epilogue)
        ("equi_update_dd1", equi_update, equi_update_reference,
         functools.partial(equi_case, dd=1), "diffspectra_tpu_torch/csrc/equi_update.cu",
         "diffspectra_tpu/ops/pallas_equi_update.py:139"),
        ("block_fused", block_fused, block_fused_reference, block_case,
         "diffspectra_tpu_torch/csrc/block_fused.cu", "diffspectra_tpu/ops/pallas_block.py:230"),
    )
    # each kernel on f32 operands, then on the bf16 operands of the JAX DMT in bf16
    for (base, kernel, plain, base_case, source, replaces), bf16 in itertools.product(
            specs, (False, True)):
        name = base + ("_bf16" if bf16 else "")
        case = functools.partial(base_case, bf16=bf16)
        args, kw, work = case(gen, dev)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = 0.0
        for g, w in zip(got, want):  # every output, padded rows and pairs included
            e = (g - w).abs().max().item()
            atol = KERNEL_ATOL[base_name(name)]
            say(f"[kernels] {name}: {tuple(g.shape)} max |kernel - plain| = {e:.3e} "
                f"(tolerance {atol:.0e}, max |plain| = {w.abs().max().item():.3e})")
            assert torch.isfinite(g).all() and e <= atol, name
            err = max(err, e)
        ms = cuda_time_ms(lambda: kernel(*args, **kw), iters=200)
        plain_ms = cuda_time_ms(lambda: plain(*args, **kw), iters=50)
        bound_ms, bound_by = bound_of(work)
        tc, f32, nbytes = work
        regs = kernel_registers(base_name(name), bf16, registers)
        say(f"[kernels] {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain version, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({tc / 1e9:.3f} GFLOP on the bf16 tensor "
            f"cores, {f32 / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.3f} MB); ptxas registers a thread "
            f"{regs}")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   max_abs_err=err, max_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None, registers=regs,
                   tensor_core_gflop=tc / 1e9, f32_gflop=f32 / 1e9, mbytes=nbytes / 1e6)
        row.update(kernel_extras(name, kernel, plain, case, dev, gen, lambda: kernel(*args, **kw)))
        row["max_abs_err"] = row["max_err"] = max(err, row["shapes_max_err"])
        if base != "block_fused":
            row.update(row_tile_extras(name, args, dev))
        rows.append(row)
        del args, got, want
    return rows


def ptxas_registers():
    """Registers a thread of each kernel of the build, by mangled name, from
    nvcc's -Xptxas=-v output."""
    from diffspectra_tpu_torch.ops import _lib

    registers, kernel = {}, None
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and "Used" in line and "registers" in line:
            registers[kernel] = int(re.search(r"Used (\d+) registers", line).group(1))
    return registers


def kernel_registers(base, bf16, registers):
    """A serving kernel's instances in one dtype and their registers: the
    row-tile kernels' <tile rows, bf16> instances (Lb1 / Lb0 in the mangled
    name), block_fused's stages, attn_stage<unsigned short> (ItE) or
    <float> (IfE)."""
    if base == "block_fused":
        stages = KERNEL_STAGES[base]
        keep = lambda k: any(s in k for s in stages) and (
            "attn_stage" not in k or ("ItE" if bf16 else "IfE") in k)
    else:
        keep = lambda k: f"{base}_kernel" in k and ("Lb1E" if bf16 else "Lb0E") in k
    return {k: v for k, v in registers.items() if keep(k)}


def kernel_extras(name, kernel, plain, case, dev, gen, call):
    """A kernel beyond the serving shape: against its plain version at each
    of BLOCK_SHAPES (ragged: one graph of N atoms, the rest 1..N; every
    output, padding included), then ``call`` (the serving shape) with L2
    cold (FLUSH_BYTES written before each call): CUDA events a call, and
    each launch's device time from the profiler, warm and cold."""
    err, shape_errs = 0.0, {}
    for batch, n in BLOCK_SHAPES:
        n_nodes = [n] + torch.randint(1, n + 1, (batch - 1,), generator=gen).tolist()
        args, kw, _ = case(gen, dev, n_nodes, n)
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        outs = ("h_out", "edge_out", "agg") if base_name(name) == "block_fused" else ("out",)
        for out, g, w in zip(outs, got, want):
            e = (g - w).abs().max().item()
            atol = KERNEL_ATOL[base_name(name)]
            say(f"[kernels] {name} B={batch} N={n}: {out} {tuple(g.shape)} max |kernel - "
                f"plain| = {e:.3e} (tolerance {atol:.0e}, max |plain| = "
                f"{w.abs().max().item():.3e})")
            assert torch.isfinite(g).all() and e <= atol, (name, batch, n, out)
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
    stages = KERNEL_STAGES[base_name(name)]
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
    bf16 = name.endswith("_bf16")  # the yardstick's products in bf16 too
    dt = torch.bfloat16 if bf16 else torch.float32
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dt)
    if base_name(name) == "equi_update":
        dh, de, dd = args[0].shape[-1], args[2].shape[-1], args[3].shape[-1]
        plan, sizes = equi_plan(B, N, de, dd, dh, bf16), (B, N, de, dd, dh, int(bf16))
        x1, w1, x2, w2 = r(B * N * N, de + dd), r(de + dd, dh), r(B * N * N, dh), r(dh, dh)
        products = lambda: (x1 @ w1, x2 @ w2)
        shapes = f"[{B * N * N}, {de + dd}] @ [{de + dd}, {dh}] + [{B * N * N}, {dh}] @ [{dh}, {dh}]"
    else:
        q, v, edge = args[0], args[2], args[3]
        ec, hc, heads, de = q.shape[2] * q.shape[3], v.shape[2] * v.shape[3], v.shape[2], edge.shape[-1]
        plan, sizes = attn_plan(B, N, de, ec, hc, heads, bf16), (B, N, de, ec, hc, heads, int(bf16))
        x, w = r(B * N * N, de), r(de, ec + hc)
        products = lambda: x @ w
        shapes = f"[{B * N * N}, {de}] @ [{de}, {ec + hc}]"
    blocks = ctypes.c_int(0)
    _lib.check_rc(f"{name} occupancy", getattr(_lib.build(), f"dstt_{base_name(name)}_occupancy")(
        *sizes, ctypes.byref(blocks)))
    cublas_ms = cuda_time_ms(products, iters=200)
    cublas_device_ms = device_ms(products)
    say(f"[kernels] {name} B={B} N={N}: plan {plan.grid} blocks of {plan.threads} threads, "
        f"tiles of {plan.tile_rows} pair rows holding {plan.rows_per_tile} rows of a molecule, "
        f"{plan.smem} bytes of shared memory, "
        f"{plan.blocks_per_sm} blocks an SM planned, {blocks.value} on the card; cuBLAS "
        f"yardstick {shapes} ({dt}): {cublas_ms:.4f} ms, {ms_or_none(cublas_device_ms)} on the "
        "device")
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


def compare(tag, got, want):
    """Assert each output within FORWARD_RTOL x max|want|."""
    for name, g, w in zip(("pred", "edge_pred"), got, want):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        say(f"[forward] {tag} {name}: max |diff| = {err:.3e}, max |value| = {scale:.3e}, "
            f"tolerance {FORWARD_RTOL:.0e} x max")
        assert torch.isfinite(g).all() and err <= FORWARD_RTOL * scale, (tag, name)


def phase_forward(dev):
    """Both paths' full-width forwards on cuda against the CPU: in f32
    within FORWARD_RTOL, and the two cuda paths against each other; in bf16
    within BF16_FORWARD_RATIO of the CPU's own bf16-against-f32 difference
    on the same inputs, and the drop_k control above it. Returns the cuda
    models by (path, dtype)."""
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import load_model
    from diffspectra_tpu_torch.tools.bf16_noise import forward, max_ratio, perturbed

    gpu_models, cuda_outs, cpu_f32 = {}, {}, {}
    for (path, ops), dt in itertools.product(PATHS.items(), DTYPES):
        config = configs.apply_overrides(configs.get_config(), {
            "model.pallas_ops": ops, "training.matmul_precision": DTYPES[dt]})
        cpu_model = load_model(WARM, config, "cpu")
        gpu_models[path, dt] = gpu_model = copy.deepcopy(cpu_model).to(dev)
        assert all(b.e_block.block_kernel == (path == "block") for b in gpu_model.blocks)
        assert gpu_model.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
        for has_cond in (True, False):
            got, want = forward(gpu_model, dev, has_cond), forward(cpu_model, "cpu", has_cond)
            if dt == "f32":
                compare(f"{path} f32 has_cond={has_cond} cuda vs cpu", got, want)
                cuda_outs[path, has_cond], cpu_f32[path, has_cond] = got, want
                continue
            with perturbed("drop_k"):
                faulty = forward(gpu_model, dev, has_cond)
            bound = BF16_FORWARD_RATIO[path]
            for name, g, w, w32, f in zip(("pred", "edge_pred"), got, want,
                                          cpu_f32[path, has_cond], faulty):
                err, gap = (g - w).abs().max().item(), (w - w32).abs().max().item()
                mean_ratio = ((g - w).abs().mean() / (w - w32).abs().mean()).item()
                control = max_ratio(f, w, w32)
                say(f"[forward] {path} bf16 has_cond={has_cond} {name}: max |cuda bf16 - cpu "
                    f"bf16| = {err:.3e}, max |cpu bf16 - cpu f32| = {gap:.3e}, ratio "
                    f"{err / gap:.4f} (bound {bound}; drop_k control {control:.4f}); mean "
                    f"|cuda bf16 - cpu bf16| over mean |cpu bf16 - cpu f32| {mean_ratio:.4f}")
                assert torch.isfinite(g).all() and gap > 0, (path, name)
                assert err <= bound * gap < control * gap, (path, name, err / gap, control)
    for has_cond in (True, False):
        compare(f"f32 has_cond={has_cond} cuda block vs cuda attn_equi",
                cuda_outs["block", has_cond], cuda_outs["attn_equi", has_cond])
    return gpu_models


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def add_launches(total, launches):
    """Add the counts of ``launches`` into ``total``, by kernel."""
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def launched_only(path_kernels, launches, expected):
    """The kernels of the path launched ``expected`` times, the others never."""
    want = {k: (expected if k in path_kernels else 0) for k in launches}
    assert launches == want, (launches, want)


def serve_path(path, dt, dev, data):
    """Serve the first SERVED[dt] of the REQUESTS through one path in one
    dtype; the counts are this path's."""
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.info import get_dataset_info
    from diffspectra_tpu_torch.evaluation.molgraph import MolGraph
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    overrides = {"sampling.steps": SERVED_STEPS[dt], "model.pallas_ops": PATHS[path]}
    if dt == "f32":  # bf16 is the default
        overrides["training.matmul_precision"] = DTYPES[dt]
    el = Elucidator.from_warm_state(WARM, overrides=overrides, device=dev)
    tag = f"serve {path} {dt}"
    say(f"[{tag}] loaded {WARM} in {time.perf_counter() - t0:.2f} s; "
        f"pallas_ops={el.config.model.pallas_ops}, matmul_precision="
        f"{el.config.training.matmul_precision} (DMT {el.model.dtype}), "
        f"steps={el.config.sampling.steps}, candidates={CANDIDATES}, requests={SERVED[dt]}")
    assert el.config.training.matmul_precision == DTYPES[dt]
    decoder = get_dataset_info("qm9_second_half")["atom_decoder"]
    reset_launches()  # counts from here on are this path's
    per_request = []
    for m in range(SERVED[dt]):
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
        say(f"[{tag}] request {m}: n_atoms={n} wall={wall:.3f} s "
            f"({CANDIDATES / wall:.3f} sampled mols/s), {len(result.candidates)} distinct "
            f"candidates, best frequency {result.best.frequency:.2f}, finite={finite}, "
            f"top-1 WL hash equals target={hit}, launches={nonzero(launched)}")
        assert finite and sum(c.count for c in result.candidates) == CANDIDATES
        assert all(c.molgraph.n_atoms == n for c in result.candidates)
        per_request.append(dict(n_atoms=n, wall_s=wall, mols_per_s=CANDIDATES / wall,
                                distinct=len(result.candidates), top1_hit=hit))
    launches = dict(LAUNCHES)
    expected = el.config.model.n_layers * SERVED_STEPS[dt] * SERVED[dt]
    say(f"[{tag}] launches {nonzero(launches)}, expected {expected} for "
        f"{kernels_of(path, dt)}, 0 for the others")
    launched_only(kernels_of(path, dt), launches, expected)
    total = sum(r["wall_s"] for r in per_request)
    say(f"[{tag}] " + json.dumps({"requests": per_request,
                                  "mols_per_s": SERVED[dt] * CANDIDATES / total}))
    return el, launches


def serve_more(el, dev, data, queries):
    """The rest of serving on the block path in the default dtype (bf16), at
    SHORT_STEPS (DPM_STEPS for DPM-Solver) steps: the count head and
    DPM-Solver on the requests of ``data``, elucidate_batch on the 8
    ``queries``."""
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    def elucidator(**overrides):
        config = configs.apply_overrides(copy.deepcopy(el.config), overrides)
        return Elucidator(config, el.model, dev)

    n_layers = el.config.model.n_layers
    (kernel,) = kernels_of("block", "bf16")
    assert el.config.training.matmul_precision == configs.get_config().training.matmul_precision
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
    launched_only((kernel,), dict(LAUNCHES), n_layers * SHORT_STEPS * len(counts))

    # the marginal without a head: every plausible count of the train
    # histogram, MARGINAL_DRAWS draws each, each count's round counted alone
    marginal = elucidator(**{"sampling.steps": MARGINAL_STEPS})
    plain_round, per_count = marginal._round, {}

    def counted_round(contexts, n_atoms, n_pad, generator):
        before = LAUNCHES[kernel]
        mols = plain_round(contexts, n_atoms, n_pad, generator)
        per_count[n_atoms[0]] = LAUNCHES[kernel] - before
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
    launched_only((kernel,), dict(LAUNCHES), n_layers * MARGINAL_STEPS * len(ns))

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
    launched_only((kernel,), dict(LAUNCHES), n_layers * SHORT_STEPS * len(pads))

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
        launched_only((kernel,), dict(LAUNCHES), n_layers * DPM_STEPS)


def phase_profile(path, model, dev):
    """Kernel time by name over 5 forwards at the serving shape, and the
    device's busy share of the window (from the profiler's kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    from diffspectra_tpu_torch.tools.bf16_noise import forward_inputs

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


def sweep_figures(fig, K=10):
    """The sweep's figures by the names of ROUND5 and NOT_COMPARABLE (its
    Top-K as Top-10 where K is 10, else under its own K; no Top-K and no
    consensus at K=1)."""
    m3, m2 = fig["metric_3d"], fig["metric_2d"]
    out = {"Metric-3D atom stability": m3["atom_stable"], "Metric-3D mol stability": m3["mol_stable"],
           "Metric-3D validity": m3["Validity"], "Metric-3D complete": m3["Complete"],
           "Metric-2D atom stability": m2["atom_stable"], "Metric-2D mol stability": m2["mol_stable"],
           "Metric-2D validity": m2["Validity"], "Metric-2D complete": m2["Complete"],
           "Metric-2D unique & valid": m2["Unique"], "Metric-2D novelty": m2["Novelty"],
           "Top-1 2D": fig["top1_2d"], "Top-1 3D": fig["top1_3d"],
           "memorization bound": fig["generalization"]["seen"] / fig["generalization"]["targets"]}
    if K > 1:
        out.update({f"Top-{K} 2D": fig["topk_2d"], f"Top-{K} 3D": fig["topk_3d"],
                    "Consensus 2D": fig["consensus_2d"], "Consensus 3D": fig["consensus_3d"]})
    for dim in ("2D", "3D"):
        for name, value in fig[f"similarity_{dim.lower()}"].items():
            out[f"{dim} {name}"] = value
    return out


def phase_sweep(dev, dt):
    """Phase 7: the eval sweep on the block path in one dtype; its gates
    raise. Returns its launches and figures."""
    import logging

    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="[sweep log] %(message)s",
                        force=True)
    settings = {**SWEEP, "training.matmul_precision": DTYPES[dt],
                "eval.num_candidates": SWEEP_K[dt], "sampling.steps": SWEEP_STEPS[dt]}
    config = configs.apply_overrides(configs.get_config(), settings)
    tag = f"sweep {dt}"
    say(f"[{tag}] settings {json.dumps(settings)}")
    eval_dir = tempfile.mkdtemp(prefix="eval_sweep_")  # the similarity tables
    reset_launches()  # counts from here on are the sweep's
    t0 = time.perf_counter()
    fig = run_lib.evaluate(config, WARM, eval_dir, dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    K, steps, targets = config.eval.num_candidates, config.sampling.steps, fig["targets"]
    rounds = fig["rounds"]
    draws = SWEEP["eval.batch_size"] * len(rounds)
    say(f"[{tag}] rounds (draws, n_pad): {rounds}; phase wall {wall:.1f} s")
    for k, sw in enumerate(fig["sweeps"]):
        sampling_s, decode_s = (sum(r) for r in zip(*sw["round_seconds"]))
        say(f"[{tag}] sweep {k + 1}/{K}: wall {sw['seconds']:.3f} s, {sw['decoded']} of {targets} "
            f"targets decoded, {draws / sw['seconds']:.3f} sampled mols/s; sampling "
            f"{sampling_s:.3f} s and host decode {decode_s:.4f} s over {len(rounds)} rounds "
            f"({decode_s / len(rounds):.4f} s a round)")
    sweep_s = sum(sw["seconds"] for sw in fig["sweeps"])
    ph = fig["phase_seconds"]
    extra = ("" if K == 1 else f", the extra sweeps' scoring "
             f"{ph[f'topk-extra-sweeps(x{K - 1})'] - sum(s['seconds'] for s in fig['sweeps'][1:]):.2f} s")
    say(f"[{tag}] sampling {sweep_s:.1f} s over {K} sweeps ({K * draws / sweep_s:.3f} sampled "
        f"mols/s); host scoring: metrics-3d {ph['metrics-3d']:.2f} s, metrics-2d "
        f"{ph['metrics-2d']:.2f} s{extra}, similarity {ph['similarity']:.2f} s; phase-time "
        f"{json.dumps(ph)}")
    expected = config.model.n_layers * steps * len(rounds) * K
    say(f"[{tag}] launches {nonzero(launches)}, expected {expected} for "
        f"{kernels_of('block', dt)} (8 blocks x {steps} steps x {len(rounds)} rounds x {K} "
        "sweeps), 0 for the others")
    launched_only(kernels_of("block", dt), launches, expected)
    assert all(sw["decoded"] == targets for sw in fig["sweeps"]) and len(fig["sweeps"]) == K

    figures = sweep_figures(fig, K)
    counts = {"targets": targets}
    for dim in ("2d", "3d"):  # the valid pairs: one detailed score each
        name = f"similarity_metrics_{dim}_ckpt_warm_qm9s_as_detailed_scores.json"
        with open(os.path.join(eval_dir, name)) as f:
            counts[f"valid_{dim}"] = len(json.load(f)["Top-1 Accuracy"])
    shutil.rmtree(eval_dir)
    say(f"[{tag}] figures, the port ({dt}) on {targets} targets (valid pairs: 2D "
        f"{counts['valid_2d']}, 3D {counts['valid_3d']}) against round 5 (the JAX package, bf16, "
        "10k targets); SE = binomial standard error of round 5's proportion at this run's count:")
    for name, (r5, over) in ROUND5.items():
        if name not in figures:
            say(f"[{tag}]   {name}: not measured at K={K} (round 5 {r5:.4f})")
            continue
        se = "" if over is None else \
            f", SE {math.sqrt(r5 * (1 - r5) / counts[over]):.4f} at n={counts[over]}"
        say(f"[{tag}]   {name}: {figures[name]:.4f} (round 5 {r5:.4f}{se})")
    for name, (r5, why) in NOT_COMPARABLE.items():
        say(f"[{tag}]   {name}: {figures[name]:.4f} (round 5 {r5:.4f}; not comparable: {why})")
    for dim, names in ROUND5_MOSES.items():
        for name, r5 in names.items():
            say(f"[{tag}]   moses {dim.upper()} {name}: {fig[f'moses_{dim}'][name]:.4f} (round 5 "
                f"{r5:.4f}; not comparable: a set's own size and split)")
        assert math.isnan(fig[f"moses_{dim}"]["FCD"]), fig[f"moses_{dim}"]
    geo = fig["geometry"]
    say(f"[{tag}]   Metric-Align against the committed upstream statistics "
        f"({config.data.root}/target_geometry_stat.pk): bond length MMD "
        f"{geo['bond_length_mean']:.4f}, bond angle {geo['bond_angle_mean']:.4f}, dihedral "
        f"{geo['dihedral_angle_mean']:.6f}; by symbol {json.dumps(geo)}")
    for name, value in figures.items():
        if "MACCS" in name or "Fraggle" in name:
            assert math.isnan(value), (name, value)  # RDKit-only
        elif "MCES" in name:
            assert math.isfinite(value) and value >= 0, (name, value)
        else:
            assert math.isfinite(value) and 0 <= value <= 1, (name, value)
    gate, floor = ("Top-10 2D", TOP10_2D_FLOOR) if K == 10 else ("Top-1 2D", TOP1_2D_FLOOR)
    assert figures[gate] >= floor, (gate, figures[gate])
    say(f"[{tag}] gates held: launches, {targets} of {targets} decoded in each of {K} sweeps, "
        f"figures in range, {gate} {figures[gate]:.4f} >= {floor}")
    print(json.dumps({"sweep": {"dtype": dt, "figures": figures, "moses_2d": fig["moses_2d"],
                                "moses_3d": fig["moses_3d"], "geometry": geo,
                                "rounds": rounds, "wall_s": wall,
                                "sweep_s": [sw["seconds"] for sw in fig["sweeps"]],
                                "round_s": [sw["round_seconds"] for sw in fig["sweeps"]],
                                "phase_s": ph}}), flush=True)
    return launches, figures, counts


def compare_sweeps(results):
    """Each figure of the bf16 and f32 sweeps beside round 5's (bf16 too,
    so bf16 is the like-for-like comparison), with the binomial standard
    error of round 5's proportion at each sweep's count."""
    say("[sweeps] figure: bf16 | f32 | round 5 (the JAX package in bf16, 10k targets); SE at "
        "this run's count")
    for name, (r5, over) in ROUND5.items():
        parts = []
        for dt, (_, figures, counts) in results.items():
            if name not in figures:
                parts.append(f"{dt} not measured at K={SWEEP_K[dt]}")
                continue
            se = "" if over is None else f" (SE {math.sqrt(r5 * (1 - r5) / counts[over]):.4f})"
            parts.append(f"{dt} {figures[name]:.4f}{se}")
        say(f"[sweeps]   {name}: {' | '.join(parts)} | round 5 {r5:.4f}")


def train_config(**overrides):
    from diffspectra_tpu_torch import configs

    return configs.apply_overrides(configs.get_config(), {**TRAIN, **overrides})


def train_check_cpu(dev, smi):
    """Check (a): one f32 step's loss and gradients at dropout 0 on cuda and
    on the CPU, from the warm state and the same draws (self-conditioned,
    so every parameter is read)."""
    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.data.pipeline import get_batch_iterator, get_dataset
    from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
    from diffspectra_tpu_torch.training.losses import draw, get_sde_graph_loss_fn
    from diffspectra_tpu_torch.training.train_state import params_of
    from diffspectra_tpu_torch.utils.scalers import get_data_scaler
    from diffspectra_tpu_torch.warm_state import warm_start

    config = train_config(**{"training.matmul_precision": "float32", "model.dropout": 0.0,
                             "training.batch_size": CHECK_BATCH,
                             "data.synthetic_size": CHECK_SET})
    _, train_ds, _, _, _ = get_dataset(config)
    batch = run_lib.batch_to_device(next(get_batch_iterator(
        train_ds, CHECK_BATCH, config.data.spectra_version, seed=config.seed,
        bucket_sizes=config.data.bucket_sizes)), torch.device("cpu"))
    draws = draw(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2), batch,
                 config.model.n_layers, config.model.include_fc_charge)
    draws["use_sc"] = True
    loss_fn = get_sde_graph_loss_fn(NoiseScheduleVP.from_config(config),
                                    get_data_scaler(config), config)

    def step(device):
        _, state = run_lib.init_train_state(config, device)
        state = warm_start(state, WARM)
        moved = {k: (tuple(c.to(device) for c in v) if k == "context" else v.to(device))
                 for k, v in batch.items()}
        moved_draws = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in draws.items()}
        params = params_of(state.model.train())
        t0 = time.perf_counter()
        loss = loss_fn(state.model, moved, moved_draws)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.item(), {k: g.cpu() for k, g in zip(params, grads)},
                time.perf_counter() - t0)

    (loss_gpu, g_gpu, s_gpu), (loss_cpu, g_cpu, s_cpu) = step(dev), step(torch.device("cpu"))
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, want in g_cpu.items():
        scale = top if name.endswith(NOISE_ONLY_GRADS) else want.abs().max().item()
        err = (g_gpu[name] - want).abs().max().item()
        assert err <= CHECK_GRAD_RTOL * scale, (name, err, scale)
        if scale and err / scale > worst:
            worst, worst_name = err / scale, name
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    say(f"[train] (a) one f32 step, batch {CHECK_BATCH}, n_pad {batch['atom_mask'].shape[1]}, "
        f"dropout 0, warm state: loss cuda {loss_gpu:.6f}, cpu {loss_cpu:.6f} (relative "
        f"{rel:.2e}, bound {CHECK_LOSS_RTOL}); {len(g_cpu)} gradients, the largest |cuda - "
        f"cpu| over the parameter's max |grad| {worst:.2e} ({worst_name}; bound "
        f"{CHECK_GRAD_RTOL}); seconds cuda {s_gpu:.2f}, cpu {s_cpu:.2f}; {smi}")
    assert rel <= CHECK_LOSS_RTOL, rel


def busy_share(prof, window_us, smi):
    """The device's busy share over the profiled steps, and the names of
    their kernels: none of the port's."""
    # the schedule's ProfilerStep ranges carry their steps' device time again
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and e.device_time_total > 0 and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.device_time_total for e in events)
    ours = set(itertools.chain(*KERNEL_STAGES.values())) | {k for _, k in PROBE_KERNELS.values()}
    hit = sorted({e.key for e in events if any(name in e.key for name in ours)})
    events.sort(key=lambda e: -e.device_time_total)
    say(f"[train] profile of {PROFILED} steps of the loop: window {window_us:.0f} us, kernel "
        f"time {busy_us:.0f} us (busy share {busy_us / window_us:.3f}), {len(events)} kernels "
        f"by name, the port's among them: {hit or 'none'}; {smi}")
    for e in events[:10]:
        say(f"[train]   {e.device_time_total / PROFILED:10.1f} us/step  "
            f"x{e.count // PROFILED:<5d} {e.key[:90]}")
    assert not hit, hit
    return busy_us / window_us


def train_run(dev, smi, policy, steps, snapshot):
    """``run_lib.train`` from the warm state for ``steps`` steps with
    ``remat_policy``, and with ``snapshot`` its snapshot of 128 draws at
    SNAPSHOT_STEPS steps from the EMA weights. The loop logs each step after reading
    its loss, which waits for the step: the times between those lines are
    its step times, the median over the tail (without the profiled steps)
    is reported, and the peak memory is read at the last step's line, ahead
    of the snapshot. With ``snapshot`` it also profiles PROFILED steps of the
    tail. Returns the state, its config, the timings and the launches."""
    import logging

    from torch.profiler import ProfilerActivity, profile, schedule

    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.warm_state import read_warm_state

    warm_step = read_warm_state(WARM)["step"]
    last = warm_step + steps - 1  # the loop runs steps warm_step ... n_iters
    config = train_config(**{"model.remat_policy": policy, "training.n_iters": last,
                             "training.snapshot_freq": 10**9,
                             "training.snapshot_freq_for_preemption": 10**9,
                             "training.snapshot_sampling": snapshot})
    wait = steps - PROFILED - 3  # then a warmup step, PROFILED steps, and two more
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=wait, warmup=1, active=PROFILED, repeat=1),
                   # the steps out of the median: the warmup step (the profiler
                   # starts), the profiled ones, and the next (the trace is read)
                   on_trace_ready=lambda p: found.update(
                       busy=busy_share(p, (marks[-1] - marks[-1 - PROFILED]) * 1e6, smi),
                       profiled=range(len(marks) - 2 - PROFILED, len(marks))))
    losses, marks, peaks, found = [], [], [], {}

    class StepLines(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "training_loss" in msg:
                marks.append(time.perf_counter())
                peaks.append(torch.cuda.max_memory_allocated())
                losses.append(float(msg.split("training_loss: ")[1].split(",")[0]))
                if snapshot:
                    prof.step()

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handler = StepLines()
    root.addHandler(handler)
    workdir = tempfile.mkdtemp(prefix="train_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # counts from here on are this run's
    t0 = time.perf_counter()
    if snapshot:
        with prof:
            state = run_lib.train(config, workdir, dev)
    else:
        state = run_lib.train(config, workdir, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    root.removeHandler(handler)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    timed = [t for i, t in enumerate(step_ms) if i not in found.get("profiled", ())]
    tail = timed[-min(TIMED_TAIL, len(timed) - 1):]
    median = float(np.median(tail))
    timing = {"median_ms": median, "graphs_per_s": config.training.batch_size / median * 1e3,
              "max_memory_bytes": peaks[-1], "step_ms": step_ms}
    say(f"[train] remat_policy={policy}: run_lib.train, {steps} steps from step {warm_step} "
        f"(batch {config.training.batch_size}, buckets {config.data.bucket_sizes}, bf16, "
        f"dropout {config.model.dropout}){' and a snapshot' if snapshot else ''}, {wall:.1f} s "
        f"in all; median step {median:.1f} ms over the last {len(tail)} unprofiled steps "
        f"({timing['graphs_per_s']:.1f} graphs/s); step ms {[round(t, 1) for t in step_ms]}; "
        f"max_memory_allocated {peaks[-1] / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; {smi}")
    assert len(losses) == steps and all(math.isfinite(x) for x in losses), losses
    assert state.step == warm_step + steps
    if snapshot:
        assert "busy" in found, "the profiler's trace never came"
        timing["busy_share"] = found["busy"]
        with open(os.path.join(workdir, "samples", f"iter_{last}.json")) as f:
            timing["figures"] = json.load(f)
        # the snapshot's molecule files, of its samples and of their targets
        xyz = {sub: sorted(os.listdir(os.path.join(workdir, "samples", sub)))
               for sub in (f"iter_{last}", f"iter_{last}_gt")}
        say(f"[train] (c) snapshot's xyz files: { {k: len(v) for k, v in xyz.items()} }")
        assert xyz[f"iter_{last}_gt"] and all(
            n.startswith("mol_") and n.endswith(".xyz") for v in xyz.values() for n in v), xyz
    shutil.rmtree(workdir)
    return state, config, timing, launches


def train_checks(state, config, timing, launches, smi):
    """Checks (b) and (c) on the run with the snapshot: params and EMA moved
    from the warm state; the snapshot launched each bf16 per-op kernel 8 x
    steps x rounds times (the train steps none); its figures in [0, 1]."""
    from diffspectra_tpu_torch.warm_state import flax_variables, read_warm_state

    warm = read_warm_state(WARM)
    got, shadow = flax_variables(state.model), flax_variables(state.model, state.ema.shadow_params)
    moved_p = sum(not np.array_equal(got[k], v) for k, v in warm["params"].items())
    moved_e = sum(not np.array_equal(shadow[k], v) for k, v in warm["ema"].items())
    say(f"[train] (b) leaves moved from the warm state: params {moved_p} of "
        f"{len(warm['params'])}, EMA {moved_e} of {len(warm['ema'])}")
    assert moved_p > 0 and moved_e > 0
    figures = timing.pop("figures")
    rounds = math.ceil(config.training.eval_samples / config.training.eval_batch_size)
    expected = config.model.n_layers * config.sampling.steps * rounds
    say(f"[train] (c) snapshot, {config.training.eval_samples} draws at "
        f"{config.sampling.steps} steps from the EMA weights: {json.dumps(figures)}; launches "
        f"{nonzero(launches)}, expected {expected} for {kernels_of('attn_equi', 'bf16')} "
        "(8 blocks x steps x rounds; the train steps launch none), 0 for the others; " + smi)
    launched_only(kernels_of("attn_equi", "bf16"), launches, expected)
    for dim in ("3D", "2D"):
        for key in ("atom_stable", "mol_stable", "Validity", "Complete", "Unique"):
            assert math.isfinite(figures[dim][key]) and 0 <= figures[dim][key] <= 1


def train_round_trip(dev, state, config, smi):
    """Check (d): a checkpoint written and restored gives every tensor back;
    a warm-state export serves one request through
    ``Elucidator.from_warm_state``."""
    from diffspectra_tpu_torch import checkpoint, run_lib
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.warm_state import export_warm_state

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_checkpoint(tmp, state)
        _, fresh = run_lib.init_train_state(config, dev)
        restored = checkpoint.restore_checkpoint(tmp, fresh)
        pairs = list(zip(state.model.state_dict().values(), restored.model.state_dict().values()))
        pairs += [(state.ema.shadow_params[k], restored.ema.shadow_params[k])
                  for k in state.ema.shadow_params]
        for key in ("mu", "nu", "nu_max"):
            pairs += [(state.opt_state[key][k], restored.opt_state[key][k])
                      for k in state.opt_state[key]]
        assert all(torch.equal(a, b) for a, b in pairs) and restored.step == state.step
        path = os.path.join(tmp, "warm.npz")
        export_warm_state(state, path)
        el = Elucidator.from_warm_state(path, overrides={"sampling.steps": SNAPSHOT_SERVE_STEPS},
                                        device=dev)
        data = generate(seed=7, size=1, max_n=29, fidelity=4)
        n = int(data["num_atom"][0])
        reset_launches()
        result = el.elucidate({k: data[k][0] for k in ("uv", "ir", "raman")}, n_atoms=n,
                              num_candidates=CANDIDATES, seed=0)
        launches = dict(LAUNCHES)
    expected = config.model.n_layers * SNAPSHOT_SERVE_STEPS
    say(f"[train] (d) checkpoint round trip: {len(pairs)} tensors equal, step {restored.step}; "
        f"the exported warm state served one request (n_atoms {n}, {CANDIDATES} candidates, "
        f"{SNAPSHOT_SERVE_STEPS} steps): {len(result.candidates)} distinct, best frequency "
        f"{result.best.frequency:.2f}; launches {nonzero(launches)}; {smi}")
    assert sum(c.count for c in result.candidates) == CANDIDATES
    assert all(np.isfinite(c.positions).all() for c in result.candidates)
    launched_only(kernels_of("attn_equi", "bf16"), launches, expected)


def phase_train(dev, smi):
    """Phase 8: training on the card. Returns the snapshot's launches and
    the timings of the ``full`` and ``none`` runs."""
    t0 = time.perf_counter()
    train_check_cpu(dev, smi)
    state, config, full, launches = train_run(dev, smi, "full", TRAIN_STEPS, snapshot=True)
    train_checks(state, config, full, launches, smi)
    train_round_trip(dev, state, config, smi)
    del state
    torch.cuda.empty_cache()
    none = train_run(dev, smi, "none", NONE_STEPS, snapshot=False)[2]
    print(json.dumps({"train": {"full": full, "none": none, "phase_s": time.perf_counter() - t0}}),
          flush=True)
    say(f"[train] phase 8 in {time.perf_counter() - t0:.1f} s")
    return launches, {"full": full, "none": none}


def variant_config(over, ops=None, precision=None):
    """The flagship config with ``over``, and ``pallas_ops`` and
    ``training.matmul_precision`` where given."""
    from diffspectra_tpu_torch import configs

    extra = {} if ops is None else {"model.pallas_ops": ops}
    if precision is not None:
        extra["training.matmul_precision"] = precision
    return configs.apply_overrides(configs.get_config(), {**over, **extra})


def variant_forwards(dev, smi):
    """Phase 9 (a): each of VARIANTS at full width from random weights,
    bf16 and f32 forwards (self-conditioned, B=10, N=29) on cuda against
    the same models on the CPU: f32 within FORWARD_RTOL, bf16 within
    BF16_FORWARD_RATIO of the CPU's own bf16-against-f32 difference (the
    block bound where block_fused runs, the per-op bound where the pair grid
    is rounded in bf16: the per-op kernels or the XLA branch); each forward's
    launches exactly its kernels', 8 each. Returns the launches by kernel."""
    from diffspectra_tpu_torch.models.dmt import DMT
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.tools.bf16_noise import forward
    from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

    total = {}
    for name, (over, ops, kernels) in VARIANTS.items():
        outs = {}
        for dt in ("f32", "bf16"):
            config = variant_config(over, ops, DTYPES[dt])
            cpu_model = DMT.from_config(config)
            load_model_state(cpu_model, random_variables(cpu_model, seed=0))
            gpu_model = copy.deepcopy(cpu_model).to(dev)
            reset_launches()
            got = forward(gpu_model, dev, True)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            want = [k + ("_bf16" if dt == "bf16" else "") for k in kernels]
            expected = {k: (config.model.n_layers if k in want else 0) for k in launches}
            say(f"[variants] {name} {dt}: pallas_ops={ops}, launches a forward "
                f"{nonzero(launches)} (expected {nonzero(expected) or 'none'})")
            assert launches == expected, (name, dt, launches)
            add_launches(total, launches)
            outs[dt] = got, forward(cpu_model, "cpu", True)
            del gpu_model
        (g32, w32), (g16, w16) = outs["f32"], outs["bf16"]
        compare(f"variant {name} f32 cuda vs cpu", g32, w32)
        bound = BF16_FORWARD_RATIO["block" if "block_fused" in kernels else "attn_equi"]
        for out, g, w, w_f32 in zip(("pred", "edge_pred"), g16, w16, w32):
            err, gap = (g - w).abs().max().item(), (w - w_f32).abs().max().item()
            say(f"[variants] {name} bf16 {out}: max |cuda bf16 - cpu bf16| = {err:.3e}, max "
                f"|cpu bf16 - cpu f32| = {gap:.3e}, ratio {err / gap:.4f} (bound {bound})")
            assert torch.isfinite(g).all() and gap > 0 and err <= bound * gap, (name, out)
    say(f"[variants] (a) forwards held on cuda; {smi}")
    return total


def variant_train_serve(dev, smi):
    """Phase 9 (b): VARIANT_TRAIN trained from a fresh init for 10 steps
    through ``run_lib.train`` (finite losses, a checkpoint), served from its
    workdir through ``Elucidator.from_workdir`` (the EMA weights and batch
    statistics restored equal to the trained state's): one fidelity-4
    request at K=10 with 100 ancestral steps, then with DPM-Solver++, each
    launching the bf16 per-op kernels 8 x 100 times (equi_update on the
    1-wide dist) and no other. Returns the launches by kernel."""
    import logging

    from diffspectra_tpu_torch import checkpoint, run_lib
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    config = variant_config(VARIANT_TRAIN)
    marks, losses = [], []

    class StepLines(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "training_loss" in msg:
                marks.append(time.perf_counter())
                losses.append(float(msg.split("training_loss: ")[1].split(",")[0]))

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    handler = StepLines()
    root.addHandler(handler)
    workdir = tempfile.mkdtemp(prefix="variant_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        state = run_lib.train(config, workdir, dev)
    finally:
        root.removeHandler(handler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    say(f"[variants] (b) run_lib.train of {VARIANT_TRAIN}: {len(losses)} steps from a fresh "
        f"init in {wall:.1f} s (the set's build included); step ms "
        f"{[round(t, 1) for t in step_ms]}, median {np.median(step_ms):.1f}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; losses {[round(x, 4) for x in losses]}; "
        f"launches {nonzero(dict(LAUNCHES)) or 'none'}; {smi}")
    assert len(losses) == VARIANT_TRAIN_STEPS and all(math.isfinite(x) for x in losses), losses
    assert state.step == VARIANT_TRAIN_STEPS and not nonzero(dict(LAUNCHES))
    assert checkpoint.latest_numbered_checkpoint(workdir) == 1

    el = Elucidator.from_workdir(workdir, config, device=dev)
    restored = el.model.state_dict()
    trained = {**state.model.state_dict(), **state.ema.shadow_params}
    assert set(restored) == set(trained)
    assert all(torch.equal(restored[k], trained[k]) for k in restored)
    assert el.noise_scheduler.schedule == "linear" and el.model.dtype == torch.bfloat16
    data = generate(seed=11, size=1, max_n=29, fidelity=4)
    n = int(data["num_atom"][0])
    spectra = {k: data[k][0] for k in ("uv", "ir", "raman")}
    want = ("mix_attention_bf16", "equi_update_dd1_bf16")
    total = {}
    dpm_config = copy.deepcopy(config)
    dpm_config.sampling.method = "dpm_solver"
    for method, server in (("ancestral", el), ("dpm_solver", Elucidator(dpm_config, el.model, dev))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = server.elucidate(spectra, n_atoms=n, num_candidates=CANDIDATES, seed=0)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        expected = config.model.n_layers * config.sampling.steps
        finite = all(np.isfinite(c.positions).all() for c in result.candidates)
        say(f"[variants] (b) served from the workdir's checkpoint ({method}, "
            f"{config.sampling.steps} steps, n_atoms {n}, {CANDIDATES} candidates): {serve_s:.3f} "
            f"s, {len(result.candidates)} distinct, best frequency {result.best.frequency:.2f}, "
            f"finite={finite}; launches {nonzero(launches)}, expected {expected} for {want}; "
            f"{smi}")
        assert finite and sum(c.count for c in result.candidates) == CANDIDATES
        launched_only(want, launches, expected)
        add_launches(total, launches)
    shutil.rmtree(workdir)
    return total


def phase_variants(dev, smi):
    """Phase 9: the DMT's other configurations on the card. Returns the
    launches of both parts by kernel."""
    t0 = time.perf_counter()
    forwards = variant_forwards(dev, smi)
    served = variant_train_serve(dev, smi)
    say(f"[variants] phase 9 in {time.perf_counter() - t0:.1f} s")
    return {k: forwards.get(k, 0) + served.get(k, 0) for k in set(forwards) | set(served)}


class LogLines:
    """The root logger's messages while in use, with the time and peak
    memory at each train step's log line (written after its loss is read,
    which waits for the step)."""

    def __init__(self):
        import logging

        self.messages, self.marks, self.peaks, self.losses = [], [], [], []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                outer.messages.append(msg)
                if "training_loss" in msg or msg.startswith("pretrain step"):
                    outer.marks.append(time.perf_counter())
                    outer.peaks.append(torch.cuda.max_memory_allocated())
                    key = "training_loss: " if "training_loss" in msg else "loss: "
                    outer.losses.append(float(msg.split(key)[1].split(",")[0]))

        self.handler = Handler()

    def __enter__(self):
        import logging

        root = logging.getLogger()
        root.setLevel(logging.INFO)
        root.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger().removeHandler(self.handler)

    def step_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]

    def having(self, text):
        return [m for m in self.messages if text in m]


def flagship_config(**overrides):
    from diffspectra_tpu_torch import configs

    return configs.apply_overrides(configs.get_config(), {**FLAGSHIP, **overrides})


def logged_train(config, dev, keep=False):
    """``run_lib.train`` in a new temporary workdir under ``LogLines``, the
    peak memory from its start; the workdir is removed unless ``keep``
    (then ``lines.workdir``)."""
    from diffspectra_tpu_torch import run_lib

    workdir = tempfile.mkdtemp(prefix="flagship_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LogLines() as lines:
        state = run_lib.train(config, workdir, dev)
    torch.cuda.synchronize()
    lines.wall, lines.workdir = time.perf_counter() - t0, workdir
    if not keep:
        shutil.rmtree(workdir)
    return state, lines


def median_of(step_ms, first, last):
    """The median of the step times of steps ``first`` ... ``last - 1``
    (counted from the run's first step: ``step_ms[i]`` is step i + 1's)."""
    return float(np.median(step_ms[first - 1:last - 1]))


def qm9s_loader_and_store(dev, smi, root, warm_step):
    """Phase 10 (a): the sweep's set written as the reference's processed
    file, read through ``load_qm9s`` (``data.synthetic=False``) and trained
    16 steps through the device store from WARM with ``training.profile``
    (numbered checkpoints every 8 steps), then 12 steps through the host
    iterator; the store's bytes and first batch checked against
    ``estimate_bytes`` and the host collate. Returns the store run's
    workdir and both runs' timings."""
    from diffspectra_tpu_torch.data import device_store, qm9s
    from diffspectra_tpu_torch.data.pipeline import (
        _conditional_splits,
        _truncate_batch,
        collate,
        get_dataset,
    )
    from diffspectra_tpu_torch.data.synthetic import generate

    t0 = time.perf_counter()
    raw = generate(seed=42, size=1280, max_n=29, fidelity=4, cache_dir=SYNTH_CACHE)
    splits = _conditional_splits(np.random.default_rng(42), 1280)
    qm9s.write_processed_from_raw(root, raw, splits)
    say(f"[flagship] (a) wrote generate(seed=42, size=1280, fidelity=4) as "
        f"{qm9s.PROCESSED} with its split file in {time.perf_counter() - t0:.1f} s")
    last = warm_step + STORE_STEPS - 1
    config = flagship_config(**{"data.root": root, "training.warm_start": WARM,
                                "training.profile": True, "training.n_iters": last,
                                "training.snapshot_freq": STORE_SNAPSHOT_FREQ})
    state, store = logged_train(config, dev, keep=True)
    trace = os.path.join(store.workdir, "profile", f"trace_step_{warm_step + 15}.json")
    assert store.having("device-resident dataset") and not store.having("host input pipeline")
    assert len(store.losses) == STORE_STEPS and all(map(math.isfinite, store.losses))
    assert os.path.getsize(trace) > 0, trace

    # the store's bytes on the card, and its first batch against the host collate
    _, train_ds, _, _, _ = get_dataset(config)
    spectra_version = config.data.spectra_version
    ds_store = device_store.DeviceStore(train_ds, spectra_version, dev)
    n_pad, idx = next(device_store.index_iterator(
        len(train_ds), config.training.batch_size, seed=config.seed,
        bucket_sizes=config.data.bucket_sizes, num_atom=ds_store.host_num_atom))
    got = device_store.build_batch(ds_store.arrays, torch.from_numpy(idx).to(dev),
                                   atom_types=config.data.atom_types,
                                   include_aromatic=config.data.include_aromatic,
                                   spectra_keys=ds_store.spectra_keys, n_pad=n_pad)
    want = collate(_truncate_batch(train_ds.take(idx), n_pad), spectra_version)
    batch_err = max([float(np.abs(got[k].cpu().numpy() - want[k]).max()) for k in
                     ("atom_one_hot", "edge_one_hot", "positions", "formal_charges",
                      "atom_mask", "edge_mask")]
                    + [float(np.abs(g.cpu().numpy() - w).max())
                       for g, w in zip(got["context"], want["context"])])
    nbytes, estimate = ds_store.nbytes(), device_store.estimate_bytes(train_ds, spectra_version)
    del ds_store

    host_config = flagship_config(**{"data.root": root, "training.warm_start": WARM,
                                     "data.device_resident": False,
                                     "training.n_iters": warm_step + HOST_STEPS - 1})
    _, host = logged_train(host_config, dev)
    assert host.having("host input pipeline") and not host.having("device-resident dataset")
    assert len(host.losses) == HOST_STEPS and all(map(math.isfinite, host.losses))
    # the median over the steps after the second and before the profiled window
    timing = {"store_ms": median_of(store.step_ms(), 2, 10),
              "host_ms": median_of(host.step_ms(), 2, HOST_STEPS),
              "store_peak_bytes": store.peaks[-1], "host_peak_bytes": host.peaks[-1]}
    bs = config.training.batch_size
    say(f"[flagship] (a) {len(train_ds)} train molecules from {root}/packed; store: {nbytes} "
        f"bytes on the card (estimate_bytes {estimate}); its first batch (n_pad {n_pad}) against "
        f"the host collate: max |diff| {batch_err}")
    say(f"[flagship] (a) {STORE_STEPS} steps through the store from step {warm_step} (profile of "
        f"steps {warm_step + 10}-{warm_step + 14}: {os.path.getsize(trace)} bytes) in "
        f"{store.wall:.1f} s, {HOST_STEPS} through the host iterator in {host.wall:.1f} s; median "
        f"step (steps 2-9 of each) store {timing['store_ms']:.1f} ms ({bs / timing['store_ms'] * 1e3:.1f} "
        f"graphs/s), host {timing['host_ms']:.1f} ms ({bs / timing['host_ms'] * 1e3:.1f} graphs/s); "
        f"step ms store {[round(t, 1) for t in store.step_ms()]}, host "
        f"{[round(t, 1) for t in host.step_ms()]}; peak {timing['store_peak_bytes'] / 2**30:.2f}, "
        f"{timing['host_peak_bytes'] / 2**30:.2f} GiB; losses store "
        f"{[round(x, 4) for x in store.losses]}, host {[round(x, 4) for x in host.losses]}; {smi}")
    assert nbytes == estimate and batch_err == 0.0, (nbytes, estimate, batch_err)
    del state
    return store.workdir, timing


def pretrain_and_restore(dev, smi, root):
    """Phase 10 (b): ``pretrain_specformer`` at the flagship's widths for 20
    steps (warmup 5), then a fresh DMT with the file as
    ``model.pretrained_specformer_path``: its SpecFormer equal to the file's
    tensors, then 5 finite train steps."""
    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.training.pretrain import CKPT_NAME, load_specformer_npz
    from diffspectra_tpu_torch.training.pretrain import pretrain_specformer
    from diffspectra_tpu_torch.warm_state import flax_variables

    config = flagship_config(**{"data.root": root, **PRETRAIN})
    workdir = tempfile.mkdtemp(prefix="pretrain_")
    t0 = time.perf_counter()
    with LogLines() as lines:
        pretrain_specformer(config, workdir, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bs = config.pretrain.batch_size
    median = median_of(lines.step_ms(), 2, len(lines.losses))
    path = os.path.join(workdir, CKPT_NAME)
    say(f"[flagship] (b) pretrain_specformer ({config.data.spectra_version}, nf "
        f"{config.model.nf}, batch {bs}, {config.pretrain.n_iters} steps, warmup "
        f"{config.pretrain.warmup}) in {wall:.1f} s: median step {median:.2f} ms, "
        f"{bs / median * 1e3:.1f} spectra/s; losses {[round(x, 4) for x in lines.losses]}; {smi}")
    assert len(lines.losses) == config.pretrain.n_iters and all(map(math.isfinite, lines.losses))

    train_config = flagship_config(**{"data.root": root, "model.pretrained_specformer_path": path,
                                      "training.n_iters": RESTORE_STEPS - 1})
    params, stats = load_specformer_npz(path)
    _, fresh = run_lib.init_train_state(train_config, dev)
    got = flax_variables(fresh.model)
    equal = all(np.array_equal(got[f"params/cond_encoder/{k}"], v) for k, v in params.items()) \
        and all(np.array_equal(got[f"batch_stats/cond_encoder/{k}"], v) for k, v in stats.items())
    del fresh
    _, run = logged_train(train_config, dev)
    say(f"[flagship] (b) a fresh flagship DMT with the pretrained SpecFormer: {len(params)} "
        f"params and {len(stats)} batch statistics of cond_encoder equal to the file's: {equal}; "
        f"{len(run.losses)} steps, losses {[round(x, 4) for x in run.losses]}, "
        f"{run.wall:.1f} s; {smi}")
    assert equal and run.having("Load pretrained SpecFormer")
    assert len(run.losses) == RESTORE_STEPS and all(map(math.isfinite, run.losses))
    shutil.rmtree(workdir)
    return {"pretrain_ms": median, "spectra_per_s": bs / median * 1e3}


def partial_warm_start(dev, smi, root):
    """Phase 10 (c): the allspectra flagship from WARM_IR, partial, its fresh
    ``cond_encoder/head_linear/kernel`` zeroed: the logged counts of
    restored, fresh and zeroed leaves on cuda equal the CPU's; 5 finite
    steps."""
    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.warm_state import read_warm_state, warm_start_partial

    config = flagship_config(**{"data.root": root, "training.warm_start": WARM_IR,
                                "training.warm_start_partial": True,
                                "training.warm_start_zero_fresh": ZERO_FRESH})
    with LogLines() as cpu:
        _, cpu_state = run_lib.init_train_state(config, torch.device("cpu"))
        _, reports = warm_start_partial(cpu_state, WARM_IR, (ZERO_FRESH,))
    del cpu_state
    config.training.n_iters = read_warm_state(WARM_IR)["step"] + PARTIAL_STEPS - 1
    _, run = logged_train(config, dev)
    want, got = cpu.having("partial warm start"), run.having("partial warm start")
    counts = {t: (len(r["restored"]), len(r["fresh"]), len(r["zeroed"]))
              for t, r in reports.items()}
    say(f"[flagship] (c) allspectra from {os.path.basename(WARM_IR)}, partial, zeroing "
        f"{ZERO_FRESH}: (restored, fresh, zeroed) by tree {counts}; cuda's log lines equal the "
        f"CPU's: {want == got}; {len(run.losses)} steps, losses "
        f"{[round(x, 4) for x in run.losses]}, {run.wall:.1f} s; {smi}")
    assert len(want) == 3 and want == got
    assert all(reports[t]["zeroed"] == ["params/" + ZERO_FRESH] for t in ("params", "ema"))
    assert len(run.losses) == PARTIAL_STEPS and all(map(math.isfinite, run.losses))
    return counts


def dots_run(dev, smi, root, warm_step, phase8):
    """Phase 10 (d): ``remat_policy='dots'`` for DOTS_STEPS steps from WARM; its
    median step and peak memory beside phase 8's ``full`` and ``none``, the
    peak between theirs."""
    config = flagship_config(**{"data.root": root, "training.warm_start": WARM,
                                "model.remat_policy": "dots",
                                "training.n_iters": warm_step + DOTS_STEPS - 1})
    _, run = logged_train(config, dev)
    median = median_of(run.step_ms(), 2, DOTS_STEPS)
    peak = run.peaks[-1]
    full, none = phase8["full"], phase8["none"]
    say(f"[flagship] (d) remat_policy='dots': {DOTS_STEPS} steps in {run.wall:.1f} s, median "
        f"step {median:.1f} ms (phase 8: full {full['median_ms']:.1f}, none "
        f"{none['median_ms']:.1f}), peak {peak / 2**30:.2f} GiB (full "
        f"{full['max_memory_bytes'] / 2**30:.2f}, none {none['max_memory_bytes'] / 2**30:.2f}); "
        f"step ms {[round(t, 1) for t in run.step_ms()]}; losses "
        f"{[round(x, 4) for x in run.losses]}; {smi}")
    assert len(run.losses) == DOTS_STEPS and all(map(math.isfinite, run.losses))
    assert full["max_memory_bytes"] < peak < none["max_memory_bytes"], peak
    return {"median_ms": median, "max_memory_bytes": peak}


def eval_loop(dev, smi, root, workdir, warm_step):
    """Phase 10 (e): ``--mode eval``'s loop over (a)'s first numbered
    checkpoint (``eval.ckpts``; two until phase 16 came), 8 targets, K=1,
    100 steps: finite figures, the bf16 per-op kernels launched 8 x steps x
    rounds times and no other. Returns the launches."""
    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    ckpts = [(warm_step + STORE_SNAPSHOT_FREQ - 1) // STORE_SNAPSHOT_FREQ]
    config = flagship_config(**{"data.root": root, **EVAL_LOOP,
                                "eval.ckpts": ",".join(map(str, ckpts))})
    reset_launches()
    t0 = time.perf_counter()
    figures = run_lib.evaluate_checkpoints(config, workdir, "eval", dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rounds = sum(len(f["rounds"]) for f in figures.values())
    expected = config.model.n_layers * config.sampling.steps * rounds
    say(f"[flagship] (e) evaluate_checkpoints over checkpoints {ckpts} of (a)'s workdir "
        f"({config.eval.num_samples} targets, K=1, {config.sampling.steps} steps) in {wall:.1f} "
        f"s: " + "; ".join(
            f"checkpoint {c}: Top-1 2D {f['top1_2d']:.4f}, 3D {f['top1_3d']:.4f}, 2D validity "
            f"{f['metric_2d']['Validity']:.4f}, rounds {f['rounds']}" for c, f in figures.items())
        + f"; launches {nonzero(launches)}, expected {expected} for "
        f"{kernels_of('attn_equi', 'bf16')}; {smi}")
    assert sorted(figures) == ckpts
    for f in figures.values():
        for v in (f["top1_2d"], f["top1_3d"], *f["metric_2d"].values(), *f["metric_3d"].values()):
            assert math.isfinite(v) and v >= 0, f
        assert all(s["decoded"] == config.eval.num_samples for s in f["sweeps"])
    launched_only(kernels_of("attn_equi", "bf16"), launches, expected)
    return launches


def host_packer(smi, root):
    """Phase 10 (f): ``native/packer.cc`` built with the card host's
    compiler, against ``pack_batch_numpy`` on 128 of the set's molecules."""
    from diffspectra_tpu_torch.data import native
    from diffspectra_tpu_torch.data.qm9s import load_qm9s

    raw, _ = load_qm9s(root)
    args = [np.asarray(raw[k][:128]) for k in ("atom_type", "pos", "edge_type", "fc", "num_atom")]
    spectra = np.asarray(raw["ir"][:128])
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native.pack_batch(*args, spectra)
    pack_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = native.pack_batch_numpy(*args, spectra)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    say(f"[flagship] (f) the host packer: built in {build_s:.2f} s; 128 molecules packed in "
        f"{pack_ms:.2f} ms (numpy {numpy_ms:.2f} ms), max |diff| {err:.3g}; {smi}")
    assert set(got) == set(want) and err <= 1e-6, err


def phase_flagship(dev, smi, phase8):
    """Phase 10: training as the JAX flagship config trains. Returns the
    launches of its main path (the eval loop) by kernel."""
    from diffspectra_tpu_torch.warm_state import read_warm_state

    t0 = time.perf_counter()
    warm_step = read_warm_state(WARM)["step"]
    root = tempfile.mkdtemp(prefix="qm9s_")
    store_dir, loader = qm9s_loader_and_store(dev, smi, root, warm_step)
    pretrain = pretrain_and_restore(dev, smi, root)
    counts = partial_warm_start(dev, smi, root)
    dots = dots_run(dev, smi, root, warm_step, phase8)
    launches = eval_loop(dev, smi, root, store_dir, warm_step)
    host_packer(smi, root)
    shutil.rmtree(store_dir)
    shutil.rmtree(root)
    seconds = time.perf_counter() - t0
    print(json.dumps({"flagship": {"loader": loader, "pretrain": pretrain, "partial": counts,
                                   "dots": dots, "phase_s": seconds}}), flush=True)
    say(f"[flagship] phase 10 in {seconds:.1f} s")
    return launches


def model_outputs(model, args, specs):
    """The model's outputs on ``args`` and the embedding of ``specs``,
    float32 on the CPU."""
    with torch.no_grad():
        return [o.float().cpu() for o in model(*args, model.encode_context(specs))]


def held_forwards(dev, smi, tag, over, inputs, outputs):
    """The flagship config with ``over`` at full width from random weights
    (seed 0): f32 and bf16 forwards on ``inputs(device)`` (the model's
    positional arguments before the spectra embedding, and the spectra;
    B=10, N=29) on cuda against the same model on the CPU: f32 within
    FORWARD_RTOL, bf16 within the per-op bound of the CPU's own
    bf16-against-f32 difference; no port kernel launched, and none among a
    profiled forward's kernels. Returns the bf16 ratios by name of
    ``outputs``, a forward's ms by dtype (CUDA events, 10 calls, the
    spectra embedding made once) and the launches of the first forward of
    each dtype by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.utils.registry import create_model
    from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

    ours = set(itertools.chain(*KERNEL_STAGES.values())) | {k for _, k in PROBE_KERNELS.values()}
    bound = BF16_FORWARD_RATIO["attn_equi"]
    outs, ratios, forward_ms, total = {}, {}, {}, {}
    for dt in ("f32", "bf16"):
        config = variant_config(over, precision=DTYPES[dt])
        cpu_model = create_model(config)
        assert type(cpu_model).__name__ == config.model.name
        load_model_state(cpu_model, random_variables(cpu_model, seed=0))
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        args, specs = inputs(dev)
        reset_launches()
        got = model_outputs(gpu_model, args, specs)
        add_launches(total, LAUNCHES)
        launches = nonzero(dict(LAUNCHES))
        with torch.no_grad():
            emb = gpu_model.encode_context(specs)
            forward_ms[dt] = cuda_time_ms(lambda: gpu_model(*args, emb), iters=10, warmup=2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model_outputs(gpu_model, args, specs)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
        hit = sorted(n for n in names if any(k in n for k in ours))
        say(f"[{tag}] {dt}: a forward (B={B}, N={N}) on cuda {forward_ms[dt]:.2f} ms (CUDA "
            f"events, 10 calls); port kernels launched {launches or 'none'}; {len(names)} "
            f"kernels by name under the profiler, the port's among them {hit or 'none'}; {smi}")
        assert not launches and not hit, (tag, dt, launches, hit)
        outs[dt] = got, model_outputs(cpu_model, *inputs("cpu"))
        del gpu_model
    (g32, w32), (g16, w16) = outs["f32"], outs["bf16"]
    compare(f"{tag} f32 cuda vs cpu", g32, w32)
    for out, g, w, w_f32 in zip(outputs, g16, w16, w32):
        err, gap = (g - w).abs().max().item(), (w - w_f32).abs().max().item()
        ratios[out] = err / gap
        say(f"[{tag}] bf16 {out}: max |cuda bf16 - cpu bf16| = {err:.3e}, max |cpu bf16 - cpu "
            f"f32| = {gap:.3e}, ratio {err / gap:.4f} (bound {bound})")
        assert torch.isfinite(g).all() and gap > 0 and err <= bound * gap, (tag, out)
    say(f"[{tag}] forwards held on cuda; {smi}")
    return ratios, forward_ms, total


def wo_eq_inputs(dev):
    """``bf16_noise``'s self-conditioned reverse step (B=10, N=29) as
    DMT_WO_EQ takes it, and its spectra."""
    from diffspectra_tpu_torch.tools.bf16_noise import forward_inputs

    args, specs = forward_inputs(dev, True)
    return args + [True], specs


def cdgs_inputs(dev):
    """One reverse step of the 2-D path at B=10, N=29 (N_NODES) as CDGS
    takes it: masked atom features, symmetric bonds, times across the
    schedule, no self-conditioning; and the spectra of synthetic
    molecules."""
    from diffspectra_tpu_torch.data.synthetic import generate

    rng = np.random.default_rng(1)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    edge_mask = ragged_masks("cpu")
    node_mask = (torch.arange(N)[None] < torch.tensor(N_NODES)[:, None]).float()[..., None]
    e = T(rng.normal(size=(B, N, N, 2)))
    args = (torch.linspace(1e-3, 1.0, B), T(rng.normal(size=(B, N, 5))) * node_mask, node_mask,
            edge_mask, (e + e.transpose(1, 2)) * edge_mask[..., None])
    data = generate(seed=3, size=B, max_n=N, fidelity=4)
    specs = [T(np.log10(data[k] + 1.0)) for k in ("uv", "ir", "raman")]
    return [a.to(dev) for a in args] + [None, None, None, False], [s.to(dev) for s in specs]


def train_serve_sweep(dev, smi, tag, over, steps):
    """The flagship config with ``over`` (bf16) trained from a fresh init
    for ``steps`` steps through ``run_lib.train``: finite losses, params
    and EMA moved, a checkpoint, and a snapshot that writes its targets'
    xyz files and its samples' (none under ``only_2D``: they have no
    positions). Served from its workdir through ``Elucidator.from_workdir``:
    one fidelity-4 request at K=10 with each sampler, each candidate a
    decoded graph with finite positions (none under ``only_2D``). Swept by
    ``evaluate_checkpoints``: the 3D and 2D figures (the 2D alone under
    ``only_2D``), each finite and in [0, 1]. No port kernel launched.
    Returns the timings and the launches of the runs by kernel."""
    from diffspectra_tpu_torch import checkpoint, run_lib
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.utils.registry import create_model
    from diffspectra_tpu_torch.warm_state import flax_variables, init_variables

    config = variant_config(over)
    only_2d = bool(config.only_2D)
    dims = ["2d"] if only_2d else ["3d", "2d"]
    workdir = tempfile.mkdtemp(prefix=f"{config.model.name.lower()}_")
    total = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with LogLines() as log:
        state = run_lib.train(config, workdir, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add_launches(total, LAUNCHES)
    step_ms = log.step_ms()
    median = float(np.median(step_ms[1:])) if len(step_ms) > 1 else float("nan")
    timing = {"median_step_ms": median, "graphs_per_s": config.training.batch_size / median * 1e3,
              "max_memory_bytes": max(log.peaks), "step_ms": step_ms}
    say(f"[{tag}] train: run_lib.train of {over}: {len(log.losses)} steps from a fresh init and "
        f"a snapshot in {wall:.1f} s (the set's build included); step ms "
        f"{[round(t, 1) for t in step_ms]}, median after the first {median:.1f} ms "
        f"({timing['graphs_per_s']:.1f} graphs/s); max_memory_allocated "
        f"{max(log.peaks) / 2**30:.2f} GiB at the last step; losses "
        f"{[round(x, 4) for x in log.losses]}; launches {nonzero(dict(LAUNCHES)) or 'none'}; "
        f"{smi}")
    assert len(log.losses) == steps and all(math.isfinite(x) for x in log.losses)
    assert state.step == steps and not nonzero(dict(LAUNCHES))
    assert type(state.model).__name__ == config.model.name
    assert checkpoint.latest_numbered_checkpoint(workdir) == 1
    fresh = init_variables(create_model(config), config.seed)
    trained = flax_variables(state.model)
    ema = flax_variables(state.model, state.ema.shadow_params)
    moved = [sum(not np.array_equal(tree[k], fresh[k]) for k in fresh if k.startswith("params/"))
             for tree in (trained, ema)]
    say(f"[{tag}] train: leaves moved from the fresh init: params {moved[0]}, EMA {moved[1]} of "
        f"{sum(k.startswith('params/') for k in fresh)}")
    assert all(moved), moved
    last = steps - 1
    with open(os.path.join(workdir, "samples", f"iter_{last}.json")) as f:
        figures = json.load(f)
    files = {sub: sorted(os.listdir(os.path.join(workdir, "samples", sub)))
             for sub in (f"iter_{last}", f"iter_{last}_gt")}
    say(f"[{tag}] train: snapshot, {config.training.eval_samples} draws at "
        f"{config.sampling.steps} steps: {json.dumps(figures)}; xyz files "
        f"{ {k: len(v) for k, v in files.items()} }")
    assert [d.lower() for d in figures] == dims, figures
    assert files[f"iter_{last}_gt"] and bool(files[f"iter_{last}"]) != only_2d, files
    assert all(n.endswith(".xyz") for v in files.values() for n in v)
    assert all(math.isfinite(v) and 0 <= v <= 1 for d in figures.values() for v in d.values())

    el = Elucidator.from_workdir(workdir, config, device=dev)
    assert type(el.model).__name__ == config.model.name and el.model.dtype == torch.bfloat16
    data = generate(seed=11, size=1, max_n=29, fidelity=4)
    n = int(data["num_atom"][0])
    spectra = {k: data[k][0] for k in ("uv", "ir", "raman")}
    dpm_config = copy.deepcopy(config)
    dpm_config.sampling.method = "dpm_solver"
    timing["serve_s"] = {}
    for method, server in (("ancestral", el), ("dpm_solver", Elucidator(dpm_config, el.model, dev))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = server.elucidate(spectra, n_atoms=n, num_candidates=CANDIDATES, seed=0)
        torch.cuda.synchronize()
        timing["serve_s"][method] = serve_s = time.perf_counter() - t0
        add_launches(total, LAUNCHES)
        say(f"[{tag}] serve: from the workdir's checkpoint ({method}, {config.sampling.steps} "
            f"steps, n_atoms {n}, {CANDIDATES} candidates): {serve_s:.3f} s, "
            f"{len(result.candidates)} distinct, best frequency {result.best.frequency:.2f}; "
            f"launches {nonzero(dict(LAUNCHES)) or 'none'}; {smi}")
        assert sum(c.count for c in result.candidates) == CANDIDATES
        for c in result.candidates:
            assert c.molgraph.n_atoms == n and c.molgraph.bond_orders.shape == (n, n)
            if only_2d:
                assert c.positions is None and c.molgraph.positions is None
            else:
                assert np.isfinite(c.positions).all()
        assert not nonzero(dict(LAUNCHES))

    reset_launches()
    t0 = time.perf_counter()
    swept = run_lib.evaluate_checkpoints(config, workdir, "eval", dev)
    timing["sweep_s"] = time.perf_counter() - t0
    add_launches(total, LAUNCHES)
    fig = swept[1]
    numbers = {f"top1_{d}": fig[f"top1_{d}"] for d in dims}
    for d in dims:
        numbers.update({f"metric_{d} {k}": float(v) for k, v in fig[f"metric_{d}"].items()})
    say(f"[{tag}] sweep: evaluate_checkpoints over checkpoint 1 ({config.eval.num_samples} "
        f"targets, K={config.eval.num_candidates}, {config.sampling.steps} steps) in "
        f"{timing['sweep_s']:.1f} s: {json.dumps(numbers)}; launches "
        f"{nonzero(dict(LAUNCHES)) or 'none'}; {smi}")
    assert fig["targets"] == config.eval.num_samples and not nonzero(dict(LAUNCHES))
    assert all(math.isfinite(v) and 0 <= v <= 1 for v in numbers.values()), numbers
    if only_2d:
        assert not [k for k in fig if "3d" in k] and "Top-1 3D" not in fig["generalization"]
    shutil.rmtree(workdir)
    return timing, total


def specformer_bf16_serve(dev, smi):
    """Phase 11 (c): the flagship from WARM in bf16 with
    ``model.specformer_bf16``: one request at SPECFORMER_BF16_STEPS steps on
    each path, each path's bf16 kernels launched 8 x steps times and no
    other; the spectra embedding on cuda against the CPU's within
    SPECFORMER_BF16_RATIO of the CPU's own difference between SpecFormer in
    bf16 and in f32. Returns the launches by kernel."""
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator, load_model
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    data = generate(seed=7, size=B, max_n=29, fidelity=4)
    specs = [torch.from_numpy(np.log10(data[k] + 1.0).astype(np.float32)) for k in
             ("uv", "ir", "raman")]
    on = {"model.specformer_bf16": True, "sampling.steps": SPECFORMER_BF16_STEPS}
    cpu = {flag: load_model(WARM, configs.apply_overrides(configs.get_config(), {
        "model.specformer_bf16": flag}), "cpu") for flag in (True, False)}
    with torch.no_grad():
        want = {flag: m.encode_context(specs) for flag, m in cpu.items()}
    total = {}
    for path, ops in PATHS.items():
        el = Elucidator.from_warm_state(WARM, overrides={**on, "model.pallas_ops": ops},
                                        device=dev)
        assert el.model.cond_encoder.W_P_1.dtype == torch.bfloat16
        with torch.no_grad():
            got = el.model.encode_context([s.to(dev) for s in specs]).float().cpu()
        err = (got - want[True]).abs().max().item()
        gap = (want[True] - want[False]).abs().max().item()
        n = int(data["num_atom"][0])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = el.elucidate({k: data[k][0] for k in ("uv", "ir", "raman")}, n_atoms=n,
                              num_candidates=CANDIDATES, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        expected = el.config.model.n_layers * SPECFORMER_BF16_STEPS
        say(f"[specformer_bf16] {path}: spectra embedding max |cuda - cpu| = {err:.3e}, max "
            f"|cpu SpecFormer bf16 - cpu SpecFormer f32| = {gap:.3e}, ratio {err / gap:.4f} "
            f"(bound {SPECFORMER_BF16_RATIO}); one request ({SPECFORMER_BF16_STEPS} steps, "
            f"n_atoms {n}, {CANDIDATES} candidates) in {seconds:.3f} s, "
            f"{len(result.candidates)} distinct; launches {nonzero(launches)}, expected "
            f"{expected} for {kernels_of(path, 'bf16')}; {smi}")
        assert gap > 0 and err <= SPECFORMER_BF16_RATIO * gap, (path, err / gap)
        assert all(np.isfinite(c.positions).all() for c in result.candidates)
        launched_only(kernels_of(path, "bf16"), launches, expected)
        add_launches(total, launches)
    return total


def phase_wo_eq(dev, smi):
    """Phase 11: DMT_WO_EQ and ``model.specformer_bf16`` on the card.
    Returns the launches of its runs by kernel (DMT_WO_EQ's none)."""
    t0 = time.perf_counter()
    ratios, forward_ms, launches = {}, {}, {}
    for tv in WO_EQ_TRANS_VERS:
        r, forward_ms[tv], counts = held_forwards(
            dev, smi, f"wo_eq {tv}", {**WO_EQ, "model.trans_ver": tv}, wo_eq_inputs,
            ("pred", "edge_pred"))
        ratios.update({f"{tv} {k}": v for k, v in r.items()})
        add_launches(launches, counts)
    timing, counts = train_serve_sweep(dev, smi, "wo_eq", WO_EQ_TRAIN, WO_EQ_TRAIN_STEPS)
    add_launches(launches, counts)
    assert not nonzero(launches), launches
    torch.cuda.empty_cache()
    add_launches(launches, specformer_bf16_serve(dev, smi))
    seconds = time.perf_counter() - t0
    print(json.dumps({"wo_eq": {"bf16_ratios": ratios, "forward_ms": forward_ms, **timing,
                                "phase_s": seconds}}), flush=True)
    say(f"[wo_eq] phase 11 in {seconds:.1f} s; {smi}")
    return launches


def phase_cdgs(dev, smi):
    """Phase 12: CDGS and the 2-D path on the card. Returns the launches of
    its runs by kernel (none)."""
    t0 = time.perf_counter()
    ratios, forward_ms, launches = held_forwards(dev, smi, "cdgs", CDGS_PATH, cdgs_inputs,
                                                 ("atom", "bond"))
    timing, counts = train_serve_sweep(dev, smi, "cdgs", CDGS_TRAIN, CDGS_TRAIN_STEPS)
    add_launches(launches, counts)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(json.dumps({"cdgs": {"bf16_ratios": ratios, "forward_ms": forward_ms, **timing,
                               "phase_s": seconds}}), flush=True)
    say(f"[cdgs] phase 12 in {seconds:.1f} s; launches {nonzero(launches) or 'none'}; {smi}")
    assert not nonzero(launches), launches
    return launches


def eval_stack_sweep(dev, smi):
    """Phase 13 (a): the flagship eval through ``run_lib.evaluate`` with
    the original-QM9 reference sets, the sub-geometry MMDs and save_mols;
    its checks raise. Returns its launches and figures."""
    import logging

    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.data.pipeline import get_dataset
    from diffspectra_tpu_torch.evaluation import base_metrics, mose_metric, rmsd
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[eval-stack log] %(message)s", force=True)
    root = tempfile.mkdtemp(prefix="eval_stack_root_")  # the geometry statistics
    eval_dir = tempfile.mkdtemp(prefix="eval_stack_")
    config = configs.apply_overrides(configs.get_config(), {**EVAL_STACK, "data.root": root})
    original = configs.original_qm9_config(config)
    say(f"[eval-stack] (a) settings {json.dumps({**EVAL_STACK, 'data.root': root})}; reference "
        f"config: exp_type {original.exp_type}, data.info_name {original.data.info_name}")
    reset_launches()
    t0 = time.perf_counter()
    with LogLines() as lines:
        fig = run_lib.evaluate(config, WARM, eval_dir, dev, original)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    K, steps, rounds = config.eval.num_candidates, config.sampling.steps, fig["rounds"]
    expected = config.model.n_layers * steps * len(rounds) * K
    say(f"[eval-stack] (a) run_lib.evaluate in {wall:.1f} s, rounds {rounds}; launches "
        f"{nonzero(launches)}, expected {expected} for {kernels_of('block', 'bf16')} (8 blocks x "
        f"{steps} steps x {len(rounds)} rounds x {K} sweeps), 0 for the others; phase-time "
        f"{json.dumps(fig['phase_seconds'])}")
    launched_only(kernels_of("block", "bf16"), launches, expected)
    assert "metric reference sets: original-QM9 (--original-qm9)" in lines.messages
    assert fig["reference_sets"] == "original-QM9"

    # the moses figures; Frag and Scaf NaN exactly where both count vectors are empty
    _, _, _, ref_test, info = get_dataset(original, transform=False)
    ref = mose_metric._precalc(mose_metric._sanitize_graphs(run_lib._all_graphs(
        ref_test, info["atom_decoder"])))
    saved = fig["saved_mols"]
    mols = {}
    for name in ("sample_rdmols_3d", "complete_rdmols_2d", "groundtruth_rdmols"):
        with open(os.path.join(saved, f"{name}.pkl"), "rb") as f:
            mols[name] = pickle.load(f)
    gen = {"3d": mols["sample_rdmols_3d"], "2d": mols["complete_rdmols_2d"]}
    for dim in ("3d", "2d"):
        moses = fig[f"moses_{dim}"]
        say(f"[eval-stack] (a) moses {dim.upper()}: {json.dumps(moses)}")
        assert math.isnan(moses["FCD"]), moses
        assert math.isfinite(moses["FCD_proxy"]) and moses["FCD_proxy"] >= 0, moses
        if dim == "3d":
            continue
        pgen = mose_metric._precalc(mose_metric._sanitize_graphs(gen[dim]))
        for key in ("SNN", "IntDiv", "Filters"):
            assert 0 <= moses[key] <= 1, (key, moses)
        for key, counter in (("Frag", "frag"), ("Scaf", "scaf")):
            empty = not (set(pgen[counter]) | set(ref[counter]))
            assert math.isnan(moses[key]) == empty, (key, moses[key], empty)
            assert empty or 0 <= moses[key] <= 1, (key, moses)
        assert moses["weight"] > 0, moses
    geo = fig["geometry"]
    say(f"[eval-stack] (a) Metric-Align against the test split's statistics: bond length "
        f"{geo['bond_length_mean']:.4f}, bond angle {geo['bond_angle_mean']:.4f}, dihedral "
        f"{geo['dihedral_angle_mean']:.6f}; by symbol {json.dumps(geo)}")
    for key in ("bond_length_mean", "bond_angle_mean", "dihedral_angle_mean"):
        assert math.isfinite(geo[key]) and geo[key] >= 0, (key, geo[key])
    assert os.path.exists(os.path.join(root, "target_geometry_stat.pk"))

    # the saved molecules rescored offline: the sweep's own tables
    ckpt = os.path.splitext(os.path.basename(WARM))[0]
    tables = base_metrics.main(["--base_path", eval_dir, "--ckpt", ckpt])
    for dim in ("2d", "3d"):
        with open(os.path.join(eval_dir, "metrics_results", f"similarity_metrics_{dim}.csv"),
                  "rb") as a, open(os.path.join(
                      eval_dir, f"similarity_metrics_{dim}_ckpt_{ckpt}.csv"), "rb") as b:
            assert a.read() == b.read(), dim
    say(f"[eval-stack] (a) base_metrics on {saved}: 2D and 3D tables equal to the sweep's own: "
        f"{json.dumps(tables)}")
    rmsds, rate, mean, accuracy = rmsd.hungarian_rmsd_batch(mols["groundtruth_rdmols"],
                                                            mols["sample_rdmols_3d"])
    say(f"[eval-stack] (a) Hungarian RMSD of the 3D samples against their targets: mean {mean}, "
        f"success {rate:.4f}, atom-type accuracy {accuracy}; per target {rmsds}")
    assert mean is not None and math.isfinite(mean), rmsds
    shutil.rmtree(eval_dir)
    shutil.rmtree(root)
    return launches, {"wall_s": wall, "rounds": rounds, "phase_s": fig["phase_seconds"],
                      "moses_2d": fig["moses_2d"], "moses_3d": fig["moses_3d"], "geometry": geo,
                      "rmsd_mean": mean, "rmsd_success": rate}


def mmd_sums(dev, smi):
    """Phase 13 (b): the MMD's kernel sums on cuda against the float64 plain
    version at MMD_SIDE a side, then timed at MMD_CAP a side."""
    from diffspectra_tpu_torch.evaluation import mmd

    rng = np.random.default_rng(0)
    pairs = {  # bond lengths, and bond angles of another width (degrees)
        "identical": (rng.normal(1.09, 0.02, MMD_SIDE),) * 2,
        "shifted": (rng.normal(1.09, 0.02, MMD_SIDE), rng.normal(1.12, 0.02, MMD_SIDE)),
        "width": (rng.normal(109.5, 3.0, MMD_SIDE), rng.normal(109.5, 9.0, MMD_SIDE)),
    }
    out = {}
    for name, (source, target) in pairs.items():
        total = np.concatenate([source, target]).astype(np.float32)
        n, m = len(source), len(target)
        t0 = time.perf_counter()
        plain = mmd.kernel_sums_plain(total, n)
        plain_ms = (time.perf_counter() - t0) * 1e3
        on_card = torch.from_numpy(total).to(dev)
        got = mmd.kernel_sums(on_card, n)
        scale = np.array([n * n, m * m, n * m], dtype=np.float64)
        rel = np.abs(np.array(got) / scale - np.array(plain) / scale) / (np.array(plain) / scale)
        value, want = mmd.mmd_from_sums(*got, n, m), mmd.mmd_from_sums(*plain, n, m)
        bound = MMD_RTOL * (plain[0] / n**2 + plain[1] / m**2)
        ms = cuda_time_ms(lambda: mmd.kernel_sums(on_card, n), iters=20)
        out[name] = {"mmd": value, "plain_mmd": want, "rel_err": rel.tolist(), "ms": ms,
                     "plain_ms": plain_ms}
        say(f"[eval-stack] (b) {name}, {n} + {m}: MMD {value:.9f} on cuda, {want:.9f} float64 "
            f"plain (|diff| {abs(value - want):.3e}, bound {bound:.3e}); xx/n^2, yy/m^2, xy/nm "
            f"relative errors {rel.tolist()}; {ms:.3f} ms on cuda, plain {plain_ms:.1f} ms "
            f"(numpy on the host); {smi}")
        assert (rel <= MMD_RTOL).all() and abs(value - want) <= bound, out[name]
    total = torch.from_numpy(rng.normal(1.09, 0.02, 2 * MMD_CAP).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_time_ms(lambda: mmd.kernel_sums(total, MMD_CAP), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() - base
    # the least work: the bandwidth pass (3 operations a pair), the source
    # rows against every column and the target rows against the targets
    # (17 a pair: the square distance and five divides, exps and adds)
    n = 2 * MMD_CAP
    ops = 3 * n * n + 17 * (MMD_CAP * n + MMD_CAP * MMD_CAP)
    out["cap"] = {"samples": n, "ms": ms, "peak_bytes": peak, "bound_ms": ops / F32_PEAK * 1e3}
    say(f"[eval-stack] (b) the sums at the cap, {MMD_CAP} + {MMD_CAP} samples: {ms:.3f} ms "
        f"(CUDA events, 10 calls), peak {peak / 2**20:.1f} MiB over the input, row blocks of "
        f"{mmd.BLOCK_ELEMENTS // n} rows; bound {out['cap']['bound_ms']:.4f} ms ({ops:.3e} "
        f"operations at 67 TFLOP/s); {smi}")
    return out


def chemnet_forward(dev, smi):
    """Phase 13 (c): ChemNet (``random_chemnet``) on cuda against the CPU."""
    from diffspectra_tpu_torch.evaluation import chemnet

    rng = np.random.default_rng(0)
    toks = ["C", "N", "O", "F", "(", ")", "=", "#", "1", "2", "3", "Cl", "Br", "c", "n", "o",
            "[", "]", "+", "-", "H", "@", "Si"]
    smiles = ["".join(rng.choice(toks, size=rng.integers(1, 60)))
              for _ in range(CHEMNET_SMILES)]
    net = chemnet.random_chemnet(0)
    want = net.features(smiles, device="cpu")
    got = net.features(smiles, device=dev)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    ms = cuda_time_ms(lambda: net.features(smiles, device=dev), iters=10)
    say(f"[eval-stack] (c) ChemNet (random_chemnet, pad {net.pad_len}) on {len(smiles)} SMILES: "
        f"{got.shape}, max |cuda - cpu| {err:.3e} of max |activation| {scale:.4f} (bound "
        f"{CHEMNET_RTOL} of it); {ms:.3f} ms a call on cuda; {smi}")
    assert got.shape == want.shape and err <= CHEMNET_RTOL * scale, (err, scale)
    return {"max_abs_err": err, "max_abs": scale, "ms": ms}


def phase_eval_stack(dev, smi):
    """Phase 13: the rest of the eval stack on the card. Returns its
    launches by kernel."""
    t0 = time.perf_counter()
    launches, sweep = eval_stack_sweep(dev, smi)
    sums = mmd_sums(dev, smi)
    net = chemnet_forward(dev, smi)
    seconds = time.perf_counter() - t0
    print(json.dumps({"eval_stack": {"sweep": sweep, "mmd": sums, "chemnet": net,
                                     "phase_s": seconds}}), flush=True)
    say(f"[eval-stack] phase 13 in {seconds:.1f} s (budget 60 s); launches {nonzero(launches)}; "
        f"{smi}")
    return launches


def state_digests(state) -> list:
    """A digest of each tensor of a train state (the model's parameters and
    batch statistics, the optimizer state, the EMA), in one order."""
    import hashlib

    from diffspectra_tpu_torch.parallel.mesh import state_tensors

    return [hashlib.sha1(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
            .hexdigest() for t in state_tensors(state)]


def mesh_world_one(dev, smi):
    """Phase 14 (a): make_parallel_train_step at world size 1 over NCCL, in
    this process, against the one-device step from the same state and
    draws: losses and every tensor of the state equal bit for bit."""
    import torch.distributed as dist

    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.data.pipeline import collate, get_dataset
    from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
    from diffspectra_tpu_torch.parallel import Mesh, make_parallel_train_step
    from diffspectra_tpu_torch.training.losses import draw
    from diffspectra_tpu_torch.training.step import get_step_fn
    from diffspectra_tpu_torch.utils.scalers import get_data_scaler
    from diffspectra_tpu_torch.warm_state import warm_start

    config = train_config()
    _, train_ds, _, _, _ = get_dataset(config)
    batch = run_lib.batch_to_device(collate(train_ds.take(np.arange(128)),
                                            config.data.spectra_version), dev)
    gen, host = torch.Generator(device=dev).manual_seed(1), torch.Generator().manual_seed(2)
    draws = [draw(gen, host, batch, config.model.n_layers) for _ in range(MESH_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            runs = {}
            for tag, mesh in (("nccl", Mesh(0, 1, dev)), ("one device", None)):
                tx, state = run_lib.init_train_state(config, dev)
                state = warm_start(state, WARM)
                step_fn = get_step_fn(NoiseScheduleVP.from_config(config), tx,
                                      get_data_scaler(config), config, mesh=mesh)
                parallel = make_parallel_train_step(step_fn, mesh) if mesh else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = []
                for d in draws:
                    if parallel:
                        state, loss = parallel(state, batch, lambda shard, d=d: (shard, d))
                    else:
                        state, loss = step_fn(state, batch, d)
                    losses.append(loss.item())
                runs[tag] = (losses, state_digests(state), time.perf_counter() - t0)
                del state
        finally:
            dist.destroy_process_group()
    (l_a, d_a, s_a), (l_b, d_b, s_b) = runs["nccl"], runs["one device"]
    differ = [i for i, (a, b) in enumerate(zip(d_a, d_b)) if a != b]
    say(f"[mesh] (a) world size 1 over NCCL: {MESH_STEPS} steps of make_parallel_train_step, "
        f"batch 128, bf16, dropout {config.model.dropout}, from {os.path.basename(WARM)}: losses "
        f"{l_a}, the one-device step's {l_b}; {len(d_b)} state tensors, {len(differ)} differ "
        f"(indices {differ[:5]}); seconds {s_a:.2f} and {s_b:.2f}; {smi}")
    assert l_a == l_b and len(d_a) == len(d_b) and not differ
    assert all(math.isfinite(x) for x in l_a)
    return {"losses": l_a, "tensors": len(d_b), "seconds": [s_a, s_b]}


def mesh_rank(mesh, train_over, sweep_over, warm, smi):
    """Phase 14 (b) and (c) on one rank (spawned; module globals are this
    process's own, so every setting comes in the arguments). Returns its
    figures, timings and launches; its checks raise."""
    import logging

    import torch.distributed as dist

    from diffspectra_tpu_torch import checkpoint, configs, run_lib
    from diffspectra_tpu_torch.api import load_model
    from diffspectra_tpu_torch.ops import LAUNCHES, _lib, reset_launches
    from diffspectra_tpu_torch.warm_state import read_warm_state

    _lib.build()  # loads the parent's build
    dev = mesh.device
    out = {"rank": mesh.rank}
    # (b) run_lib.train; rank 0 logs its step lines at INFO, the others at DEBUG
    marks, losses, writes = [], [], {}

    class StepLines(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "training_loss" in msg:
                marks.append(time.perf_counter())
                losses.append(float(msg.split("training_loss: ")[1].split(",")[0]))

    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    root.addHandler(StepLines())
    for module, name in ((checkpoint, "save_checkpoint"), (run_lib, "export_warm_state"),
                         (run_lib, "visualize_mols")):
        def counted(*args, _fn=getattr(module, name), _name=name, **kwargs):
            writes[_name] = writes.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(module, name, counted)
    warm_step = read_warm_state(warm)["step"]
    last = warm_step + MESH_TRAIN_STEPS - 1
    config = configs.apply_overrides(configs.get_config(), {
        **train_over, "training.n_iters": last, "training.snapshot_freq": 10**9})
    workdir = os.path.join(tempfile.gettempdir(), "chip_smoke_mesh_train")  # the ranks' shared one
    if mesh.rank == 0:
        shutil.rmtree(workdir, ignore_errors=True)
    dist.barrier()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = run_lib.train(config, workdir, dev)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = dict(LAUNCHES)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    out.update(losses=losses, step_ms=step_ms, median_ms=float(np.median(step_ms[1:])),
               peak_bytes=torch.cuda.max_memory_allocated(), writes=writes,
               files=sorted(os.listdir(workdir)),
               checkpoints=sorted(os.listdir(os.path.join(workdir, "checkpoints"))))
    out["graphs_per_s"] = config.training.batch_size / out["median_ms"] * 1e3
    digests = [None] * mesh.world
    dist.all_gather_object(digests, state_digests(state))
    out["digests_equal"] = all(d == digests[0] for d in digests)
    out["tensors"] = len(digests[0])
    with open(os.path.join(workdir, "samples", f"iter_{last}.json")) as f:
        out["snapshot"] = json.load(f)
    del state
    dist.barrier()  # every rank has read the workdir
    if mesh.rank == 0:
        shutil.rmtree(workdir)
    out["f32"] = mesh_f32_step(mesh, train_over, warm)
    # (c) the sweep fanned out over the ranks
    config = configs.apply_overrides(configs.get_config(), sweep_over)
    eval_dir = tempfile.mkdtemp(prefix=f"mesh_eval_{mesh.rank}_")
    sweeps = []
    make = run_lib.make_cond_sampling_fn

    def recorded(*args, **kwargs):
        fn = make(*args, **kwargs)

        def sampling_fn(generator):
            result = fn(generator)
            sampling_fn.round_seconds = fn.round_seconds
            sweeps.append(result[0])
            return result

        sampling_fn.rounds = fn.rounds
        return sampling_fn

    run_lib.make_cond_sampling_fn = recorded
    reset_launches()
    t0 = time.perf_counter()
    fig = run_lib.evaluate(config, warm, eval_dir, dev)
    out["sweep_s"] = time.perf_counter() - t0
    out["sweep_launches"] = dict(LAUNCHES)
    shutil.rmtree(eval_dir)
    out["figures"] = sweep_figures(fig, config.eval.num_candidates)
    out["decoded"] = [sw["decoded"] for sw in fig["sweeps"]]
    out["rounds"] = fig["rounds"]
    out["targets"] = fig["targets"]
    shared = json.dumps({k: v for k, v in fig.items() if k not in ("sweeps", "phase_seconds")},
                        sort_keys=True)
    everyone = [None] * mesh.world
    dist.all_gather_object(everyone, shared)
    out["figures_equal"] = all(f == shared for f in everyone)
    # this rank's rows of each round, sampled in one process with its generator
    out["emulated_equal"] = mesh_sweep_emulation(mesh, config, warm, sweeps, load_model)
    return out


def mesh_f32_step(mesh, train_over, warm):
    """Phase 14 (b): one f32 step at dropout 0 over the ranks, each on its
    MESH_CHECK_BATCH rows with its own draws; rank 0 also takes the step in
    one process, both shards' gradients averaged, and returns the largest
    |difference| of each parameter over its largest |value|."""
    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.data.pipeline import collate, get_dataset
    from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
    from diffspectra_tpu_torch.models import ema as ema_lib
    from diffspectra_tpu_torch.models.layers import refresh_casts
    from diffspectra_tpu_torch.parallel import make_parallel_train_step, rank_seed, shard_batch
    from diffspectra_tpu_torch.training.losses import draw
    from diffspectra_tpu_torch.training.step import batch_stats_of, get_step_fn, make_loss_fn
    from diffspectra_tpu_torch.training.train_state import params_of
    from diffspectra_tpu_torch.utils.scalers import get_data_scaler
    from diffspectra_tpu_torch.warm_state import warm_start

    dev = mesh.device
    config = configs.apply_overrides(configs.get_config(), {
        **train_over, "training.matmul_precision": "float32", "model.dropout": 0.0})
    _, train_ds, _, _, _ = get_dataset(config)
    rows = MESH_CHECK_BATCH * mesh.world
    batch = run_lib.batch_to_device(collate(train_ds.take(np.arange(rows)),
                                            config.data.spectra_version), dev)
    shards = [shard_batch(batch, r, mesh.world) for r in range(mesh.world)]

    def draws_of(r):
        seed = rank_seed(config.seed, r)
        return draw(torch.Generator(device=dev).manual_seed(seed),
                    torch.Generator().manual_seed(seed), shards[r], config.model.n_layers)

    scheduler, scaler = NoiseScheduleVP.from_config(config), get_data_scaler(config)
    tx, state = run_lib.init_train_state(config, dev)
    state = warm_start(state, warm)
    one = copy.deepcopy(state) if mesh.rank == 0 else None  # the one-process emulation's
    step = make_parallel_train_step(get_step_fn(scheduler, tx, scaler, config, mesh=mesh), mesh)
    own = draws_of(mesh.rank)
    state, loss = step(state, batch, lambda shard: (shard, own))
    if mesh.rank != 0:
        return None
    # one process: each shard's gradient and batch statistics, averaged, one update
    model = one.model.train()
    params = params_of(model)
    stats = batch_stats_of(model)
    start = [b.clone() for b in stats]
    loss_fn = make_loss_fn(scheduler, scaler, config)
    grads, moved = [], []
    for r in range(mesh.world):
        with torch.no_grad():
            for b, s0 in zip(stats, start):
                b.copy_(s0)
        g = torch.autograd.grad(loss_fn(model, shards[r], draws_of(r)), list(params.values()),
                                allow_unused=True)
        grads.append([torch.zeros_like(p) if x is None else x for p, x in zip(params.values(), g)])
        moved.append([b.clone() for b in stats])
    with torch.no_grad():
        for b, *per in zip(stats, *moved):
            b.copy_(sum(per) / mesh.world)
    mean = {k: sum(gs) / mesh.world for k, *gs in zip(params, *grads)}
    one.opt_state = tx.update(mean, one.opt_state, params)
    refresh_casts(model)
    one.ema = ema_lib.update(one.ema, params)
    worst, name = 0.0, ""
    got = dict(state.model.named_parameters())
    for k, want in params.items():
        scale = want.detach().abs().max().item()
        err = (got[k].detach() - want.detach()).abs().max().item()
        if scale and err / scale > worst:
            worst, name = err / scale, k
    return {"loss": loss.item(), "worst": worst, "worst_param": name, "params": len(params)}


def mesh_sweep_emulation(mesh, config, warm, sweeps, load_model):
    """Rank ``mesh.rank``'s draws of each sweep against one process's
    ``sample_round`` of its rows of each round with its own generator (the
    caller's seed and the rank), on the same card."""
    from diffspectra_tpu_torch.data.pipeline import SPECTRA_KEYS, get_dataset
    from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
    from diffspectra_tpu_torch.parallel import rank_seed
    from diffspectra_tpu_torch.sampling.decode import mol_process
    from diffspectra_tpu_torch.sampling.harness import (
        bucket_sizes_of, make_sampler, plan_rounds, sample_round, sampling_world)
    from diffspectra_tpu_torch.utils.scalers import get_data_inverse_scaler

    dev = mesh.device
    model = load_model(warm, config, dev)
    test_ds = get_dataset(config)[3]
    world, batch = sampling_world(mesh.world, config.eval.batch_size)
    drawn, rounds = plan_rounds(test_ds, config.eval.num_samples, batch, bucket_sizes_of(config))
    sampler = make_sampler(config, NoiseScheduleVP.from_config(config))
    inverse = get_data_inverse_scaler(config)
    generator = torch.Generator(device=dev).manual_seed(rank_seed(config.seed, mesh.rank))
    per = batch // world
    checked = 0
    for sweep in sweeps:
        for sel, n_pad in rounds:
            mine = sel[mesh.rank * per:(mesh.rank + 1) * per]
            data = test_ds.take(drawn[mine])
            specs = [torch.from_numpy(data[k]).to(dev)
                     for k in SPECTRA_KEYS[config.data.spectra_version]]
            pos, one_hot, fc, edges = sample_round(
                model, sampler, config, inverse, specs,
                torch.from_numpy(data["num_atom"]).to(dev), n_pad, generator)
            for dst, mol in zip(mine, mol_process(one_hot, pos, fc, data["num_atom"], edges)):
                if dst < len(sweep):
                    assert all(np.array_equal(a, b) for a, b in zip(sweep[dst], mol)), dst
                    checked += 1
    return checked


def phase_mesh(dev, smi):
    """Phase 14: data parallelism over torch.distributed. Returns the
    kernels' launches on the spawned ranks, summed."""
    from diffspectra_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    world_one = mesh_world_one(dev, smi)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    say(f"[mesh] (b, c) spawning {MESH_RANKS} ranks over gloo on {dev} (time limit "
        f"{MESH_RANK_TIMEOUT} s)")
    t1 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, MESH_RANKS, "cuda:0", MESH_RANK_TIMEOUT,
                        args=(MESH_TRAIN, MESH_SWEEP, WARM, smi), backend="gloo", threads=4)
    spawned = time.perf_counter() - t1
    per_rank = MESH_TRAIN["training.eval_batch_size"] // MESH_RANKS
    rounds = math.ceil(MESH_TRAIN["training.eval_samples"] / MESH_TRAIN["training.eval_batch_size"])
    launches = {}
    for r in ranks:
        train_expected = 8 * MESH_TRAIN["sampling.steps"] * rounds
        say(f"[mesh] (b) rank {r['rank']}: run_lib.train {MESH_TRAIN_STEPS} steps, global batch "
            f"{MESH_TRAIN['training.batch_size']} ({MESH_TRAIN['training.batch_size'] // MESH_RANKS}"
            f" a rank), buckets {MESH_TRAIN['data.bucket_sizes']}, bf16, dropout 0.1, in "
            f"{r['train_s']:.1f} s; losses {r['losses']}; step ms "
            f"{[round(t, 1) for t in r['step_ms']]}, median {r['median_ms']:.1f} ms "
            f"({r['graphs_per_s']:.1f} graphs/s, global batch; gloo copies through the host); "
            f"max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB; writes {r['writes']}; "
            f"files {r['files']}, checkpoints {r['checkpoints']}; snapshot of "
            f"{MESH_TRAIN['training.eval_samples']} draws ({per_rank} a rank): "
            f"{json.dumps(r['snapshot'])}; launches {nonzero(r['train_launches'])}, expected "
            f"{train_expected} for {kernels_of('attn_equi', 'bf16')}; {smi}")
        assert len(r["losses"]) == MESH_TRAIN_STEPS and all(map(math.isfinite, r["losses"]))
        assert r["losses"] == ranks[0]["losses"] and r["digests_equal"], r["rank"]
        launched_only(kernels_of("attn_equi", "bf16"), r["train_launches"], train_expected)
        assert r["writes"] == ({"save_checkpoint": 1, "export_warm_state": 1,
                                "visualize_mols": 2} if r["rank"] == 0 else {}), r["writes"]
        assert "warm_state.npz" in r["files"] and r["checkpoints"] == ["checkpoint_0"], r
        for dim in r["snapshot"].values():
            assert all(math.isfinite(v) and 0 <= v <= 1 for v in dim.values()), r["snapshot"]
        K, steps = MESH_SWEEP["eval.num_candidates"], MESH_SWEEP["sampling.steps"]
        sweep_expected = 8 * steps * len(r["rounds"]) * K
        say(f"[mesh] (c) rank {r['rank']}: run_lib.evaluate over {MESH_RANKS} ranks, "
            f"{r['targets']} targets, K={K}, {steps} steps, block path bf16, in "
            f"{r['sweep_s']:.1f} s; rounds {r['rounds']}; decoded {r['decoded']}; launches "
            f"{nonzero(r['sweep_launches'])}, expected {sweep_expected} for "
            f"{kernels_of('block', 'bf16')}; figures equal on every rank {r['figures_equal']}; "
            f"{r['emulated_equal']} draws equal to one process's sample_round of its rows; "
            f"figures {json.dumps(r['figures'])}")
        launched_only(kernels_of("block", "bf16"), r["sweep_launches"], sweep_expected)
        assert r["decoded"] == [r["targets"]] * K and r["figures_equal"]
        assert r["emulated_equal"] == K * r["targets"] // MESH_RANKS, r["emulated_equal"]
        assert json.dumps(r["figures"]) == json.dumps(ranks[0]["figures"])  # NaN equal to NaN
        for name, value in r["figures"].items():
            if "MACCS" in name or "Fraggle" in name:
                assert math.isnan(value), (name, value)
            elif "MCES" in name:
                assert math.isfinite(value) and value >= 0, (name, value)
            else:
                assert math.isfinite(value) and 0 <= value <= 1, (name, value)
        add_launches(launches, r["train_launches"])
        add_launches(launches, r["sweep_launches"])
    f32 = ranks[0]["f32"]
    say(f"[mesh] (b) one f32 step at dropout 0 over {MESH_RANKS} ranks ({MESH_CHECK_BATCH} rows "
        f"a rank) against one process averaging both shards' gradients: loss {f32['loss']:.6f}; "
        f"the largest |difference| of a parameter over its largest |value| {f32['worst']:.3e} "
        f"({f32['worst_param']}) over {f32['params']} parameters (bound {MESH_F32_RTOL})")
    assert f32["worst"] <= MESH_F32_RTOL, f32
    seconds = time.perf_counter() - t0
    print(json.dumps({"mesh": {"world_one": world_one, "ranks": [
        {k: r[k] for k in ("rank", "losses", "median_ms", "graphs_per_s", "peak_bytes",
                           "train_s", "sweep_s", "figures")} for r in ranks],
        "f32": f32, "spawned_s": spawned, "phase_s": seconds}}), flush=True)
    say(f"[mesh] phase 14 in {seconds:.1f} s (budget {MESH_BUDGET_S} s; the spawned ranks "
        f"{spawned:.1f} s); launches on the ranks {nonzero(launches)}; {smi}")
    return launches


def counted_rounds():
    """A list that ``Elucidator._round`` appends each round's ``(rows,
    n_pad)`` to, and the function that puts the plain ``_round`` back."""
    from diffspectra_tpu_torch.api import Elucidator

    plain, rounds = Elucidator._round, []

    def counted(self, contexts, n_atoms, n_pad, generator):
        rounds.append((len(contexts), n_pad))
        return plain(self, contexts, n_atoms, n_pad, generator)

    Elucidator._round = counted
    return rounds, lambda: setattr(Elucidator, "_round", plain)


def nfree_head(dev, smi):
    """Phase 15 (a): a count head trained on the sweep's set through WARM's
    SpecFormer, saved and reloaded through ``Elucidator.load_count_head``."""
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.pipeline import SPECTRA_KEYS, _conditional_splits
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.models import atom_count
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.tools import train_atom_count as tac

    el = Elucidator.from_warm_state(WARM, device=dev)
    size, fidelity = SWEEP["data.synthetic_size"], SWEEP["data.synthetic_fidelity"]
    raw = generate(seed=42, size=size, max_n=29, fidelity=fidelity, cache_dir=SYNTH_CACHE)
    first, second, _val, test = _conditional_splits(np.random.default_rng(42), size)
    train, labels = np.concatenate([first, second]), np.asarray(raw["num_atom"], np.int64)
    keys = SPECTRA_KEYS[el.config.data.spectra_version]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_train, x_test = (tac.embed_all(el, raw, rows, keys) for rows in (train, test))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    head, losses = tac.train_head(x_train, labels[train], NFREE_HEAD_EPOCHS, bs=NFREE_HEAD_BS,
                                  device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    m = tac.held_out_metrics(tac.predict_probs(head, x_test), labels[test])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.npz")
        atom_count.save_head(path, head, meta={"spectra": el.config.data.spectra_version,
                                               "test_top1": m["top1"]})
        meta = el.load_count_head(path)
    saved, loaded = head.state_dict(), el._count_head.state_dict()
    equal = saved.keys() == loaded.keys() and all(torch.equal(loaded[k], v)
                                                  for k, v in saved.items())
    steps = NFREE_HEAD_EPOCHS * (len(train) // NFREE_HEAD_BS)
    say(f"[n-free] (a) count head on WARM's SpecFormer ({el.config.data.spectra_version}, "
        f"{x_train.shape[1]} wide): {len(train)} train + {len(test)} test spectra of "
        f"generate(seed=42, size={size}, fidelity={fidelity}) embedded in {t1 - t0:.2f} s; "
        f"train_head {NFREE_HEAD_EPOCHS} epochs at batch {NFREE_HEAD_BS} ({steps} steps) in "
        f"{t2 - t1:.2f} s, epoch losses {[round(v, 4) for v in losses]}; held-out "
        f"{json.dumps(m)}; saved and reloaded through load_count_head: every tensor equal "
        f"{equal}; launches {nonzero(LAUNCHES)}; {smi}")
    assert equal and meta["test_top1"] == m["top1"] and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0] and not nonzero(LAUNCHES)
    return {"embed_s": t1 - t0, "train_s": t2 - t1, "losses": losses, **m}


def nfree_protocols(dev, smi):
    """Phase 15 (b): tools/nfree_eval.py's protocols A, B and C with the
    committed head; the bf16 per-op kernels launched 8 x steps a round."""
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.tools import nfree_eval

    # the set is cached with the run's others, not in the checkout
    cache, nfree_eval.SYNTH_CACHE = nfree_eval.SYNTH_CACHE, SYNTH_CACHE
    rounds, restore = counted_rounds()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = [str(a) for kv in NFREE_EVAL.items() for a in kv]
            results = nfree_eval.main(argv + [
                "--warm-state", WARM_IR, "--size", str(NFREE_SIZE), "--fidelity",
                str(NFREE_FIDELITY), "--count-head", HEAD, "--out", os.path.join(tmp, "nfree.json")])
    finally:
        restore()
        nfree_eval.SYNTH_CACHE = cache
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    nt, steps = NFREE_EVAL["--nt"], NFREE_EVAL["--steps"]
    for key in ("n_known", "n_free", "n_free_head"):
        entry = results[key]
        say(f"[n-free] (b) {key}: {json.dumps(entry)}")
        assert entry["aggregate"]["n"] == nt and entry["wall_s"] > 0
        for col in ("aggregate", "unseen", "seen"):
            assert all(0.0 <= entry[col][f] <= 1.0 for f in ("top1", "in_list")), entry
    expected = 8 * steps * len(rounds)
    say(f"[n-free] (b) nfree_eval at {nt} targets, {steps} steps, K_KNOWN "
        f"{NFREE_EVAL['--k-known']}, K_PER_N {NFREE_EVAL['--k-per-n']}: wall A "
        f"{results['n_known']['wall_s']:.2f} s, B {results['n_free']['wall_s']:.2f} s, C "
        f"{results['n_free_head']['wall_s']:.2f} s, all {wall:.2f} s; plausible counts "
        f"{results['plausible_counts']}; {len(rounds)} rounds (rows, n_pad) {rounds}; launches "
        f"{nonzero(launches)}, expected {expected} for {kernels_of('attn_equi', 'bf16')}; {smi}")
    assert results["n_free"]["draws_per_query"] == len(results["plausible_counts"])
    launched_only(kernels_of("attn_equi", "bf16"), launches, expected)
    return launches, {"wall_s": wall, **{k: results[k]["wall_s"]
                                         for k in ("n_known", "n_free", "n_free_head")}}


def nfree_demo(dev, smi, known_n):
    """Phase 15 (c): the demo on one target, its printed lines checked."""
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches
    from diffspectra_tpu_torch.tools import elucidate_demo

    rounds, restore = counted_rounds()
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = elucidate_demo.main(["--warm-state", WARM_IR, "--targets", "1", "--steps",
                                      str(DEMO_STEPS)] + (["--known-n"] if known_n else []))
    finally:
        restore()
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        say(f"[n-free] (c) {line}")
    draws = sum(int(line.split()[1][1:]) for line in lines if line.startswith("  #"))
    want = 10 if known_n else 2 * len(rounds)  # max(2, 10 // 4) a plausible count
    launches = dict(LAUNCHES)
    say(f"[n-free] (c) demo, {'known' if known_n else 'unknown'} atom count: {wall:.2f} s, "
        f"{len(rounds)} rounds at n_pad {sorted({p for _, p in rounds})}, {draws} draws; "
        f"launches {nonzero(launches)}; {smi}")
    assert rc == 0 and draws == want and lines[-1] in ("consensus Top-1: 0/1",
                                                       "consensus Top-1: 1/1")
    assert len(rounds) == (1 if known_n else 12) and {p for _, p in rounds} == {29}
    launched_only(kernels_of("attn_equi", "bf16"), launches, 8 * DEMO_STEPS * len(rounds))
    return launches, wall


def phase_nfree(dev, smi):
    """Phase 15: atom-count-free elucidation, (a) to (c); the per-op bf16
    kernels' launches of (b) and (c), summed."""
    t0 = time.perf_counter()
    head = nfree_head(dev, smi)
    launches, walls = nfree_protocols(dev, smi)
    for known_n in (True, False):
        counts, walls[f"demo_{'known' if known_n else 'free'}_s"] = nfree_demo(dev, smi, known_n)
        add_launches(launches, counts)
    seconds = time.perf_counter() - t0
    print(json.dumps({"nfree": {"head": head, **walls, "phase_s": seconds}}), flush=True)
    say(f"[n-free] phase 15 in {seconds:.1f} s (budget {NFREE_BUDGET_S} s); launches "
        f"{nonzero(launches)}; {smi}")
    return launches


def tool_log():
    """The root logger back on stdout after an entry point that set its
    own (``main.py`` logs to its workdir too)."""
    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="[tools log] %(message)s",
                        force=True)


def eval_scores(figures):
    """An eval's figures without its clock readings, as sorted JSON."""
    kept = {k: v for k, v in figures.items() if k != "phase_seconds"}
    kept["sweeps"] = [s["decoded"] for s in figures["sweeps"]]
    return json.dumps(kept, sort_keys=True)


def counted_eval(argv):
    """``main.main(argv)`` (an eval) in this process: its figures, its
    launches and seconds."""
    from diffspectra_tpu_torch import main as cli
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    try:
        figures = cli.main(argv)
    finally:
        tool_log()
    torch.cuda.synchronize()
    return figures, dict(LAUNCHES), time.perf_counter() - t0


def real_data_run(dev, smi, tmp, clocks):
    """Phase 16 (a), (b): the rehearsal file, the script, and its eval again
    in this process for the launches. Returns the workdir, the script's
    figures and the launches."""
    from diffspectra_tpu_torch.tools import make_rehearsal_pt

    root, workdir = os.path.join(tmp, "rehearsal"), os.path.join(tmp, "run")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        splits = make_rehearsal_pt.main(["--size", str(REHEARSAL_SIZE), "--root", root])
    clocks["a"] = time.perf_counter() - t0
    say(f"[tools] (a) {out.getvalue().strip()} in {clocks['a']:.1f} s")
    assert [len(x) for x in splits] == [192, 192, 64, 64]

    torch.cuda.empty_cache()  # the script's processes share the card with this one
    env = dict(os.environ, PYTHON=sys.executable, WORKDIR=workdir, DATA_ROOT=root,
               EVAL_CKPT="1", TRAIN_FLAGS=" ".join(f"--config {c}" for c in REAL_DATA_TRAIN),
               EVAL_FLAGS=" ".join(f"--config {c}" for c in REAL_DATA_EVAL))
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", os.path.join(ROOT, "diffspectra_tpu_torch", "scripts",
                                                "real_data.sh")],
                          cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=REAL_DATA_TIMEOUT)
    clocks["b_script"] = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(workdir, "stdout.txt")) as f:
        losses = [float(line.split("training_loss: ")[1].split(",")[0])
                  for line in f if "training_loss" in line]
    with open(os.path.join(workdir, "eval", "figures_ckpt_1.json")) as f:
        script = json.load(f)
    numbers = [script["top1_2d"], script["top1_3d"], *script["metric_2d"].values(),
               *script["metric_3d"].values()]
    say(f"[tools] (b) real_data.sh (train {REAL_DATA_TRAIN}, eval {REAL_DATA_EVAL}, EVAL_CKPT=1) "
        f"in {clocks['b_script']:.1f} s: losses {[round(x, 4) for x in losses]}; figures "
        f"Top-1 2D {script['top1_2d']:.4f}, 3D {script['top1_3d']:.4f}, 2D "
        f"{json.dumps(script['metric_2d'])}, 3D {json.dumps(script['metric_3d'])}, rounds "
        f"{script['rounds']}; the eval's phase-time {json.dumps(script['phase_seconds'])}; {smi}")
    assert len(losses) == 9 and all(map(math.isfinite, losses)), losses
    assert os.path.exists(os.path.join(workdir, "warm_state.npz"))
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in numbers), script
    assert script["sweeps"][0]["decoded"] == 8

    items = ["data.synthetic=false", f"data.root={root}", "eval.ckpts=1",
             "eval.num_candidates=10", *REAL_DATA_EVAL]
    figures, launches, clocks["b_again"] = counted_eval(
        ["--mode", "eval", "--workdir", workdir] + [a for c in items for a in ("--config", c)])
    expected = 8 * 100 * len(figures[1]["rounds"])
    say(f"[tools] (b) the script's eval again in this process (main.main) in "
        f"{clocks['b_again']:.1f} s: its figures equal the script's "
        f"{eval_scores(figures[1]) == eval_scores(script)}; launches {nonzero(launches)}, "
        f"expected {expected} for {kernels_of('attn_equi', 'bf16')}; {smi}")
    launched_only(kernels_of("attn_equi", "bf16"), launches, expected)
    return root, workdir, script, launches


def phase_tools(dev, smi):
    """Phase 16: the repository's last tools through the port's command
    line, (a) to (e); the per-op bf16 kernels' launches of (b) and (d)."""
    from diffspectra_tpu_torch.api import restore_model
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.tools import export_warm_state, gt_mmd_anchor, warm_to_ckpt
    from diffspectra_tpu_torch.warm_state import flax_variables, read_warm_state

    t_phase = time.perf_counter()
    clocks = {}
    tmp = tempfile.mkdtemp(prefix="tools_")
    root, workdir, script, launches = real_data_run(dev, smi, tmp, clocks)

    # (c) the workdir's checkpoint exported, against the train's own export
    out = os.path.join(tmp, "exported.npz")
    spectra = ["--config", "data.spectra_version=allspectra"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = export_warm_state.main(["--workdir", workdir, "--out", out, *spectra])
    tool_log()
    clocks["c"] = time.perf_counter() - t0
    with np.load(out) as got, np.load(os.path.join(workdir, "warm_state.npz")) as want:
        keys = sorted(set(want.files) - {"__meta__"})
        same_keys = set(got.files) == set(want.files)
        err = max(float(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max())
                  for k in keys)
    say(f"[tools] (c) export_warm_state in {clocks['c']:.1f} s: "
        f"{printed.getvalue().strip().splitlines()[0]}; {len(keys)} arrays against the train's "
        f"own export, max |diff| {err}; {smi}")
    assert rc == 0 and same_keys and err == 0.0

    # (d) written back as a checkpoint and evaluated through main.py
    back = os.path.join(tmp, "back")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = warm_to_ckpt.main(["--warm", out, "--workdir", back, "--ckpt", "1", *spectra])
    tool_log()
    config = configs.apply_overrides(configs.get_config(), {"data.spectra_version": "allspectra"})
    model, step = restore_model(back, config, dev, ckpt=1)
    ema, got = read_warm_state(out)["ema"], flax_variables(model)
    ema_err = max(float(np.abs(got[k] - v).max()) for k, v in ema.items())
    del model
    clocks["d_write"] = time.perf_counter() - t0
    items = ["data.synthetic=false", f"data.root={root}", "eval.ckpts=1", *REAL_DATA_EVAL]
    argv = [a for c in items for a in ("--config", c)]
    by_ckpt, counts, clocks["d_eval"] = counted_eval(["--mode", "eval", "--workdir", back] + argv)
    add_launches(launches, counts)
    expected = 8 * 100 * len(by_ckpt[1]["rounds"])
    launched_only(kernels_of("attn_equi", "bf16"), counts, expected)
    by_warm, counts, clocks["d_warm_eval"] = counted_eval(
        ["--mode", "eval", "--workdir", os.path.join(tmp, "warm_eval"), "--warm-start", out]
        + argv)
    add_launches(launches, counts)
    launched_only(kernels_of("attn_equi", "bf16"), counts, expected)
    say(f"[tools] (d) warm_to_ckpt: {printed.getvalue().strip()}, {len(ema)} EMA tensors "
        f"restored from checkpoint_1 against the npz's: max |diff| {ema_err} ({clocks['d_write']:.1f}"
        f" s); main.py --mode eval on it in {clocks['d_eval']:.1f} s, --warm-start on the npz in "
        f"{clocks['d_warm_eval']:.1f} s: figures equal {eval_scores(by_ckpt[1]) == eval_scores(by_warm)}"
        f"; equal to (b)'s (its f32 weights, not the npz's bf16) "
        f"{eval_scores(by_ckpt[1]) == eval_scores(script)}: Top-1 2D {by_ckpt[1]['top1_2d']:.4f}, "
        f"3D {by_ckpt[1]['top1_3d']:.4f}, 2D {json.dumps(by_ckpt[1]['metric_2d'])}; launches "
        f"{expected} a kernel each; {smi}")
    assert rc == 0 and step == read_warm_state(out)["step"] == 9 and ema_err == 0.0
    assert eval_scores(by_ckpt[1]) == eval_scores(by_warm)

    # (e) the geometry-MMD floor on cuda against the CPU
    anchors = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            anchors[device] = gt_mmd_anchor.main(ANCHOR + ["--cache-dir", SYNTH_CACHE,
                                                           "--device", device])
        tool_log()
        clocks[f"e_{device}"] = time.perf_counter() - t0
    worst = max(abs(anchors["cuda"][a][k] - v) / max(1.0, abs(v))
                for a in ("gt_vs_test_stats", "gt_vs_train_stats")
                for k, v in anchors["cpu"][a].items())
    say(f"[tools] (e) gt_mmd_anchor {' '.join(ANCHOR)}: cuda {json.dumps(anchors['cuda'])} in "
        f"{clocks['e_cuda']:.1f} s, cpu {json.dumps(anchors['cpu'])} in {clocks['e_cpu']:.1f} s; "
        f"the largest difference over max(1, |cpu|) {worst:.3g} (bound {ANCHOR_TOL}); {smi}")
    # at 512 molecules the test split holds 51, so the 64 draws are all of
    # it and the test-pool floor is 0 up to float32 rounding (either sign)
    assert worst <= ANCHOR_TOL and all(math.isfinite(v) for a in anchors.values()
                                       for stats in ("gt_vs_test_stats", "gt_vs_train_stats")
                                       for v in a[stats].values())
    shutil.rmtree(tmp)
    seconds = time.perf_counter() - t_phase
    for key, value in clocks.items():
        say(f"[clock] phase 16 ({key}) {value:.1f} s; {smi}")
    print(json.dumps({"tools": {"clocks": clocks, "anchor": anchors["cuda"], "phase_s": seconds}}),
          flush=True)
    say(f"[tools] phase 16 in {seconds:.1f} s (budget {TOOLS_BUDGET_S} s); launches "
        f"{nonzero(launches)}; {smi}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    atexit.register(shutil.rmtree, SYNTH_CACHE, True)  # the cached sets, however the run ends
    from diffspectra_tpu_torch.ops import _lib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' and yardsticks' bf16 products sum in f32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    shutil.rmtree(_lib.BUILD_DIR, ignore_errors=True)  # build from the sources, not a cache
    _lib.build()
    say(f"[build] nvcc built {_lib.library_path().name} in {time.perf_counter() - t0:.2f} s")
    kernel = "?"
    for line in _lib.build_log.splitlines():  # ptxas -v: registers and spills by kernel
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            say(f"[build] {kernel}: {line.strip()}")

    started = time.perf_counter()

    def clock(done):  # the script's own seconds at the end of each phase
        say(f"[clock] {done} done at {time.perf_counter() - started:.1f} s")

    rows = phase_kernels(dev)
    clock("phase 3")
    probe_rows = phase_probes(dev)
    clock("phase 3b")
    models = phase_forward(dev)
    clock("phase 4")
    from diffspectra_tpu_torch.data.synthetic import generate

    data = generate(seed=7, size=REQUESTS, max_n=29, fidelity=4)
    launches, serving = {}, {}
    for dt, path in itertools.product(("f32", "bf16"), PATHS):  # bf16 block last
        el, counts = serve_path(path, dt, dev, data)
        launches.update({k: counts[k] for k in kernels_of(path, dt)})
        serving.update({k: serving.get(k, 0) + counts[k] for k in counts})
    serve_more(el, dev, data, generate(seed=9, size=8, max_n=29, fidelity=4))
    clock("phase 5")
    for (path, dt), model in models.items():
        phase_profile(f"{path} {dt}", model, dev)
    clock("phase 6")
    sweeps = {dt: phase_sweep(dev, dt) for dt in ("bf16", "f32")}
    compare_sweeps(sweeps)
    clock("phase 7")
    trained, phase8 = phase_train(dev, smi)
    clock("phase 8")
    variants = phase_variants(dev, smi)
    clock("phase 9")
    flagship = phase_flagship(dev, smi, phase8)
    clock("phase 10")
    wo_eq = phase_wo_eq(dev, smi)
    clock("phase 11")
    cdgs = phase_cdgs(dev, smi)
    clock("phase 12")
    eval_stack = phase_eval_stack(dev, smi)
    clock("phase 13")
    mesh = phase_mesh(dev, smi)
    clock("phase 14")
    nfree = phase_nfree(dev, smi)
    clock("phase 15")
    tools = phase_tools(dev, smi)
    clock("phase 16")
    sweep = {k: sum(r[0][k] for r in sweeps.values()) for k in serving}
    for row in rows:
        # the dd1 rows' main path is phase 9's (dist_gbf=False); the others'
        # the 3 served requests
        dd1 = "_dd1" in row["name"]
        row["launches"] = variants.get(row["name"], 0) if dd1 else launches[row["name"]]
        row["serving_launches"] = serving[row["name"]]
        row["sweep_launches"] = sweep[row["name"]]
        row["train_snapshot_launches"] = trained[row["name"]]
        row["variant_launches"] = variants.get(row["name"], 0)
        row["flagship_train_launches"] = flagship.get(row["name"], 0)
        row["wo_eq_specformer_bf16_launches"] = wo_eq.get(row["name"], 0)
        row["cdgs_launches"] = cdgs.get(row["name"], 0)
        row["eval_stack_launches"] = eval_stack.get(row["name"], 0)
        row["mesh_launches"] = mesh.get(row["name"], 0)
        row["nfree_launches"] = nfree.get(row["name"], 0)
        row["tools_launches"] = tools.get(row["name"], 0)
        assert row["launches"] > 0 and row["cdgs_launches"] == 0, row
        for phase in ("nfree_launches", "tools_launches"):
            assert (row[phase] > 0) == (row["name"] in kernels_of("attn_equi", "bf16")), row
    for row in probe_rows:  # launches: the probe tool's run; none on the serving paths
        row["wo_eq_specformer_bf16_launches"] = wo_eq.get(row["name"], 0)
        row["cdgs_launches"] = cdgs.get(row["name"], 0)
        row["eval_stack_launches"] = eval_stack.get(row["name"], 0)
        row["mesh_launches"] = mesh.get(row["name"], 0)
        row["nfree_launches"] = nfree.get(row["name"], 0)
        row["tools_launches"] = tools.get(row["name"], 0)
        row["serving_launches"] = (serving[row["name"]] + sweep[row["name"]] + trained[row["name"]]
                                   + variants.get(row["name"], 0) + flagship.get(row["name"], 0)
                                   + row["wo_eq_specformer_bf16_launches"] + row["cdgs_launches"]
                                   + row["eval_stack_launches"] + row["mesh_launches"]
                                   + row["nfree_launches"] + row["tools_launches"])
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
