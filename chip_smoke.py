"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, serve.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name, power limit); TF32 off for matmuls and convolutions;
  2. build the CUDA kernels from ``diffspectra_tpu_torch/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version at the serving shape
     (B=10 draws, N=29, flagship widths) on a seeded ragged batch, with the
     kernel's, the plain version's and the bound's times;
  4. a full-width DMT forward from ``artifacts/warm_qm9s_as.npz`` on cuda
     (kernels) against the same model on the CPU (plain versions);
  5. serve: ``Elucidator.from_warm_state(...).elucidate(...)`` for 3 synthetic
     requests (fidelity-4 spectra) at their true atom counts, 10 candidates,
     1000 ancestral steps; the kernels' launch counters must rise by
     8 blocks x steps x requests;
  6. a profile of DMT forwards at the serving shape (kernel time by name and
     the device's busy share).
Then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that last line; without CUDA it exits 2.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WARM = os.path.join(ROOT, "artifacts", "warm_qm9s_as.npz")
B, N = 10, 29  # draws per request, padded atoms at the largest bucket
REQUESTS, CANDIDATES, STEPS = 3, 10, 1000
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
KERNEL_ATOL = {"mix_attention": 1e-5, "equi_update": 1e-5}
FORWARD_RTOL = 1e-3  # of the largest |value|: 8 blocks sum in another order


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


def ragged_masks(device):
    node = (torch.arange(N)[None] < torch.tensor(N_NODES)[:, None]).float()
    edge = node[:, :, None] * node[:, None, :] * (1.0 - torch.eye(N))
    return edge.to(device)


def attention_case(gen, dev):
    """mix_attention inputs at the serving shape, and the work they need."""
    de, n_sub, sub_c, heads, out_ch, n_extra = 64, 14, 18, 16, 16, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    extra = (torch.rand(B, N, N, n_extra, generator=gen) > 0.5).float().to(dev)
    args = (r(B, N, n_sub, sub_c), r(B, N, n_sub, sub_c), r(B, N, heads, out_ch),
            r(B, N, N, de), r(de, n_sub * sub_c, scale=de**-0.5),
            r(de, heads * out_ch, scale=de**-0.5), extra, ragged_masks(dev))
    ec, hc = n_sub * sub_c, heads * out_ch
    # per pair: two gate projections, their tanh, q*k*e0 and the head sums,
    # the softmax, alpha*v*e1 and the j sum (dense over all N x N pairs)
    flops = B * N * N * (2 * de * (ec + hc) + (ec + hc) + 3 * ec + 3 * heads + 3 * hc)
    nbytes = 4 * (sum(a.numel() for a in args) + B * N * hc)
    return args, flops, nbytes


def equi_case(gen, dev):
    """equi_update inputs at the serving shape, and the work they need."""
    de, dd, dh, n_adj = 64, 64, 256, 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    adj = (torch.rand(B, N, N, n_adj, generator=gen) > 0.5).float().to(dev)
    args = (r(B, N, dh), r(B, N, dh), r(B, N, N, de), r(B, N, N, dd), r(B, N, N, 3),
            adj, ragged_masks(dev), r(de, dh, scale=de**-0.5), r(dd, dh, scale=dd**-0.5),
            r(dh, scale=0.1), r(B, dh, scale=0.1), r(B, dh, scale=0.1),
            r(dh, dh, scale=dh**-0.5), r(dh, scale=0.1), r(dh, 1 + n_adj, scale=dh**-0.5))
    # per pair: the two gate projections, the W0 product, the W1 product, and
    # about 12 operations per channel for sums, LayerNorm, modulation, silu
    flops = B * N * N * (2 * (de + dd) * dh + 2 * dh * dh + 2 * dh * (1 + n_adj) + 12 * dh)
    nbytes = 4 * (sum(a.numel() for a in args) + B * N * 3)
    return args, flops, nbytes


def phase_kernels(dev):
    from diffspectra_tpu_torch.ops.equi_update import equi_update, equi_update_reference
    from diffspectra_tpu_torch.ops.mix_attention import mix_attention, mix_attention_reference

    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, kernel, plain, case, source, replaces in (
        ("mix_attention", mix_attention, mix_attention_reference, attention_case,
         "diffspectra_tpu_torch/csrc/mix_attention.cu", "diffspectra_tpu/ops/pallas_attention.py:147"),
        ("equi_update", equi_update, equi_update_reference, equi_case,
         "diffspectra_tpu_torch/csrc/equi_update.cu", "diffspectra_tpu/ops/pallas_equi_update.py:139"),
    ):
        args, flops, nbytes = case(gen, dev)
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        say(f"[kernels] {name}: max |kernel - plain| = {err:.3e} (tolerance {KERNEL_ATOL[name]:.0e}, "
            f"max |plain| = {want.abs().max().item():.3e})")
        assert torch.isfinite(got).all() and err <= KERNEL_ATOL[name], name
        ms = cuda_time_ms(lambda: kernel(*args), iters=200)
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=50)
        t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        say(f"[kernels] {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain version, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, max_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    return rows


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


def phase_forward(dev):
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import load_dmt

    config = configs.get_config()
    cpu_model = load_dmt(WARM, config, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    for has_cond in (True, False):
        outs = []
        for model, device in ((gpu_model, dev), (cpu_model, torch.device("cpu"))):
            args, specs = forward_inputs(device, has_cond)
            with torch.no_grad():
                ctx = model.encode_context(specs)
                outs.append([o.cpu() for o in model(*args, has_cond, ctx)])
        for name, got, want in zip(("pred", "edge_pred"), *outs):
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            say(f"[forward] has_cond={has_cond} {name}: max |cuda - cpu| = {err:.3e}, "
                f"max |cpu| = {scale:.3e}, tolerance {FORWARD_RTOL:.0e} x max")
            assert torch.isfinite(got).all() and err <= FORWARD_RTOL * scale, name
    return gpu_model


def phase_serve(dev):
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.info import get_dataset_info
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.evaluation.molgraph import MolGraph
    from diffspectra_tpu_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    el = Elucidator.from_warm_state(WARM, overrides={"sampling.steps": STEPS}, device=dev)
    say(f"[serve] loaded {WARM} in {time.perf_counter() - t0:.2f} s; "
        f"steps={el.config.sampling.steps}, candidates={CANDIDATES}, requests={REQUESTS}")
    data = generate(seed=7, size=REQUESTS, max_n=29, fidelity=4)
    decoder = get_dataset_info("qm9_second_half")["atom_decoder"]
    n_layers = el.config.model.n_layers
    reset_launches()  # counts from here on are the main path's
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
        say(f"[serve] request {m}: n_atoms={n} wall={wall:.3f} s "
            f"({CANDIDATES / wall:.3f} sampled mols/s), {len(result.candidates)} distinct "
            f"candidates, best frequency {result.best.frequency:.2f}, finite={finite}, "
            f"top-1 WL hash equals target={hit}, launches={launched}")
        assert finite and sum(c.count for c in result.candidates) == CANDIDATES
        assert all(c.molgraph.n_atoms == n for c in result.candidates)
        per_request.append(dict(n_atoms=n, wall_s=wall, mols_per_s=CANDIDATES / wall,
                                distinct=len(result.candidates), top1_hit=hit))
    launches = dict(LAUNCHES)
    expected = n_layers * STEPS * REQUESTS
    say(f"[serve] launches {launches}, expected {expected} each")
    assert all(v == expected for v in launches.values()), launches
    total = sum(r["wall_s"] for r in per_request)
    say("[serve] " + json.dumps({"requests": per_request, "mols_per_s": REQUESTS * CANDIDATES / total}))
    return launches


def phase_profile(model, dev):
    """Kernel time by name over 5 forwards at the serving shape, and the
    device's busy share of the window (from the profiler's kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    args, specs = forward_inputs(dev, True)
    with torch.no_grad():
        ctx = model.encode_context(specs)
        fwd = lambda: model(*args, True, ctx)
        say(f"[profile] one DMT forward (B={B}, N={N}, has_cond): "
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
    say(f"[profile] window {window_us:.0f} us, kernel time {busy_us:.0f} us "
        f"(busy share {busy_us / window_us:.3f})")
    for e in rows[:10]:
        say(f"[profile]   {e.device_time_total / 5:10.1f} us/forward  x{e.count // 5:<4d} {e.key[:90]}")


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
    for line in _lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")

    rows = phase_kernels(dev)
    model = phase_forward(dev)
    launches = phase_serve(dev)
    phase_profile(model, dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
