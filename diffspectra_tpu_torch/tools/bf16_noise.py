"""How far small changes in the serving kernels' outputs move a bf16
forward, against the bf16 forward's own distance from float32.

A kernel and its plain version sum in another order, so their float32
results differ by an ulp or so. Where a bf16 rounding follows, such a
difference now and then flips it, and later blocks carry the flip on. This
tool measures that at the full width of ``warm_qm9s_as.npz`` on
``chip_smoke.py``'s forward inputs (B=10 draws, N=29): for each path and
both self-conditioning steps it runs the bf16 and the float32 forward,
then the bf16 forward again with each kernel wrapper, as the model calls
it, changed in one of three ways:

- ``ulp``: its outputs times ``1 + 2^-22 n``, n a unit normal (seeds 0
  to ``--seeds`` - 1): what a correct kernel summing in another order does;
- ``bf16``: its outputs rounded to bfloat16: a kernel that keeps its
  float32 result in bfloat16;
- ``drop_k``: the last 16 rows of its gate weights (``mix_attention``'s
  w0 and w1, ``equi_update``'s w_d, ``block_fused``'s w0a, w1a and w_d)
  zeroed, which is what a kernel computes whose gate product drops its
  last ``mma`` k step of 16.

For each output it prints the largest |changed - bf16| over the largest
|bf16 - f32| on the same device: the ratio that ``chip_smoke.py``'s phase
4 bounds, whose bound has to lie above every ``ulp`` reading and below the
``drop_k`` one.

    python -m diffspectra_tpu_torch.tools.bf16_noise [--device cpu] [--seeds 4]

Runs on ``cuda`` unless ``--device cpu`` is given (there the wrappers run
their plain versions); about 30 s on the card, a minute on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import os

import numpy as np
import torch

from .. import configs
from ..api import load_model
from ..data.synthetic import generate
from ..device import resolve_device
from ..models import dmt, layers
from ..ops.block_fused import _DATA, _WEIGHTS
from ..utils import masks as M

WARM = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts", "warm_qm9s_as.npz")
N_NODES = (29, 21, 17, 29, 5, 25, 12, 29, 1, 19)  # a ragged batch of B draws
N = 29
# the kernel wrappers at the model's call sites, and the weights whose rows
# are the K of a gate product
WRAPPERS = ((layers, "mix_attention"), (dmt, "equi_update"), (dmt, "block_fused"))
GATE_WEIGHTS = {"mix_attention": ("w0", "w1"), "equi_update": ("w_d",),
                "block_fused": ("w0a", "w1a", "w_d")}
K_STEP = 16  # the k of mma.sync m16n8k16
PATHS = {"attn_equi": ("attn", "equi"), "block": ("block",)}
ULP_NOISE = 2.0 ** -22


def forward_inputs(dev, has_cond: bool):
    """One reverse step's inputs in the warm model's operating range: noisy
    positions and features, conditioning inside its clamp range, spectra of
    synthetic molecules, noise levels across the schedule."""
    rng = np.random.default_rng(1)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    B = len(N_NODES)
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
    move = lambda x: None if x is None else x.to(dev)
    args = (torch.full((B,), 0.5), xh, node_mask, edge_mask, edge_x, torch.linspace(-9, 9, B),
            cond_x, cond_e)
    return [move(x) for x in args], [s.to(dev) for s in specs]


@contextlib.contextmanager
def perturbed(mode: str, seed: int = 0):
    """Every kernel wrapper, as the model calls it, changed: ``mode``
    ``"ulp"``, its outputs times ``1 + 2^-22 n`` (n a normal from
    ``seed``); ``"bf16"``, its outputs rounded to bfloat16; ``"drop_k"``,
    the last ``K_STEP`` rows of its gate weights zeroed."""
    gens = {}

    def drop_k(name, fn, args):
        names = _DATA + _WEIGHTS if name == "block_fused" else tuple(inspect.signature(fn).parameters)
        args = list(args)
        for w in GATE_WEIGHTS[name]:
            i = names.index(w)
            args[i] = args[i].clone()
            args[i][-K_STEP:] = 0
        return args

    def change(o):
        if mode == "bf16":
            return o.to(torch.bfloat16).to(o.dtype)
        gen = gens.get(o.device)
        if gen is None:
            gen = gens[o.device] = torch.Generator(o.device).manual_seed(seed)
        return o * (1 + ULP_NOISE * torch.randn(o.shape, generator=gen, device=o.device))

    def wrap(name, fn):
        def changed(*args, **kw):
            if mode == "drop_k":
                return fn(*drop_k(name, fn, args), **kw)
            out = fn(*args, **kw)
            return tuple(map(change, out)) if isinstance(out, tuple) else change(out)
        return changed

    saved = [getattr(module, name) for module, name in WRAPPERS]
    try:
        for (module, name), fn in zip(WRAPPERS, saved):
            setattr(module, name, wrap(name, fn))
        yield
    finally:
        for (module, name), fn in zip(WRAPPERS, saved):
            setattr(module, name, fn)


def forward(model, dev, has_cond: bool):
    """The model's (pred, edge_pred) on ``forward_inputs``, float32 on the CPU."""
    args, specs = forward_inputs(dev, has_cond)
    with torch.no_grad():
        return [o.float().cpu() for o in model(*args, has_cond, model.encode_context(specs))]


def max_ratio(got, want, want_f32):
    """Largest |got - want| over largest |want - want_f32|."""
    return ((got - want).abs().max() / (want - want_f32).abs().max()).item()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--seeds", type=int, default=4, help="seeds of the ulp noise")
    a = parser.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for path, ops in PATHS.items():
        models = {p: load_model(WARM, configs.apply_overrides(configs.get_config(), {
            "model.pallas_ops": ops, "training.matmul_precision": p}), dev)
            for p in ("bfloat16", "float32")}
        for has_cond in (True, False):
            bf16, f32 = (forward(models[p], dev, has_cond) for p in ("bfloat16", "float32"))
            ulp = []
            for seed in range(a.seeds):
                with perturbed("ulp", seed):
                    ulp.append(forward(models["bfloat16"], dev, has_cond))
            faults = {}
            for mode in ("bf16", "drop_k"):
                with perturbed(mode):
                    faults[mode] = forward(models["bfloat16"], dev, has_cond)
            for i, name in enumerate(("pred", "edge_pred")):
                noise = [max_ratio(u[i], bf16[i], f32[i]) for u in ulp]
                print(f"{dev.type} {path} has_cond={has_cond} {name}: ulp ratio max "
                      f"{max(noise):.4f} (seeds: {', '.join(f'{r:.4f}' for r in noise)}); "
                      + "; ".join(f"{mode} ratio {max_ratio(o[i], bf16[i], f32[i]):.4f}"
                                  for mode, o in faults.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
