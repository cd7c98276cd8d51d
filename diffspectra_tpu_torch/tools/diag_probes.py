"""Run the Mosaic probes' kernels one at a time against their plain versions.

The counterpart of ``tools/diag_mosaic_bisect.py``, which bisects which
Pallas/Mosaic feature a TPU compile refuses. Here each probe of
``ops/probes.py`` (a hand-written kernel in ``csrc/probe_tiles.cu``) runs
on the device on seeded inputs at the tool's shapes, and its plain version
runs on the CPU on the same inputs. It prints ``PASS tN``, or ``FAIL tN:
<max error> > <tolerance>`` with the element where the error is largest (its
index, each input of the output's shape there, the kernel's and the plain
version's values) and goes on to the next probe. A build or launch error
raises.

    python -m diffspectra_tpu_torch.tools.diag_probes [--device cpu]

runs on cuda unless given ``--device cpu`` (the plain versions on both
sides), and exits 1 if a probe failed.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..ops.probes import PROBES


def probe_inputs(name: str, seed: int = 0) -> list:
    """Unit normals of the probe's shapes and dtype, on the CPU, drawn from
    ``torch.Generator().manual_seed(seed)``."""
    probe = PROBES[name]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(probe.dtype) for shape in probe.inputs.values()]


def worst_element(inputs: dict, got, want) -> str:
    """Where |got - want| is largest: the index, each input of the output's
    shape at it, the kernel's and the plain version's values (9 digits, all
    a float32 holds)."""
    flat = int((got - want).abs().flatten().argmax())
    index = tuple(int(i) for i in torch.unravel_index(torch.tensor(flat), got.shape))
    values = [f"{name} = {t[index].item():.9e}" for name, t in inputs.items()
              if t.shape == got.shape]
    values += [f"kernel {got[index].item():.9e}", f"plain {want[index].item():.9e}"]
    return f"at {index}: {', '.join(values)}"


def run_probes(device=None, seed: int = 0) -> dict:
    """Every probe on ``device`` (cuda unless asked) against its plain
    version on the CPU; prints one line a probe; returns name -> passed."""
    device = resolve_device(device)
    passed = {}
    for name, probe in PROBES.items():
        inputs = probe_inputs(name, seed)
        got = probe.wrapper(*(t.to(device) for t in inputs)).cpu()
        want = probe.reference(*inputs)
        err = (got - want).abs().max().item()
        passed[name] = err <= probe.atol
        print(f"PASS {name}" if passed[name] else
              f"FAIL {name}: {err:.3e} > {probe.atol:.0e} "
              f"{worst_element(dict(zip(probe.inputs, inputs)), got, want)}", flush=True)
    return passed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return 0 if all(run_probes(args.device).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
