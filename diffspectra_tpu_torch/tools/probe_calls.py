"""Time a Mosaic probe's call on the host: through its wrapper (``probes.tN``:
the Python checks, the output's allocation and the ``ctypes`` call) and
through its C entry alone (``dstt_probe_tN`` with every argument made
beforehand, the launch itself).

Each time is the median, over rounds, of the host clock across ``--calls``
back-to-back calls closed by a synchronize, in microseconds a call; the
rounds' lowest and highest are printed beside it. With ``--device cpu`` the
wrappers run their plain versions and the C entries are not measured.

    python -m diffspectra_tpu_torch.tools.probe_calls [--device cpu] [--calls 2000]
        [--rounds 7] [--probes t3,t4,t5]

It reads nothing but ``ops/probes.py``'s ``PROBES`` (a probe's launch sizes,
and the launch plan of those that take one), so the same file times an
older checkout of the port as well.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time

import torch

from ..device import resolve_device
from ..ops import _lib
from ..ops.probes import PROBES
from .diag_probes import probe_inputs


def per_call_us(fn, calls: int, rounds: int, sync) -> list:
    """The host time a call of ``fn`` over each of ``rounds`` rounds of
    ``calls`` calls, microseconds, after one warm round."""
    out = []
    for r in range(rounds + 1):
        sync()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        if r:
            out.append((time.perf_counter() - start) / calls * 1e6)
    return out


def entry_call(name: str, inputs: list, device: torch.device):
    """Probe ``name``'s C entry as its wrapper calls it, every argument made
    once: the pointers, the launch sizes, the plan's ints where the probe
    has a plan, and the stream."""
    probe = PROBES[name]
    out = torch.empty(probe.out_shape, device=device, dtype=torch.float32)
    sizes = probe.sizes(probe.out_shape, *probe.inputs.values())
    plan = getattr(probe, "plan", None)  # older checkouts have none
    extra = ()
    if plan is not None:
        ints = plan(*sizes).ints()
        extra = ((ctypes.c_int * len(ints))(*ints), len(ints))
    fn = getattr(_lib.build(), f"dstt_probe_{name}")
    args = (*(t.data_ptr() for t in inputs), out.data_ptr(), *sizes, *extra,
            _lib.stream_handle(device))

    def call():
        _lib.check_rc(f"probe {name}", fn(*args))

    return call, (inputs, out)  # the tensors stay alive while `call` runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--probes", default=",".join(PROBES),
                        help="comma-separated probe names, t1 ... t14")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows = {}
    for name in args.probes.split(","):
        probe = PROBES[name]
        inputs = [t.to(device) for t in probe_inputs(name, seed=1)]
        times = {"wrapper": per_call_us(lambda: probe.wrapper(*inputs), args.calls, args.rounds,
                                        sync)}
        if device.type == "cuda":
            call, _keep = entry_call(name, inputs, device)
            times["entry"] = per_call_us(call, args.calls, args.rounds, sync)
        row = {k: {"median_us": statistics.median(v), "min_us": min(v), "max_us": max(v)}
               for k, v in times.items()}
        parts = [f"{'wrapper' if k == 'wrapper' else 'C entry'} {r['median_us']:.2f} us "
                 f"({r['min_us']:.2f}-{r['max_us']:.2f})" for k, r in row.items()]
        if device.type != "cuda":
            parts.append("C entry not measured")
        print(f"[probe_calls] {name}: " + ", ".join(parts), flush=True)
        rows[name] = row
    print(json.dumps({"device": str(device), "calls": args.calls, "rounds": args.rounds,
                      "probes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
