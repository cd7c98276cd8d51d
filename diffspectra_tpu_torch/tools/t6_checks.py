"""Checks of the t6 probe (``tanh`` on [256, 256], 1e-6 against its plain
version) on the card, the probe that once read 5.18e-05 from its plain
version in one run and 0 to 1.2e-07 in every other.

    python -m diffspectra_tpu_torch.tools.t6_checks [--repeats 20] [--serving]
        [--cpu-repeats 1] [--library PATH --kernel NAME]

1. The kernel side's code: the MUFU (special-function unit) instructions of
   the kernel whose mangled name holds ``--kernel`` and ``Tanh``
   (``grid_step_kernel`` by default) in ``cuobjdump -sass`` of the built
   library (``--library``: another build of it, such as an older checkout's).
   The precise ``tanhf`` needs MUFU.EX2 and MUFU.RCP; MUFU.TANH is the
   approximate ``tanh.approx.f32``, whose relative error of about 2^-11
   would break the 1e-6. Fails if the kernel is missing or holds MUFU.TANH.
2. The CPU's float32 ``torch.tanh`` (t6's plain version until it moved to
   float64) of ``probe_inputs("t6", seed)`` for seeds 0 and 1, at 1 thread
   and at the default count, ``--cpu-repeats`` times, against float64
   (largest |error| and the repeats over 1e-6), beside the CPU's model;
   and the kernel's output on the same inputs against float64.
3. With ``--serving``, the serving kernels first, as ``chip_smoke.py``'s
   phase 3 runs them; then the probe tool (``run_probes``) ``--repeats``
   times in this process, counting its FAIL lines (each printed).

Runs on the GPU only. Prints one JSON object of the results last, and
exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..ops import _lib, probes
from .diag_probes import probe_inputs, run_probes

ROOT = Path(__file__).resolve().parents[2]  # the checkout: chip_smoke.py


def mufu_ops(library: Path, kernel: str) -> dict:
    """Mangled name -> count of each MUFU instruction, for every function
    of ``library``'s SASS whose name holds ``kernel`` and ``Tanh``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1) if kernel in head.group(1) and "Tanh" in head.group(1) else None
            if name is not None:
                found[name] = Counter()
        elif name is not None:
            found[name].update(re.findall(r"MUFU\.\w+", line))
    return {k: dict(v) for k, v in found.items()}


def _error(got, x) -> float:
    """Largest |got - tanh(x)|, tanh in float64."""
    return float(np.abs(got.cpu().double().numpy() - np.tanh(x.double().numpy())).max())


def plain_side_errors(seeds=(0, 1), repeats: int = 1) -> dict:
    """The CPU's float32 ``torch.tanh`` against float64 tanh over the seeds'
    t6 inputs, ``repeats`` times at each thread count: thread count ->
    (largest |error|, repeats whose error passed the probe's 1e-6)."""
    default = torch.get_num_threads()
    inputs = [x for (x,) in (probe_inputs("t6", s) for s in seeds)]
    errors = {}
    try:
        for threads in sorted({1, default}):
            torch.set_num_threads(threads)
            runs = [max(_error(torch.tanh(x), x) for x in inputs) for _ in range(repeats)]
            errors[threads] = (max(runs), sum(e > probes.PROBES["t6"].atol for e in runs))
    finally:
        torch.set_num_threads(default)
    return errors


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
    return f"{names[0]} x {len(names)}" if names else "unknown"


def kernel_errors(dev, seeds=(0, 1)) -> float:
    """Largest |kernel - float64 tanh| over the seeds' t6 inputs."""
    return max(_error(probes.t6(x.to(dev)), x) for (x,) in (probe_inputs("t6", s) for s in seeds))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--serving", action="store_true",
                        help="run chip_smoke.py's phase 3 (the serving kernels) first")
    parser.add_argument("--library", default=None, help="the built library to disassemble")
    parser.add_argument("--kernel", default="grid_step_kernel")
    parser.add_argument("--cpu-repeats", type=int, default=1,
                        help="repeats of the CPU's float32 tanh against float64")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("t6_checks: CUDA is not available; this tool runs on the GPU only")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    _lib.build()
    library = Path(args.library) if args.library else _lib.BUILD_DIR / _lib.LIB_NAME
    mufu = mufu_ops(library, args.kernel)
    print(f"[sass] {library}: {mufu}", flush=True)
    plain = plain_side_errors(repeats=args.cpu_repeats)
    kernel = kernel_errors(dev)
    print(f"[plain] CPU float32 torch.tanh against float64, by threads: (largest error, "
          f"repeats over 1e-6 of {args.cpu_repeats}) {plain} (CPU {cpu_model()}, capability "
          f"{torch.backends.cpu.get_cpu_capability()}, torch {torch.__version__}); "
          f"kernel against float64: {kernel:.3e}", flush=True)
    if args.serving:
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        chip_smoke.phase_kernels(dev)
    fails = []
    for _ in range(args.repeats):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run_probes(dev, seed=0)
        fails += [line for line in out.getvalue().splitlines() if line.startswith("FAIL")]
    for line in fails:
        print(line, flush=True)
    print(f"[repeats] the probe tool {args.repeats} times"
          f"{' after phase 3' if args.serving else ''}: "
          f"{len(probes.PROBES) * args.repeats - len(fails)} PASS, {len(fails)} FAIL", flush=True)
    ok = bool(mufu) and not any("MUFU.TANH" in ops for ops in mufu.values()) and not fails
    print(json.dumps({"ok": ok, "mufu": mufu, "plain_vs_f64": plain, "kernel_vs_f64": kernel,
                      "probe_runs": args.repeats, "fail_lines": len(fails)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
