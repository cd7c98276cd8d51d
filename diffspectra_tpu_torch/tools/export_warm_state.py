"""Export a train workdir's latest checkpoint as a warm state (the port's
counterpart of ``tools/export_warm_state.py``, with flags in place of its
variables).

``run_lib.train`` writes ``<workdir>/warm_state.npz`` only when the run
ends; this exports the newest checkpoint of a run stopped before then (the
preemption checkpoint, else the latest numbered one,
``checkpoint.restore_for_resume``), in the JAX package's layout, which both
packages' ``load_warm_state`` read:

    python -m diffspectra_tpu_torch.tools.export_warm_state --workdir exp/quality_run \\
        --out exp/warm_qm9s_ir.npz
    python -m diffspectra_tpu_torch.tools.export_warm_state --workdir exp/qm9s_real \\
        --config data.spectra_version=allspectra --config data.synthetic=false \\
        --out exp/warm_qm9s_real.npz

The model is the flagship config's with ``data.spectra_version=ir``, then
``--config KEY=VALUE`` (repeated): it must be the run's. The warm state's
meta holds ``spectra_version``, ``synthetic_size``, ``step`` and ``workdir``.
The output defaults to ``exp/``, never to a committed file of
``artifacts/``. Runs on ``cuda`` unless ``--device cpu`` is given. Exits 1
when the workdir holds no checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

QUALITY_RUN = {"data.spectra_version": "ir", "data.synthetic": True,
               "data.synthetic_size": 32768}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default="exp/quality_run", help="the train workdir")
    p.add_argument("--out", default="exp/warm_qm9s_ir.npz", help="the warm state's .npz")
    p.add_argument("--config", action="append", default=[], metavar="KEY=VALUE",
                   help="set a config key (repeatable)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    from diffspectra_tpu_torch import checkpoint as ckpt_lib
    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.device import resolve_device
    from diffspectra_tpu_torch.main import parse_overrides
    from diffspectra_tpu_torch.warm_state import export_warm_state

    device = resolve_device(args.device)
    config = configs.apply_overrides(configs.get_config(), QUALITY_RUN)
    configs.apply_overrides(config, parse_overrides(config, args.config))
    _, state = run_lib.init_train_state(config, device)
    state = ckpt_lib.restore_for_resume(args.workdir, state)
    step = int(state.step)
    if step == 0:
        print("no checkpoint found in", args.workdir, "- nothing to export")
        return 1
    meta = {"spectra_version": config.data.spectra_version,
            "synthetic_size": config.data.synthetic_size, "step": step,
            "workdir": args.workdir}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    export_warm_state(state, args.out, meta=meta)
    print(f"exported step {step} to {args.out} "
          f"({os.path.getsize(args.out) / 2**20:.1f} MB)")
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
