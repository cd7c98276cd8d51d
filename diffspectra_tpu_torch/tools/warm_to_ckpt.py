"""Write a warm state as a numbered checkpoint of a train workdir (the
port's counterpart of ``tools/warm_to_ckpt.py``, with flags in place of its
variables).

The ``exp/`` workdirs of past runs do not travel with the repository; their
warm states (``artifacts/*.npz``) do. ``main.py --mode eval`` and
``Elucidator.from_workdir`` read a workdir's numbered checkpoints, so a run
whose workdir is gone needs its warm state written back as one first. The
params, EMA, batch statistics and step are the warm state's; the optimizer
state is fresh (evaluation reads only the EMA weights):

    python -m diffspectra_tpu_torch.tools.warm_to_ckpt --warm artifacts/warm_qm9s_ir.npz \\
        --workdir exp/ir_from_warm
    python -m diffspectra_tpu_torch.main --mode eval --workdir exp/ir_from_warm \\
        --config data.spectra_version=ir --config eval.ckpts=40

The model is the flagship config's with ``data.spectra_version=ir``, then
``--config KEY=VALUE`` (repeated): it must be the warm state's. The
checkpoint is ``checkpoints/checkpoint_<--ckpt>``, by default the warm
state's step // 25000 (the quality runs' snapshot interval). Runs on
``cuda`` unless ``--device cpu`` is given. Prints ``WARM_TO_CKPT OK
ckpt=<N> step=<step>``.
"""

from __future__ import annotations

import argparse
import logging
import sys

QUALITY_SNAPSHOT_FREQ = 25000  # training.snapshot_freq of the quality runs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm", required=True, help="the warm state's .npz")
    p.add_argument("--workdir", required=True, help="the train workdir to write into")
    p.add_argument("--ckpt", type=int, default=None,
                   help=f"the checkpoint's number (default: step // {QUALITY_SNAPSHOT_FREQ})")
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
    from diffspectra_tpu_torch.warm_state import warm_start

    device = resolve_device(args.device)
    config = configs.apply_overrides(configs.get_config(), {"data.spectra_version": "ir"})
    configs.apply_overrides(config, parse_overrides(config, args.config))
    _, state = run_lib.init_train_state(config, device)
    state = warm_start(state, args.warm)
    step = int(state.step)
    ckpt = step // QUALITY_SNAPSHOT_FREQ if args.ckpt is None else args.ckpt
    dst = ckpt_lib.numbered_checkpoint_dir(args.workdir, ckpt)
    ckpt_lib.save_checkpoint(dst, state)
    logging.info("wrote %s from %s (step %d)", dst, args.warm, step)
    print(f"WARM_TO_CKPT OK ckpt={ckpt} step={step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
