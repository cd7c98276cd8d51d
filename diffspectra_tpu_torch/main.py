"""The port's command line (``diffspectra_tpu/main.py``): train, or run the
evaluation sweep.

    python -m diffspectra_tpu_torch.main --mode train --workdir exp/train \\
        --warm-start artifacts/warm_qm9s_as.npz
    python -m diffspectra_tpu_torch.main --mode train --workdir /tmp/smoke --smoke --device cpu
    python -m diffspectra_tpu_torch.main --mode eval --workdir exp/train

``train`` runs ``run_lib.train`` (the flagship config, or the small test
config with ``--smoke``), warm-started from ``--warm-start`` when the
workdir holds no checkpoint, and leaves ``<workdir>/warm_state.npz``.
``eval`` runs the sweep (``run_lib.evaluate``) on ``--warm-start``, or else
(``run_lib.evaluate_workdir``) on the workdir's latest resumable
checkpoint, restored as ``Elucidator.from_workdir`` restores it, its tables
in ``<workdir>/eval``. Runs on
``cuda`` unless ``--device cpu`` is given. Logs to stdout and to
``<workdir>/stdout.txt`` (``eval_stdout.txt`` for eval).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("train", "eval"), required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--smoke", action="store_true", help="the small test config")
    p.add_argument("--warm-start", default="", help="a warm-state .npz")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from diffspectra_tpu_torch import configs, run_lib

    os.makedirs(args.workdir, exist_ok=True)
    log_name = "stdout.txt" if args.mode == "train" else "eval_stdout.txt"
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True,
                        handlers=[logging.StreamHandler(sys.stdout),
                                  logging.FileHandler(os.path.join(args.workdir, log_name))])
    config = configs.get_smoke_config() if args.smoke else configs.get_config()
    if args.mode == "train":
        config.training.warm_start = args.warm_start
        state = run_lib.train(config, args.workdir, args.device)
        logging.info("trained to step %d", state.step)
        return state
    eval_dir = os.path.join(args.workdir, "eval")
    if args.warm_start:
        return run_lib.evaluate(config, args.warm_start, eval_dir, args.device)
    return run_lib.evaluate_workdir(config, args.workdir, eval_dir, args.device)


if __name__ == "__main__":
    main()
