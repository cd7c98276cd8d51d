"""The evaluation sweep from the command line (the port's counterpart of
``tools/tpu_eval_10k.py``, with flags in place of its ``EVAL_*``
variables).

    python -m diffspectra_tpu_torch.tools.eval_sweep \\
        --warm-state artifacts/warm_qm9s_as.npz --workdir exp/eval_sweep \\
        --num-samples 128 --num-candidates 10 --synthetic-size 1280 --fidelity 4 \\
        --pallas-ops block

On the CPU at the smoke size, with random weights (the figures then mean
nothing, the run checks the path):

    python -m diffspectra_tpu_torch.tools.eval_sweep --smoke --random-weights \\
        --device cpu --steps 3 --num-samples 6 --num-candidates 2 --synthetic-size 64

Runs on ``cuda`` unless ``--device cpu`` is given. Logs to stdout and to
``<workdir>/eval_sweep.log``; the similarity tables go to ``<workdir>/eval``;
the last line of stdout is the figures as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm-state", default="artifacts/warm_qm9s_as.npz",
                   help="warm-state export whose EMA weights to score")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from --seed instead of a warm state")
    p.add_argument("--smoke", action="store_true", help="the small test config")
    p.add_argument("--workdir", default="exp/eval_sweep")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--num-samples", type=int, help="eval.num_samples (targets)")
    p.add_argument("--batch-size", type=int, help="eval.batch_size (draws a round)")
    p.add_argument("--num-candidates", type=int, help="eval.num_candidates (K)")
    p.add_argument("--steps", type=int, help="sampling.steps")
    p.add_argument("--method", help="sampling.method: ancestral, dpm_solver, dpm_solver_sde")
    p.add_argument("--temperature", type=float, help="eval.sampling_temperature")
    p.add_argument("--synthetic-size", type=int, help="data.synthetic_size")
    p.add_argument("--fidelity", type=int, help="data.synthetic_fidelity")
    p.add_argument("--seed", type=int, help="config.seed (data, split and noise)")
    p.add_argument("--pallas-ops", type=lambda v: tuple(op for op in v.split(",") if op),
                   help="model.pallas_ops, comma-separated: block, or attn,equi (the default)")
    return p.parse_args(argv)


def build_config(args):
    from diffspectra_tpu_torch import configs

    config = configs.get_smoke_config() if args.smoke else configs.get_config()
    flags = {"eval.num_samples": args.num_samples, "eval.batch_size": args.batch_size,
             "eval.num_candidates": args.num_candidates, "sampling.steps": args.steps,
             "sampling.method": args.method, "eval.sampling_temperature": args.temperature,
             "data.synthetic_size": args.synthetic_size,
             "data.synthetic_fidelity": args.fidelity, "seed": args.seed,
             "model.pallas_ops": args.pallas_ops}
    return configs.apply_overrides(config, {k: v for k, v in flags.items() if v is not None})


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, force=True, format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(args.workdir, "eval_sweep.log"), mode="w")],
    )
    from diffspectra_tpu_torch import run_lib
    from diffspectra_tpu_torch.device import resolve_device
    from diffspectra_tpu_torch.models.dmt import DMT
    from diffspectra_tpu_torch.warm_state import load_model_state, random_variables

    config = build_config(args)
    device = resolve_device(args.device)
    eval_dir = os.path.join(args.workdir, "eval")
    t0 = time.time()
    if args.random_weights:
        model = DMT.from_config(config)
        load_model_state(model, random_variables(model, seed=config.seed))
        figures = run_lib.diffspectra_evaluate(config, model.eval().to(device), eval_dir, device,
                                               "random")
    else:
        figures = run_lib.evaluate(config, args.warm_state, eval_dir, device)
    logging.info("TOTAL EVAL WALL TIME: %.1fs", time.time() - t0)
    print(json.dumps(figures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
