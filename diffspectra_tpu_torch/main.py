"""The port's command line (``diffspectra_tpu/main.py``): train, evaluate, or
pretrain SpecFormer.

    python -m diffspectra_tpu_torch.main --mode train --workdir exp/train \\
        --warm-start artifacts/warm_qm9s_as.npz
    python -m diffspectra_tpu_torch.main --mode train --workdir /tmp/smoke --smoke --device cpu
    python -m diffspectra_tpu_torch.main --mode train --workdir /tmp/s2d --smoke-2d --device cpu
    python -m diffspectra_tpu_torch.main --mode eval --workdir exp/train --config eval.ckpts=1,2
    python -m diffspectra_tpu_torch.main --mode eval --workdir exp/train --original-qm9 \
        --config eval.save_mols=true
    python -m diffspectra_tpu_torch.main --mode pretrain --workdir exp/pre \\
        --config data.spectra_version=allspectra

``train`` runs ``run_lib.train`` (the flagship config, the small test
config with ``--smoke``, or its 2-D path, CDGS without positions, with
``--smoke-2d``), warm-started from ``--warm-start`` when the
workdir holds no checkpoint, and leaves ``<workdir>/warm_state.npz``.
``eval`` runs the sweep (``run_lib.evaluate``) on ``--warm-start``, or
else (``run_lib.evaluate_checkpoints``) on each numbered checkpoint of the
workdir that ``eval.ckpts`` or ``eval.begin_ckpt`` ... ``eval.end_ckpt``
names (40 by default, 1 with ``--smoke`` or ``--smoke-2d``), its tables in
``<workdir>/eval``; ``--original-qm9`` takes its metric reference sets from
the original-QM9 split (``configs.original_qm9_config``: the main config's
``data`` keys but ``info_name`` and ``spectra_version``, then
``--original-qm9-config KEY=VALUE``); ``--config eval.save_mols=true``
pickles the molecules for ``evaluation/base_metrics.py``. ``pretrain``
runs ``training/pretrain.py`` and leaves
``<workdir>/specformer_pretrained.npz`` for
``model.pretrained_specformer_path``. ``--config KEY=VALUE`` (repeated)
sets any config key, the value read as the key's type (``data.root``,
``data.synthetic=true``, ``training.warm_start_partial=true``,
``data.bucket_sizes=(17,21,25,29)``). Runs on ``cuda`` unless ``--device
cpu`` is given. Logs to stdout and to ``<workdir>/stdout.txt``
(``eval_stdout.txt``, ``pretrain_stdout.txt``).

``train`` and ``eval`` run data parallel under ``torchrun``, one process a
GPU, with no flag of their own (``parallel.init_distributed`` reads
torchrun's variables; NCCL on the GPUs, gloo with ``--device cpu``):

    torchrun --nproc_per_node=8 -m diffspectra_tpu_torch.main --mode train --workdir exp/train

Rank 0 alone logs below warnings and writes the files; ``pretrain`` runs
in one process (the JAX package's pretraining scales nothing over the
mesh).
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import sys

LOG_NAMES = {"train": "stdout.txt", "eval": "eval_stdout.txt", "pretrain": "pretrain_stdout.txt"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=tuple(LOG_NAMES), required=True)
    p.add_argument("--workdir", required=True)
    smoke = p.add_mutually_exclusive_group()
    smoke.add_argument("--smoke", action="store_true", help="the small test config")
    smoke.add_argument("--smoke-2d", action="store_true",
                       help="the small test config's 2-D path (CDGS, no positions)")
    p.add_argument("--warm-start", default="", help="a warm-state .npz")
    p.add_argument("--config", action="append", default=[], metavar="KEY=VALUE",
                   help="set a config key (repeatable)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--original-qm9", action="store_true",
                   help="eval: the metric reference sets from the original-QM9 split")
    p.add_argument("--original-qm9-config", action="append", default=[], metavar="KEY=VALUE",
                   help="set a key of the original-QM9 config (repeatable)")
    return p.parse_args(argv)


def parse_overrides(config, items) -> dict:
    """``["a.b=v", ...]`` -> ``{"a.b": value}``, each value read as the
    type the key holds; an unknown key raises."""
    out = {}
    for item in items:
        key, sep, text = item.partition("=")
        if not sep:
            raise ValueError(f"--config takes KEY=VALUE, got {item!r}")
        node = config
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        if not hasattr(node, leaf):
            raise AttributeError(f"unknown config key {key!r}")
        current = getattr(node, leaf)
        if isinstance(current, bool):
            if text.lower() not in ("true", "false"):
                raise ValueError(f"{key} takes true or false, got {text!r}")
            value = text.lower() == "true"
        elif isinstance(current, (int, float)):
            value = type(current)(text)
        elif isinstance(current, str):
            value = text
        else:
            value = ast.literal_eval(text)
        out[key] = value
    return out


def main(argv=None):
    args = parse_args(argv)
    from diffspectra_tpu_torch import configs, run_lib
    from diffspectra_tpu_torch.parallel.mesh import init_distributed, process_rank

    if args.mode == "pretrain":
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError("--mode pretrain runs in one process, not under torchrun")
        device = args.device
    else:
        device = init_distributed(args.device)
    lead = process_rank() == 0
    os.makedirs(args.workdir, exist_ok=True)
    handlers = [logging.StreamHandler(sys.stdout)]
    if lead:
        handlers.append(logging.FileHandler(os.path.join(args.workdir, LOG_NAMES[args.mode])))
    logging.basicConfig(level=logging.INFO if lead else logging.WARNING,
                        format="%(asctime)s %(message)s", force=True, handlers=handlers)
    if args.smoke_2d:
        config = configs.get_smoke_2d_config()
    else:
        config = configs.get_smoke_config() if args.smoke else configs.get_config()
    configs.apply_overrides(config, parse_overrides(config, args.config))
    if args.mode == "train":
        config.training.warm_start = args.warm_start or config.training.warm_start
        state = run_lib.train(config, args.workdir, device)
        logging.info("trained to step %d", state.step)
        return state
    if args.mode == "pretrain":
        from diffspectra_tpu_torch.training.pretrain import pretrain_specformer

        return pretrain_specformer(config, args.workdir, device)
    original = None
    if args.original_qm9:
        original = configs.original_qm9_config(config)
        configs.apply_overrides(original, parse_overrides(original, args.original_qm9_config))
    if args.warm_start:
        return run_lib.evaluate(config, args.warm_start, os.path.join(args.workdir, "eval"),
                                device, original)
    return run_lib.evaluate_checkpoints(config, args.workdir, "eval", device, original)


if __name__ == "__main__":
    main()
