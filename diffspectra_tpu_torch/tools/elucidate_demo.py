"""Demo: the Elucidator on the committed weights (the port's counterpart of
``tools/elucidate_demo.py``, with flags in place of its variables).

Generates a few fresh synthetic fidelity-2 molecules (seed 7, apart from
the training data's seed-42 stream), takes their raw IR spectra, and
elucidates each with ``Elucidator`` from the warm state, every round padded
to ``data.max_node`` (``eval.bucket_sizes=()``). Without ``--known-n`` the
atom count is unknown, as a user has it: the draws are marginalised over
the train histogram's plausible counts, ``max(2, k // 4)`` a count.

    python -m diffspectra_tpu_torch.tools.elucidate_demo --targets 3
    python -m diffspectra_tpu_torch.tools.elucidate_demo --device cpu --targets 1 \\
        --k 2 --steps 2 --known-n

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm-state", default="artifacts/warm_qm9s_ir.npz")
    p.add_argument("--targets", type=int, default=3, help="number of spectra")
    p.add_argument("--k", type=int, default=10, help="draws a spectrum")
    p.add_argument("--method", default="dpm_solver_sde", help="sampling.method")
    p.add_argument("--steps", type=int, default=50, help="sampling.steps")
    p.add_argument("--known-n", action="store_true",
                   help="condition on the true atom count (the reference protocol)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.evaluation.molgraph import canonical_id, from_decoded

    cfg = configs.get_config()
    cfg.data.spectra_version = "ir"
    cfg.sampling.method = args.method
    cfg.sampling.steps = args.steps
    el = Elucidator.from_warm_state(args.warm_state, config=cfg,
                                    overrides={"eval.bucket_sizes": ()}, device=args.device)

    data = generate(seed=7, size=args.targets, max_n=29, fidelity=2)
    hits = 0
    for m in range(args.targets):
        n = int(data["num_atom"][m])
        target = from_decoded((data["pos"][m, :n], data["atom_type"][m, :n],
                               data["edge_type"][m, :n, :n], data["fc"][m, :n]),
                              el.dataset_info["atom_decoder"])
        res = el.elucidate(data["ir"][m], n_atoms=n if args.known_n else None,
                           num_candidates=args.k, seed=m,
                           draws_per_n=None if args.known_n else max(2, args.k // 4))
        tid = canonical_id(target)
        mode = "known n" if args.known_n else f"n marginalized ({res.num_draws} draws)"
        print(f"\n=== target {m}: {n} atoms ({mode}), id {tid}")
        hit_rank = None
        for rank, c in enumerate(res.candidates):
            cid = canonical_id(c.molgraph)
            mark = " <-- TARGET" if cid == tid else ""
            if cid == tid and hit_rank is None:
                hit_rank = rank
            print(f"  #{rank + 1}  x{c.count} ({c.frequency:.0%})  {c.smiles or cid}{mark}")
        if hit_rank == 0:
            hits += 1
        print(f"  consensus {'HIT' if hit_rank == 0 else 'miss'}"
              f"{'' if hit_rank in (None, 0) else f' (rank {hit_rank + 1})'}")
    print(f"\nconsensus Top-1: {hits}/{args.targets}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
