"""Measure atom-count-free ("n-free") elucidation against the protocol that
knows the atom count (the port's counterpart of ``tools/nfree_eval.py``,
with flags in place of its variables).

The reference protocol feeds the true atom count (hydrogens included) of
every target into sampling, which a user of an elucidation service does
not have. On held-out targets of the synthetic set's test split:

  A (n-known): ``--k-known`` consensus draws at the true atom count.
  B (n-free):  ``--k-per-n`` draws at each count the train histogram makes
               plausible (``Elucidator._plausible_n``, 95% of the prior),
               consensus over all draws, ties to the likelier count.
  C (head):    with ``--count-head``, draws at the counts the head predicts
               (``top_counts(0.9, cap=3)``), ties to the likelier count.

Each protocol batches its queries through ``Elucidator.elucidate_batch``,
``8 * k_known`` rows a round. Scoring is 2-D graph identity
(``canonical_id``, the WL hash), for all targets and for the targets whose
graph never occurs in the train split (``unseen``) or does (``seen``):

    python -m diffspectra_tpu_torch.tools.nfree_eval \\
        --count-head artifacts/atom_count_head.npz --out exp/nfree_eval.json

On the CPU at a small size (the figures then mean nothing):

    python -m diffspectra_tpu_torch.tools.nfree_eval --device cpu --size 64 \\
        --nt 2 --k-known 2 --k-per-n 1 --steps 2 \\
        --count-head artifacts/atom_count_head.npz --out /tmp/nfree.json

Runs on ``cuda`` unless ``--device cpu`` is given. Prints the figures as
JSON and ``NFREE_EVAL OK`` as the last line, and writes the JSON to
``--out``. The synthetic set is kept in ``data/synthetic_cache/`` of the
repository.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNTH_CACHE = os.path.join(ROOT, "data", "synthetic_cache")
QPR_A = 8  # queries a round of protocol A; every protocol's rounds hold 8 * k_known rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm-state", default="artifacts/warm_qm9s_ir.npz")
    p.add_argument("--size", type=int, default=131072, help="synthetic set size")
    p.add_argument("--fidelity", type=int, default=2,
                   help="spectrum fidelity (2: the data warm_qm9s_ir trained on)")
    p.add_argument("--nt", type=int, default=512, help="number of targets")
    p.add_argument("--k-known", type=int, default=10, help="draws a query, protocol A")
    p.add_argument("--k-per-n", type=int, default=2, help="draws a count, protocol B")
    p.add_argument("--method", default="dpm_solver_sde", help="sampling.method")
    p.add_argument("--steps", type=int, default=100, help="sampling.steps")
    p.add_argument("--count-head", default="", help="an atom-count head: run protocol C")
    p.add_argument("--skip-ab", action="store_true", help="run protocol C alone")
    p.add_argument("--out", default="exp/nfree_eval.json", help="the JSON's path")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def prepare(el, raw, size: int, nt: int) -> dict:
    """The targets and what they are scored by: ``nt`` molecules of the
    test split (split ``default_rng(42)``, order ``default_rng(7)``), their
    canonical ids, ``unseen`` (the graph's WL hash absent from the train
    split), ir spectra and true atom counts."""
    from diffspectra_tpu_torch.data.pipeline import _conditional_splits
    from diffspectra_tpu_torch.evaluation.molgraph import canonical_id, from_decoded

    first, second, _val, test = _conditional_splits(np.random.default_rng(42), size)
    train = np.concatenate([first, second])
    decoder = el.dataset_info["atom_decoder"]

    def graph(m):
        n = int(raw["num_atom"][m])
        return from_decoded((raw["pos"][m, :n], raw["atom_type"][m, :n],
                             raw["edge_type"][m, :n, :n], raw["fc"][m, :n]), decoder)

    logging.info("hashing train split for the unseen column (%d mols)", len(train))
    train_hashes = {graph(m).wl_hash() for m in train}
    perm = np.random.default_rng(7).permutation(len(test))[:nt]
    targets = [int(test[i]) for i in perm]
    graphs = [graph(m) for m in targets]
    return {"targets": targets, "ids": [canonical_id(g) for g in graphs],
            "unseen": np.array([g.wl_hash() not in train_hashes for g in graphs], bool),
            "spectra": [np.asarray(raw["ir"][m], np.float32) for m in targets],
            "true_ns": [int(raw["num_atom"][m]) for m in targets]}


def score(rank_ids, t_ids, unseen) -> dict:
    """Top-1 and in-list rates over all targets, the unseen and the seen;
    ``rank_ids`` holds each query's candidate ids, best first."""
    top1 = np.array([r[0] == t for r, t in zip(rank_ids, t_ids)], bool)
    inlist = np.array([t in r for r, t in zip(rank_ids, t_ids)], bool)

    def col(mask):
        m = np.asarray(mask, bool)
        denom = max(1, int(m.sum()))
        return {"top1": float(top1[m].sum() / denom), "in_list": float(inlist[m].sum() / denom),
                "n": int(m.sum())}

    unseen = np.asarray(unseen, bool)
    return {"aggregate": col(np.ones(len(t_ids), bool)), "unseen": col(unseen),
            "seen": col(~unseen)}


def tally(tallies, results) -> None:
    """Add each query's candidates into its ``{id: [count, n_atoms,
    first seen]}``."""
    from diffspectra_tpu_torch.evaluation.molgraph import canonical_id

    for qi, r in enumerate(results):
        for c in r.candidates:
            cid = canonical_id(c.molgraph)
            ent = tallies[qi].get(cid)
            if ent is None:
                tallies[qi][cid] = [c.count, c.molgraph.n_atoms, len(tallies[qi])]
            else:
                ent[0] += c.count


def rank_tally(tally_q: dict, n_prob: dict) -> list:
    """One query's ids by descending count, then by the probability of
    their atom count (the prior in B, the head's in C), then first seen."""
    ranked = sorted(tally_q.items(),
                    key=lambda kv: (-kv[1][0], -n_prob.get(kv[1][1], 0.0), kv[1][2]))
    return [cid for cid, _ in ranked]


def top1_count_correct(ranks, tallies, true_ns) -> float:
    """How often the top-ranked candidate has the true atom count."""
    hits = sum(int(tallies[qi][r[0]][1] == n) for qi, (r, n) in enumerate(zip(ranks, true_ns))
               if r)
    return hits / len(true_ns)


def count_sets(probs, k_known: int):
    """``(sets, n_ranks, k_head)``: each query's ``top_counts(0.9, cap=3)``,
    the most counts any query has, and the draws a count."""
    from diffspectra_tpu_torch.models.atom_count import top_counts

    sets = top_counts(probs, coverage=0.9, cap=3)
    n_ranks = max(len(c) for c, _ in sets)
    return sets, n_ranks, max(2, k_known // max(1, n_ranks))


def head_probs(el, head, spectra, bs: int = 256) -> np.ndarray:
    """The head's count probabilities from ``el``'s SpecFormer, ``bs``
    spectra a call."""
    from diffspectra_tpu_torch.models import atom_count

    out = []
    with torch.no_grad():
        for i in range(0, len(spectra), bs):
            rows = np.stack([np.log10(s + 1.0) for s in spectra[i:i + bs]]).astype(np.float32)
            emb = atom_count.encode_spec_pooled(el.model, [torch.from_numpy(rows).to(el.device)])
            out.append(atom_count.predict_count_probs(head, emb).cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(levelname)s %(message)s", stream=sys.stdout)
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.evaluation.molgraph import canonical_id
    from diffspectra_tpu_torch.models import atom_count

    cfg = configs.get_config()
    cfg.data.spectra_version = "ir"
    cfg.sampling.method = args.method
    cfg.sampling.steps = args.steps
    el = Elucidator.from_warm_state(args.warm_state, config=cfg, device=args.device)

    raw = generate(seed=42, size=args.size, max_n=29, fidelity=args.fidelity,
                   cache_dir=SYNTH_CACHE)
    t = prepare(el, raw, args.size, args.nt)
    nt, spectra, true_ns = args.nt, t["spectra"], t["true_ns"]
    logging.info("%d targets (%d unseen-graph)", nt, int(t["unseen"].sum()))

    ns = el._plausible_n()
    rows = QPR_A * args.k_known
    qpr_b = max(1, rows // args.k_per_n)
    logging.info("plausible counts %s; round rows %d (qpr A=%d B=%d)", ns, rows, QPR_A, qpr_b)
    results = {"warm": args.warm_state, "fidelity": args.fidelity, "targets": nt,
               "unseen_targets": int(t["unseen"].sum()), "method": args.method,
               "steps": args.steps, "plausible_counts": ns}

    if not args.skip_ab:
        # A: the true atom count
        t0 = time.time()
        res_a = el.elucidate_batch(spectra, true_ns, num_candidates=args.k_known, seed=11,
                                   queries_per_round=QPR_A)
        rank_a = [[canonical_id(c.molgraph) for c in r.candidates] for r in res_a]
        wall = time.time() - t0
        results["n_known"] = {**score(rank_a, t["ids"], t["unseen"]),
                              "draws_per_query": args.k_known, "wall_s": wall,
                              "ms_per_query": 1000.0 * wall / nt}
        logging.info("A (n-known, K=%d): %s wall %.1fs", args.k_known,
                     results["n_known"]["aggregate"], wall)

        # B: the count marginalised over the train histogram's plausible counts
        hist = el.dataset_info["train_n_nodes"]
        total = sum(hist.values()) or 1
        prior = {int(k): v / total for k, v in hist.items()}
        t0 = time.time()
        tallies = [dict() for _ in range(nt)]
        for n in ns:
            tally(tallies, el.elucidate_batch(spectra, [n] * nt, num_candidates=args.k_per_n,
                                              seed=100 + n, queries_per_round=qpr_b))
        rank_b = [rank_tally(tq, prior) for tq in tallies]
        wall = time.time() - t0
        results["n_free"] = {**score(rank_b, t["ids"], t["unseen"]),
                             "draws_per_query": args.k_per_n * len(ns), "wall_s": wall,
                             "ms_per_query": 1000.0 * wall / nt,
                             "top1_count_correct": top1_count_correct(rank_b, tallies, true_ns)}
        logging.info("B (n-free, %d counts x K=%d): %s wall %.1fs", len(ns), args.k_per_n,
                     results["n_free"]["aggregate"], wall)

    if args.count_head:
        # C: the counts the head predicts
        head, hmeta = atom_count.load_head(args.count_head, el.device)
        probs = head_probs(el, head, spectra)
        csets, n_ranks, k_head = count_sets(probs, args.k_known)
        count_top1 = float((probs.argmax(-1) == np.asarray(true_ns)).mean())
        count_cover = float(np.mean([n in c for (c, _), n in zip(csets, true_ns)]))
        logging.info("C: head %s (meta %s) | eval-target count top-1 %.4f, top_counts cover "
                     "%.4f, max ranks %d, K/count %d", args.count_head, hmeta, count_top1,
                     count_cover, n_ranks, k_head)
        t0 = time.time()
        tallies = [dict() for _ in range(nt)]
        for r in range(n_ranks):
            ns_r = [c[min(r, len(c) - 1)] for c, _ in csets]
            tally(tallies, el.elucidate_batch(spectra, ns_r, num_candidates=k_head, seed=500 + r,
                                              queries_per_round=max(1, rows // k_head)))
        rank_c = [rank_tally(tq, dict(zip(*cs))) for tq, cs in zip(tallies, csets)]
        wall = time.time() - t0
        results["n_free_head"] = {**score(rank_c, t["ids"], t["unseen"]),
                                  "draws_per_query": k_head * n_ranks, "wall_s": wall,
                                  "ms_per_query": 1000.0 * wall / nt, "count_top1": count_top1,
                                  "count_cover90": count_cover, "head": args.count_head,
                                  "head_meta": hmeta,
                                  "top1_count_correct": top1_count_correct(rank_c, tallies,
                                                                           true_ns)}
        logging.info("C (n-free head, <=%d counts x K=%d): %s wall %.1fs", n_ranks, k_head,
                     results["n_free_head"]["aggregate"], wall)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    print("NFREE_EVAL OK")
    return results


if __name__ == "__main__":
    main()
