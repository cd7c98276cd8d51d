"""Train the spectrum-conditioned atom-count head (the port's counterpart of
``tools/train_atom_count.py``, with flags in place of its variables).

Freezes the trained SpecFormer of a warm state (the DMT's ``cond_encoder``),
embeds the spectra of the synthetic set's train split, and fits
``models/atom_count.py::AtomCountHead`` with a softmax cross-entropy on the
true atom counts. Reports held-out top-1 and top-3 count accuracy and how
often the ``top_counts(coverage=0.9, cap=4)`` set that serving samples holds
the true count, and writes the head where ``Elucidator.load_count_head``
(and the JAX package's ``load_head``) reads it:

    python -m diffspectra_tpu_torch.tools.train_atom_count \\
        --warm-state artifacts/warm_qm9s_f4.npz --out exp/atom_count_head.npz

On the CPU at a small size (a set under 1,205 molecules gives fewer train
rows than one batch of 1,024, so no step is taken; the head is then its
initialisation):

    python -m diffspectra_tpu_torch.tools.train_atom_count --device cpu \\
        --size 256 --epochs 2 --out /tmp/head.npz

Runs on ``cuda`` unless ``--device cpu`` is given. The output defaults to
``exp/atom_count_head.npz``, never to the committed
``artifacts/atom_count_head.npz``. The synthetic set is kept in
``data/synthetic_cache/`` of the repository.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNTH_CACHE = os.path.join(ROOT, "data", "synthetic_cache")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm-state", default="artifacts/warm_qm9s_f4.npz",
                   help="warm-state export whose SpecFormer embeds the spectra")
    p.add_argument("--size", type=int, default=131072, help="synthetic set size")
    p.add_argument("--fidelity", type=int, default=4, help="spectrum fidelity")
    p.add_argument("--spectra", default="ir", choices=("uv", "ir", "raman", "allspectra"),
                   help="data.spectra_version")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--out", default="exp/atom_count_head.npz", help="the head's .npz")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def embed_all(el, raw, idx, spec_keys, bs: int = 1024) -> np.ndarray:
    """The pooled SpecFormer embeddings ``[len(idx), hidden]`` of the
    molecules ``idx`` of ``raw``, their spectra ``spec_keys`` normalised as
    ``log10(x + 1)`` in float32, ``bs`` rows a call in eval mode (the
    SpecFormer in float32 unless ``model.specformer_bf16``)."""
    from diffspectra_tpu_torch.models import atom_count

    out = []
    with torch.no_grad():
        for i in range(0, len(idx), bs):
            rows = idx[i:i + bs]
            specs = [torch.from_numpy(np.log10(raw[k][rows] + 1.0).astype(np.float32)).to(el.device)
                     for k in spec_keys]
            out.append(atom_count.encode_spec_pooled(el.model, specs).float().cpu().numpy())
    return np.concatenate(out)


def train_head(x, y, epochs: int, bs: int = 1024, lr: float = 1e-3, order_seed: int = 0,
               init=None, max_n: int = 29, device=None):
    """``(head, losses)``: an ``AtomCountHead`` fitted to embeddings ``x``
    and counts ``y`` by Adam (0.9, 0.999, eps 1e-8 outside the square root,
    bias-corrected: ``optax.adam``) on the mean softmax cross-entropy, the
    rows in a ``default_rng(order_seed)`` permutation each epoch, full
    batches only (under ``bs`` rows, no step); ``losses`` holds each epoch's
    mean (0.0 without a step). Starts from a copy of ``init``, else from
    ``init_head(seed=0)``. ``device`` ``None`` means ``cuda``."""
    from diffspectra_tpu_torch.device import resolve_device
    from diffspectra_tpu_torch.models import atom_count

    device = resolve_device(device)
    if init is None:
        head = atom_count.init_head(x.shape[1], max_n=max_n, device=device)
    else:
        head = copy.deepcopy(init).to(device)
    opt = torch.optim.Adam(head.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(device)
    yt = torch.from_numpy(np.asarray(y, np.int64)).to(device)
    n = len(xt)
    order_rng = np.random.default_rng(order_seed)
    losses = []
    head.train()
    for ep in range(epochs):
        order = order_rng.permutation(n)
        tot, nb = 0.0, 0
        for i in range(0, n - bs + 1, bs):
            rows = torch.from_numpy(order[i:i + bs]).to(device)
            loss = F.cross_entropy(head(xt[rows]), yt[rows])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
            nb += 1
        losses.append(tot / max(nb, 1))
        logging.info("epoch %d: loss %.4f", ep, losses[-1])
    return head.eval(), losses


def predict_probs(head, x, bs: int = 1024) -> np.ndarray:
    """``[len(x), max_n + 1]`` count probabilities, ``bs`` rows a call."""
    from diffspectra_tpu_torch.models import atom_count

    device = next(head.parameters()).device
    out = []
    with torch.no_grad():
        for i in range(0, len(x), bs):
            xb = torch.from_numpy(np.asarray(x[i:i + bs], np.float32)).to(device)
            out.append(atom_count.predict_count_probs(head, xb).cpu().numpy())
    return np.concatenate(out)


def held_out_metrics(probs, y) -> dict:
    """Count top-1 and top-3 accuracy, how often ``top_counts(0.9, cap=4)``
    holds the true count, and that set's mean size."""
    from diffspectra_tpu_torch.models.atom_count import top_counts

    probs, y = np.asarray(probs), np.asarray(y)
    top1 = float((probs.argmax(-1) == y).mean())
    order3 = np.argsort(-probs, axis=-1)[:, :3]
    top3 = float(np.any(order3 == y[:, None], axis=1).mean())
    sets = top_counts(probs, coverage=0.9, cap=4)
    covered = float(np.mean([t in counts for (counts, _), t in zip(sets, y)]))
    set_size = float(np.array([len(c) for c, _ in sets]).mean())
    return {"top1": top1, "top3": top3, "cover90": covered, "set_size": set_size}


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(levelname)s %(message)s", stream=sys.stdout)
    from diffspectra_tpu_torch import configs
    from diffspectra_tpu_torch.api import Elucidator
    from diffspectra_tpu_torch.data.pipeline import SPECTRA_KEYS, _conditional_splits
    from diffspectra_tpu_torch.data.synthetic import generate
    from diffspectra_tpu_torch.models import atom_count

    cfg = configs.get_config()
    cfg.data.spectra_version = args.spectra
    el = Elucidator.from_warm_state(args.warm_state, config=cfg, device=args.device)
    max_n = int(cfg.data.max_node)
    raw = generate(seed=42, size=args.size, max_n=max_n, fidelity=args.fidelity,
                   cache_dir=SYNTH_CACHE)
    first, second, _val, test = _conditional_splits(np.random.default_rng(42), args.size)
    train = np.concatenate([first, second])
    labels = np.asarray(raw["num_atom"], np.int64)
    spec_keys = SPECTRA_KEYS[args.spectra]

    t0 = time.time()
    logging.info("embedding %d train + %d test spectra", len(train), len(test))
    x_train = embed_all(el, raw, train, spec_keys)
    x_test = embed_all(el, raw, test, spec_keys)
    logging.info("embeddings done in %.1fs (dim %d)", time.time() - t0, x_train.shape[1])

    head, _ = train_head(x_train, labels[train], args.epochs, max_n=max_n, device=el.device)
    m = held_out_metrics(predict_probs(head, x_test), labels[test])
    logging.info("held-out (%d): count top-1 %.4f top-3 %.4f | top_counts(0.9,cap4) "
                 "covers true n %.4f (mean set size %.2f)", len(test), m["top1"], m["top3"],
                 m["cover90"], m["set_size"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    atom_count.save_head(args.out, head, meta={
        "warm": args.warm_state, "fidelity": args.fidelity, "spectra": args.spectra,
        "test_top1": m["top1"], "test_top3": m["top3"], "test_cover90": m["cover90"]})
    logging.info("saved %s", args.out)
    return m


if __name__ == "__main__":
    main()
