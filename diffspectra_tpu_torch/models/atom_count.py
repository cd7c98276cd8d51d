"""Spectrum-conditioned atom-count head for atom-count-free elucidation
(port of ``diffspectra_tpu/models/atom_count.py``).

A small MLP over the trained SpecFormer's pooled spectrum embedding gives
the distribution of the atom count, so ``elucidate(n_atoms=None)`` samples
only the few counts the spectrum supports. The head is read from
``artifacts/atom_count_head.npz`` (``p/<layer>/<kernel|bias>`` arrays and a
``__meta__`` JSON with ``max_n`` and ``hidden``).
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .layers import Dense, gelu


class AtomCountHead(nn.Module):
    """MLP over the pooled embedding -> atom-count logits ``[B, max_n + 1]``
    (index = atom count, hydrogens included)."""

    def __init__(self, in_dim: int, max_n: int = 29, hidden: int = 256):
        super().__init__()
        self.max_n, self.hidden = max_n, hidden
        self.fc1 = Dense(in_dim, hidden)
        self.fc2 = Dense(hidden, hidden)
        self.out = Dense(hidden, max_n + 1)

    def forward(self, emb):
        return self.out(gelu(self.fc2(gelu(self.fc1(emb)))))


def encode_spec_pooled(model, specs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The pooled ``[B, hidden]`` SpecFormer embedding of a trained DMT
    (``encode_context`` without ``cond_lin``)."""
    return model.cond_encoder(specs)


def load_head(path: str, device=None) -> Tuple[AtomCountHead, dict]:
    """``(head in eval mode on device, meta)`` from a saved head; ``None``
    means ``cuda``, which raises without CUDA."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["__meta__"]))
        state = {k[len("p/"):].replace("/", "."): torch.from_numpy(np.asarray(npz[k], np.float32))
                 for k in npz.files if k.startswith("p/")}
    head = AtomCountHead(int(state["fc1.kernel"].shape[0]), max_n=int(meta["max_n"]),
                         hidden=int(meta["hidden"]))
    head.load_state_dict(state, strict=True)
    return head.eval().to(device), meta


def predict_count_probs(head: AtomCountHead, emb: torch.Tensor) -> torch.Tensor:
    """``[B, max_n + 1]`` softmax count distribution."""
    return torch.softmax(head(emb), dim=-1)


def top_counts(probs, coverage: float = 0.9, cap: int = 4,
               min_n: int = 2) -> List[Tuple[List[int], List[float]]]:
    """Per row: the smallest probability-sorted set of counts covering
    ``coverage`` of the mass (at most ``cap``, counts below ``min_n``
    dropped), as ``(counts, probs)`` by descending probability."""
    out = []
    for row in np.asarray(probs):
        counts, ps, acc = [], [], 0.0
        for n in np.argsort(-row):
            if n < min_n:
                continue
            counts.append(int(n))
            ps.append(float(row[n]))
            acc += float(row[n])
            if acc >= coverage or len(counts) >= cap:
                break
        out.append((counts, ps))
    return out
