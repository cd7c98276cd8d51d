"""Spectrum-conditioned atom-count head for atom-count-free elucidation
(port of ``diffspectra_tpu/models/atom_count.py``).

A small MLP over the trained SpecFormer's pooled spectrum embedding gives
the distribution of the atom count, so ``elucidate(n_atoms=None)`` samples
only the few counts the spectrum supports. The head is read from and
written to the JAX package's layout (``artifacts/atom_count_head.npz``:
``p/<layer>/<kernel|bias>`` float32 arrays, kernels ``[in, out]``, and a
``__meta__`` JSON with ``max_n`` and ``hidden``), so either package reads a
head the other trained. ``tools/train_atom_count.py`` trains one.
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..warm_state import init_variables, load_model_state
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


def _head_from_state(state: dict, max_n: int, hidden: int, device) -> AtomCountHead:
    head = AtomCountHead(int(state["fc1.kernel"].shape[0]), max_n=max_n, hidden=hidden)
    head.load_state_dict(state, strict=True)
    return head.eval().to(resolve_device(device))


def load_head(path: str, device=None) -> Tuple[AtomCountHead, dict]:
    """``(head in eval mode on device, meta)`` from a saved head; ``None``
    means ``cuda``, which raises without CUDA."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["__meta__"]))
        state = {k[len("p/"):].replace("/", "."): torch.from_numpy(np.asarray(npz[k], np.float32))
                 for k in npz.files if k.startswith("p/")}
    return _head_from_state(state, int(meta["max_n"]), int(meta["hidden"]), device), meta


def save_head(path: str, head: AtomCountHead, meta: dict | None = None) -> None:
    """Write ``head`` as the JAX package's ``save_head`` writes its params:
    ``p/fc1/kernel`` ... ``p/out/bias`` as float32 arrays and ``__meta__``,
    the JSON of ``{"max_n", "hidden", **meta}``, through
    ``np.savez_compressed``."""
    out = {f"p/{k.replace('.', '/')}": v.detach().cpu().numpy()
           for k, v in head.state_dict().items()}
    out["__meta__"] = np.asarray(json.dumps({"max_n": head.max_n, "hidden": head.hidden,
                                             **(meta or {})}))
    np.savez_compressed(path, **out)


def head_from_params(params: dict, max_n: int = 29, hidden: int = 256,
                     device=None) -> AtomCountHead:
    """The port's head from a JAX head's params as numpy arrays
    (``{"fc1": {"kernel": [in, hidden], "bias": [hidden]}, "fc2": ...,
    "out": ...}``), in eval mode on ``device`` (``None`` means ``cuda``)."""
    state = {f"{layer}.{leaf}": torch.from_numpy(np.array(v, np.float32))
             for layer, sub in params.items() for leaf, v in sub.items()}
    return _head_from_state(state, max_n, hidden, device)


def init_head(in_dim: int, max_n: int = 29, hidden: int = 256, seed: int = 0,
              device=None) -> AtomCountHead:
    """A fresh head with flax's initializers (``lecun_normal`` kernels, zero
    biases) drawn from a ``torch.Generator`` seeded ``seed``: JAX's
    distribution, not its numbers."""
    head = AtomCountHead(in_dim, max_n=max_n, hidden=hidden)
    load_model_state(head, init_variables(head, seed))
    return head.eval().to(resolve_device(device))


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
