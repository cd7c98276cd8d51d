"""ChemNet, the network of the real Frechet ChemNet Distance (FCD), as a
PyTorch module: the port of ``diffspectra_tpu/evaluation/chemnet.py``.

SMILES are tokenised to one-hots and run through ChemNet (Preuer et al.
2018); the FCD is the Frechet distance between Gaussians fit to the
penultimate activations of the generated and the reference sets. The weight
file is the JAX package's ``.npz``: a JSON ``manifest`` naming an ordered
list of layers (``conv1d``, ``lstm``, ``bilstm``, ``dense``), the SMILES
vocabulary and the pad length, beside the arrays, so a file converted for
the JAX package (``tools/convert_chemnet.py``, which needs ``fcd_torch``)
serves the port unchanged. It is read from ``DIFFSPECTRA_CHEMNET_NPZ`` or
``diffspectra_tpu_torch/data/chemnet.npz``; without it the FCD is NaN.

The layers keep the JAX forward's conventions: a conv kernel ``[K, I, O]``
over ``[B, T, C]`` with XLA's ``SAME`` padding (``(K - 1) // 2`` before,
``K // 2`` after at stride 1); LSTM gates in (i, f, g, o) order with
``W [I, 4H]``, ``U [H, 4H]`` and one bias, the reverse direction run over
the whole padded length (no packing); ``last_only`` takes the forward
direction's last state and the reverse direction's after position 0.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# Default tokenisation (fcd's published scheme): used for random-weight
# tests; real runs take vocab/pad_len from the weight file's manifest.
DEFAULT_VOCAB = [
    "C", "N", "O", "H", "F", "Cl", "P", "B", "Br", "S", "I", "Si",
    "#", "(", ")", "+", "-",
    "1", "2", "3", "4", "5", "6", "7", "8", "9",
    "=", "[", "]", "@", "c", "n", "o", "s", "X", ".",
]
DEFAULT_PAD_LEN = 350
_TWO_CHAR = ("Cl", "Br", "Si")
_ACTIVATIONS = {"selu": F.selu, "tanh": torch.tanh, "relu": F.relu, None: None, "linear": None}


def tokenize(smiles: str, vocab: List[str]) -> List[int]:
    """Greedy two-char-first SMILES tokenisation; unknown -> 'X'."""
    index = {t: i for i, t in enumerate(vocab)}
    unk = index.get("X", 0)
    out = []
    i = 0
    while i < len(smiles):
        tok = smiles[i : i + 2]
        if tok in _TWO_CHAR and tok in index:
            out.append(index[tok])
            i += 2
        else:
            out.append(index.get(smiles[i], unk))
            i += 1
    return out


def one_hot_batch(smiles_list: List[str], vocab: List[str], pad_len: int) -> np.ndarray:
    """[B, pad_len, V] one-hots, padded with the '.' (stop) token."""
    V = len(vocab)
    pad_idx = vocab.index(".") if "." in vocab else V - 1
    out = np.zeros((len(smiles_list), pad_len, V), dtype=np.float32)
    for b, smi in enumerate(smiles_list):
        toks = tokenize(smi, vocab)[:pad_len]
        out[b, np.arange(len(toks)), toks] = 1.0
        out[b, len(toks):, pad_idx] = 1.0
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


class ChemNetModule(nn.Module):
    """The manifest's layer stack over one-hots ``[B, T, V]``."""

    def __init__(self, manifest: dict, params: dict):
        super().__init__()
        self.specs = list(manifest["layers"])
        self.layers = nn.ModuleList()
        for spec in self.specs:
            kind, name = spec["kind"], spec["name"]
            if spec.get("activation") not in _ACTIVATIONS:
                raise ValueError(f"unknown activation {spec.get('activation')!r}")
            if kind == "conv1d":
                k = params[f"{name}.kernel"]  # [K, I, O]
                layer = nn.Conv1d(k.shape[1], k.shape[2], k.shape[0],
                                  stride=spec.get("stride", 1))
                layer.weight.data = _tensor(np.transpose(k, (2, 1, 0)))
                layer.bias.data = _tensor(params[f"{name}.bias"])
            elif kind in ("lstm", "bilstm"):
                W = params[f"{name}.W"]  # [I, 4H]
                H = params[f"{name}.U"].shape[0]
                layer = nn.LSTM(W.shape[0], H, batch_first=True,
                                bidirectional=kind == "bilstm")
                suffixes = [("", "")] + ([("_reverse", "_rev")] if kind == "bilstm" else [])
                for torch_sfx, npz_sfx in suffixes:
                    getattr(layer, f"weight_ih_l0{torch_sfx}").data = _tensor(
                        params[f"{name}.W{npz_sfx}"].T)
                    getattr(layer, f"weight_hh_l0{torch_sfx}").data = _tensor(
                        params[f"{name}.U{npz_sfx}"].T)
                    getattr(layer, f"bias_ih_l0{torch_sfx}").data = _tensor(
                        params[f"{name}.b{npz_sfx}"])
                    getattr(layer, f"bias_hh_l0{torch_sfx}").data = torch.zeros(4 * H)
            elif kind == "dense":
                k = params[f"{name}.kernel"]  # [I, O]
                layer = nn.Linear(k.shape[0], k.shape[1])
                layer.weight.data = _tensor(k.T)
                layer.bias.data = _tensor(params[f"{name}.bias"])
            else:
                raise ValueError(f"unknown ChemNet layer kind {kind!r}")
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for spec, layer in zip(self.specs, self.layers):
            kind = spec["kind"]
            if kind == "conv1d":
                # XLA's SAME: ceil(T / stride) outputs, the padding split
                # with the odd one after
                T, K, s = x.shape[1], layer.kernel_size[0], layer.stride[0]
                total = max((math.ceil(T / s) - 1) * s + K - T, 0)
                x = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
                x = layer(x).transpose(1, 2)
            elif kind in ("lstm", "bilstm"):
                seq, (h_n, _) = layer(x)
                # h_n: the forward direction after the last position, the
                # reverse direction's after position 0
                x = torch.cat(list(h_n), dim=-1) if spec.get("last_only") else seq
            else:
                x = layer(x)
            act = _ACTIVATIONS[spec.get("activation")]
            if act is not None:
                x = act(x)
        return x


class ChemNet:
    """Manifest-driven ChemNet feature extractor."""

    def __init__(self, manifest: dict, params: dict):
        self.manifest = manifest
        self.vocab = list(manifest.get("vocab", DEFAULT_VOCAB))
        self.pad_len = int(manifest.get("pad_len", DEFAULT_PAD_LEN))
        self.params = params
        self._modules = {}

    @classmethod
    def load(cls, path: str) -> "ChemNet":
        with np.load(path, allow_pickle=False) as data:
            manifest = json.loads(str(data["manifest"]))
            params = {k: data[k] for k in data.files if k != "manifest"}
        return cls(manifest, params)

    def save(self, path: str) -> None:
        np.savez(path, manifest=np.str_(json.dumps(self.manifest)), **self.params)

    def module(self, device=None) -> ChemNetModule:
        """The network in eval mode on ``device`` (``cuda`` unless
        ``device="cpu"``), built once a device."""
        device = resolve_device(device)
        if device not in self._modules:
            self._modules[device] = ChemNetModule(self.manifest, self.params).to(device).eval()
        return self._modules[device]

    @torch.no_grad()
    def features(self, smiles_list: List[str], batch_size: int = 512,
                 device=None) -> np.ndarray:
        """Penultimate-layer activations ``[len(smiles_list), D]`` (float32)
        on ``device`` (``cuda`` unless ``device="cpu"``)."""
        net = self.module(device)
        device = next(net.parameters()).device
        outs = []
        for i in range(0, len(smiles_list), batch_size):
            x = one_hot_batch(smiles_list[i : i + batch_size], self.vocab, self.pad_len)
            outs.append(net(torch.from_numpy(x).to(device)).cpu().numpy())
        return np.concatenate(outs, axis=0)


def default_weights_path() -> Optional[str]:
    """``DIFFSPECTRA_CHEMNET_NPZ``, else ``diffspectra_tpu_torch/data/chemnet.npz``,
    where the file exists; else None."""
    for p in (
        os.environ.get("DIFFSPECTRA_CHEMNET_NPZ", ""),
        os.path.join(os.path.dirname(__file__), "..", "data", "chemnet.npz"),
    ):
        if p and os.path.isfile(p):
            return p
    return None


@functools.lru_cache(maxsize=1)
def _load_cached(path: str) -> Optional[ChemNet]:
    try:
        net = ChemNet.load(path)
    except (OSError, ValueError, KeyError) as e:
        logging.warning("ChemNet weights at %s unreadable: %s", path, e)
        return None
    logging.info("ChemNet weights loaded from %s", path)
    return net


def load_default() -> Optional[ChemNet]:
    """ChemNet from the default weight locations (read once a path), or
    None."""
    path = default_weights_path()
    return None if path is None else _load_cached(path)


def fcd_from_smiles(gen_smiles: List[str], ref_smiles: List[str], device=None) -> float:
    """Real FCD between two SMILES sets, ChemNet on ``device`` (``cuda``
    unless ``device="cpu"``); NaN when no weights are installed."""
    net = load_default()
    if net is None or not gen_smiles or not ref_smiles:
        return float("nan")
    from .fingerprints import frechet_distance

    return frechet_distance(net.features(gen_smiles, device=device),
                            net.features(ref_smiles, device=device))


def random_chemnet(seed: int = 0) -> ChemNet:
    """A randomly initialised ChemNet with the fcd-shaped default stack
    (the JAX package's, array for array) - for loader round-trip and
    inference tests only."""
    rng = np.random.default_rng(seed)
    V = len(DEFAULT_VOCAB)

    def r(*shape):
        return rng.normal(0, 0.1, size=shape).astype(np.float32)

    manifest = {
        "vocab": DEFAULT_VOCAB,
        "pad_len": 64,  # short for tests
        "layers": [
            {"kind": "conv1d", "name": "conv0", "activation": "selu", "k": 9},
            {"kind": "bilstm", "name": "lstm0", "last_only": True},
            {"kind": "dense", "name": "dense0", "activation": "linear"},
        ],
    }
    H = 32
    params = {
        "conv0.kernel": r(9, V, 16),
        "conv0.bias": r(16),
        "lstm0.W": r(16, 4 * H), "lstm0.U": r(H, 4 * H), "lstm0.b": r(4 * H),
        "lstm0.W_rev": r(16, 4 * H), "lstm0.U_rev": r(H, 4 * H),
        "lstm0.b_rev": r(4 * H),
        "dense0.kernel": r(2 * H, 24), "dense0.bias": r(24),
    }
    return ChemNet(manifest, params)
