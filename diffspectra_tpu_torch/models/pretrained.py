"""A pretrained SpecFormer merged into a model's ``cond_encoder`` (port of
``diffspectra_tpu/models/pretrained.py``).

Two files are read: the reference's PyTorch Lightning checkpoint (its
allspectra+pretrained mode), whose keys are mapped onto the flax paths
below, and the ``.npz`` of ``--mode pretrain`` (``training/pretrain.py``
of either package), whose keys are the flax paths already. The merge is
partial: a tensor of the file lands where the encoder has the same path
and shape, anything else is skipped (a shape mismatch with a warning), and
a file of which nothing matches leaves the model as it was, with a
warning.

Reference key (after ``model.representation_spec_model.``, else
``model.representation_model.``) -> flax path:
  backbone.W_P.{k}.{weight,bias}  -> W_P_{used[k]}/{kernel,bias}
  backbone.W_pos[_uv|_ir|_raman]  -> W_pos[...]
  backbone.encoder.layers.{l}.self_attn.W_{Q,K,V} -> encoder_layer_{l}/self_attn/W_{Q,K,V}
  ...self_attn.to_out.0           -> .../self_attn/to_out
  ...norm_attn.1, norm_ffn.1      -> .../norm_attn, norm_ffn: scale, bias; the running
                                     mean and var to the batch statistics
  ...ff.0, ff.3                   -> .../ff1, ff2
  head.linear                     -> head_linear
  model.representation_model.out_norm -> out_norm (always from this prefix)
Linear weights are transposed (torch ``[out, in]`` -> kernel ``[in, out]``).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from .specformer import used_spectra_indices

PREFIXES = ("model.representation_spec_model", "model.representation_model")


def load_torch_state_dict(ckpt_path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's ``state_dict`` (or the file itself, if it has none)
    as numpy arrays."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        state = ckpt["state_dict"]
    else:
        logging.warning("pretrained checkpoint has no 'state_dict' key; loading raw dict")
        state = ckpt
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def specformer_params_from_torch(state: Dict[str, np.ndarray], spectra_version: str,
                                 n_layers: int = 3) -> Tuple[dict, dict, int]:
    """``(params, batch_stats, n_matched)`` of the SpecFormer, each
    ``{flax path: array}``, from a reference state dict."""
    prefix = next((p for p in PREFIXES if any(k.startswith(p) for k in state)), None)
    if prefix is None:
        logging.warning("No matching prefix found in the state_dict.")
        return {}, {}, 0
    params, stats = {}, {}
    matched = 0

    def get(key):
        nonlocal matched
        full = f"{prefix}.{key}"
        if full in state:
            matched += 1
            return state[full]
        return None

    def linear(name: str, src: str):
        w, b = get(f"{src}.weight"), get(f"{src}.bias")
        if w is not None:
            params[f"{name}/kernel"] = w.T.copy()
            if b is not None:
                params[f"{name}/bias"] = b.copy()

    for k, idx in enumerate(used_spectra_indices(spectra_version)):
        linear(f"W_P_{idx}", f"backbone.W_P.{k}")
    pos_names = (("W_pos_uv", "W_pos_ir", "W_pos_raman") if spectra_version == "allspectra"
                 else ("W_pos",))
    for name in pos_names:
        w = get(f"backbone.{name}")
        if w is not None:
            params[name] = w.copy()
    for layer in range(n_layers):
        base, dst = f"backbone.encoder.layers.{layer}", f"encoder_layer_{layer}"
        for qkv in ("W_Q", "W_K", "W_V"):
            linear(f"{dst}/self_attn/{qkv}", f"{base}.self_attn.{qkv}")
        linear(f"{dst}/self_attn/to_out", f"{base}.self_attn.to_out.0")
        linear(f"{dst}/ff1", f"{base}.ff.0")
        linear(f"{dst}/ff2", f"{base}.ff.3")
        for norm in ("norm_attn", "norm_ffn"):
            w, b = get(f"{base}.{norm}.1.weight"), get(f"{base}.{norm}.1.bias")
            mean, var = get(f"{base}.{norm}.1.running_mean"), get(f"{base}.{norm}.1.running_var")
            if w is not None:
                params[f"{dst}/{norm}/scale"], params[f"{dst}/{norm}/bias"] = w.copy(), b.copy()
            if mean is not None:
                stats[f"{dst}/{norm}/mean"], stats[f"{dst}/{norm}/var"] = mean.copy(), var.copy()
    linear("head_linear", "head.linear")
    # out_norm always comes from representation_model
    for leaf, key in (("scale", "model.representation_model.out_norm.weight"),
                      ("bias", "model.representation_model.out_norm.bias")):
        if key in state:
            params[f"out_norm/{leaf}"] = state[key].copy()
            matched += 1
    return params, stats, matched


def _merge(encoder: torch.nn.Module, flat: Dict[str, np.ndarray]) -> int:
    """Copy each array of ``flat`` whose path and shape the encoder has;
    returns how many."""
    targets = encoder.state_dict()
    n = 0
    with torch.no_grad():
        for path, value in flat.items():
            key = path.replace("/", ".")
            if key not in targets:
                logging.debug("pretrained key %s not in model", path)
                continue
            if tuple(targets[key].shape) != tuple(np.shape(value)):
                logging.warning("shape mismatch for %s: %s vs %s", path,
                                tuple(targets[key].shape), np.shape(value))
                continue
            targets[key].copy_(torch.as_tensor(np.asarray(value, dtype=np.float32)))
            n += 1
    return n


def load_pretrained_specformer(model: torch.nn.Module, ckpt_path: str, spectra_version: str,
                               encoder_name: str = "cond_encoder") -> int:
    """Merge the pretrained SpecFormer of ``ckpt_path`` (``.npz``: the
    pretraining's layout; else the reference's checkpoint) into
    ``model.<encoder_name>`` in place, parameters and batch statistics;
    returns the tensors loaded. The model's bf16 weight copies are made
    anew by the caller's next ``load_state_dict`` or ``refresh_casts``."""
    if ckpt_path.endswith(".npz"):
        from ..training.pretrain import load_specformer_npz

        params, stats = load_specformer_npz(ckpt_path)
        matched = len(params)
    else:
        params, stats, matched = specformer_params_from_torch(
            load_torch_state_dict(ckpt_path), spectra_version)
    if matched == 0:
        logging.warning("No matching keys found in the pretrained SpecFormer model.")
        return 0
    encoder = getattr(model, encoder_name)
    n_loaded = _merge(encoder, params) + _merge(encoder, stats)
    logging.info("Loaded %d tensors from the pretrained SpecFormer model.", n_loaded)
    return n_loaded
