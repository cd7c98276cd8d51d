"""SpecFormer's masked-patch pretraining (port of
``diffspectra_tpu/training/pretrain.py``).

A random share (``pretrain.mask_ratio``) of each spectrum's patches is
zeroed before the projection, the encoder runs over the corrupted tokens,
and a linear head a spectrum (``recon_head_<i>``, ``i`` the spectrum's
index in uv, ir, raman) reconstructs the raw patch values; the loss is the
mean squared error over the masked patches, averaged over spectra. The
encoder is named ``cond_encoder``, as in the DMT, and its parameters and
batch statistics are saved in the JAX package's ``.npz`` layout
(``params|<flax path>``, ``batch_stats|<flax path>``, kernels ``[in,
out]``), which ``models/pretrained.py`` of either package merges into a
DMT.

The draws are apart from the arithmetic, as ``training/losses.py::draw``:
``draw_masks`` takes the masks from a generator on the device and the
dropout seed from one on the host, and ``get_pretrain_step``'s step takes
them. The optimizer is the JAX package's optax chain written out:
``clip_by_global_norm(grad_clip)``, then AdamW (b1 0.9, b2 0.999, eps
1e-8, the weight decay on every leaf) at the learning rate of
``warmup_cosine_decay_schedule(0, lr, warmup, max(n_iters, warmup + 1))``
read at the count before the update (0 at the first).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.layers import Dense, seeded_generator
from ..models.specformer import SpecFormer, patch_count, unfold_patches, used_spectra_indices
from .optim import _bias_correction
from .train_state import params_of

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SEED_LIMIT = 2**62
CKPT_NAME = "specformer_pretrained.npz"


class SpecFormerPretrainer(nn.Module):
    """``forward(specs, patch_masks, generator=None) -> preds``: a
    ``[B, n_patches_i, patch_len_i]`` reconstruction a spectrum."""

    def __init__(self, patch_len=(20, 50, 50), stride=(10, 25, 25), output_dim: int = 256,
                 spectra_version: str = "ir", dropout: float = 0.0):
        super().__init__()
        self.cond_encoder = SpecFormer(spectra_version, patch_len, stride, output_dim=output_dim,
                                       dropout=dropout)
        self.used = used_spectra_indices(spectra_version)
        self.patch_len, self.stride = tuple(patch_len), tuple(stride)
        for i in self.used:
            setattr(self, f"recon_head_{i}", Dense(self.cond_encoder.d_model, self.patch_len[i]))

    def forward(self, specs, patch_masks, generator=None):
        _, tokens = self.cond_encoder(specs, generator, patch_masks, return_tokens=True)
        preds, off = [], 0
        for i, spec in zip(self.used, self.cond_encoder.normalize_context(specs)):
            n_i = patch_count(spec.shape[-1], self.patch_len[i], self.stride[i])
            preds.append(getattr(self, f"recon_head_{i}")(tokens[:, off : off + n_i]))
            off += n_i
        return tuple(preds)

    @staticmethod
    def from_config(config) -> "SpecFormerPretrainer":
        return SpecFormerPretrainer(
            patch_len=tuple(config.model.patch_len), stride=tuple(config.model.stride),
            output_dim=config.model.nf, spectra_version=config.data.spectra_version,
            dropout=config.pretrain.dropout)


def masked_recon_loss(preds, specs, patch_masks, patch_len, stride, used) -> torch.Tensor:
    """The squared error over the masked patches, over their values, a
    spectrum; then the mean over spectra."""
    total = 0.0
    for slot, i in enumerate(used):
        target = unfold_patches(specs[slot], patch_len[i], stride[i])
        m = patch_masks[slot][..., None]
        se = (m * (preds[slot] - target) ** 2).sum()
        total = total + se / torch.clamp(m.sum() * patch_len[i], min=1.0)
    return total / len(used)


def draw_masks(generator: torch.Generator, host_generator: torch.Generator,
               model: SpecFormerPretrainer, specs: Sequence[torch.Tensor],
               mask_ratio: float) -> dict:
    """One step's draws: ``masks``, a float ``[B, n_patches_i]`` a
    spectrum, each patch 1 with probability ``mask_ratio`` (from
    ``generator``, on the spectra's device); ``seed``, the dropout seed
    (from ``host_generator``)."""
    masks = tuple(
        (torch.rand((s.shape[0], patch_count(s.shape[-1], model.patch_len[i], model.stride[i])),
                    generator=generator, device=s.device) < mask_ratio).to(s.dtype)
        for i, s in zip(model.used, specs))
    seed = int(torch.randint(0, SEED_LIMIT, (), generator=host_generator))
    return dict(masks=masks, seed=seed)


def warmup_cosine_lr(pcfg, count: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(n_iters,
    warmup + 1))`` at ``count``, in float32."""
    f32 = np.float32
    lr, warmup = f32(pcfg.lr), int(pcfg.warmup)
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(-lr) * frac + lr)
    decay = f32(max(int(pcfg.n_iters), warmup + 1) - warmup)
    c = min(f32(count - warmup), decay)
    return float(lr * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / decay, dtype=f32))))


class PretrainOptimizer:
    """``init(params) -> state``; ``update(grads, state, params)`` applies
    the step to ``params`` in place."""

    def __init__(self, pcfg):
        self.pcfg = pcfg
        self.grad_clip, self.weight_decay = float(pcfg.grad_clip), float(pcfg.weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> dict:
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        clip = torch.tensor(self.grad_clip, device=gnorm.device)
        g = [torch.where(gnorm < clip, t, t / gnorm * clip) for t in g]
        mu, nu = [state["mu"][k] for k in names], [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(ADAM_B1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(ADAM_B2, count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        u = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_mul_(u, -warmup_cosine_lr(self.pcfg, state["count"]))
        torch._foreach_add_(p, u)
        state["count"] = count
        return state


def get_pretrain_step(model: SpecFormerPretrainer, tx: PretrainOptimizer):
    """``step(opt_state, specs, draws) -> (opt_state, loss)``: the masked
    loss in training mode (BatchNorm on the batch's statistics, moving the
    running ones), its gradient (zeros where a parameter does not reach the
    loss, as ``jax.grad``), the optimizer step."""

    def step(opt_state, specs, draws):
        model.train()
        params = params_of(model)
        specs = model.cond_encoder.normalize_context(specs)
        generator = seeded_generator(draws["seed"], specs[0].device)
        preds = model(specs, draws["masks"], generator)
        loss = masked_recon_loss(preds, specs, draws["masks"], model.patch_len, model.stride,
                                 model.used)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        return tx.update(grads, opt_state, params), loss.detach()

    return step


def _encoder_layout(encoder: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The encoder's tensors as ``{"params": {flax path: array},
    "batch_stats": {...}}``."""
    buffers = {name for name, _ in encoder.named_buffers()}
    out = {"params": {}, "batch_stats": {}}
    for key, value in encoder.state_dict().items():
        tree = "batch_stats" if key in buffers else "params"
        out[tree][key.replace(".", "/")] = value.detach().float().cpu().numpy()
    return out


def save_specformer_ckpt(path: str, model: SpecFormerPretrainer) -> None:
    """The pretrainer's ``cond_encoder`` as an ``.npz`` of ``params|<path>``
    and ``batch_stats|<path>`` arrays."""
    layout = _encoder_layout(model.cond_encoder)
    flat = {f"{tree}|{k}": v for tree, leaves in layout.items() for k, v in leaves.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_specformer_npz(path: str):
    """``(params, batch_stats)`` of an ``.npz`` that either package's
    ``save_specformer_ckpt`` wrote, each ``{flax path: array}``."""
    params, stats = {}, {}
    with np.load(path) as data:
        for key in data.files:
            tree, rest = key.split("|", 1)
            (params if tree == "params" else stats)[rest] = data[key]
    return params, stats


def pretrain_specformer(config, workdir: str, device=None) -> SpecFormerPretrainer:
    """Pretrain on the spectra of the train split (its second half) for
    ``pretrain.n_iters`` steps at ``pretrain.batch_size`` (0:
    ``training.base_batch_size``), on ``cuda`` unless ``device="cpu"``; logs
    the loss and spectra/s every ``pretrain.log_freq`` steps and writes
    ``<workdir>/specformer_pretrained.npz`` every ``pretrain.snapshot_freq``
    steps and at the last. A non-finite loss at a log line raises."""
    from ..data.pipeline import get_batch_iterator, get_dataset, inf_iterator, prefetch
    from ..warm_state import init_variables, load_model_state

    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    pcfg = config.pretrain
    _, train_ds, _, _, _ = get_dataset(config)
    batch_size = pcfg.batch_size or config.training.base_batch_size
    spectra_version = config.data.spectra_version
    it = prefetch(inf_iterator(lambda epoch: get_batch_iterator(
        train_ds, batch_size, spectra_version, shuffle=True, seed=config.seed + epoch,
        drop_last=True)), size=2)

    model = SpecFormerPretrainer.from_config(config)
    load_model_state(model, init_variables(model, config.seed))
    model.to(device).train()
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("pretrain model size: %.1fMB", n_params * 4 / 2**20)
    tx = PretrainOptimizer(pcfg)
    opt_state = tx.init(params_of(model))
    step_fn = get_pretrain_step(model, tx)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    host_generator = torch.Generator().manual_seed(config.seed)
    path = os.path.join(workdir, CKPT_NAME)

    t_last = time.time()
    for step in range(1, pcfg.n_iters + 1):
        batch = next(it)
        specs = tuple(torch.from_numpy(c).to(device, non_blocking=True) for c in batch["context"])
        draws = draw_masks(generator, host_generator, model, specs, pcfg.mask_ratio)
        opt_state, loss = step_fn(opt_state, specs, draws)
        if step % pcfg.log_freq == 0:
            loss_val = float(loss)
            dt = time.time() - t_last
            t_last = time.time()
            logging.info("pretrain step: %d, loss: %.5e, spectra/sec: %.1f", step, loss_val,
                         pcfg.log_freq * batch_size / dt)
            if not math.isfinite(loss_val):
                raise FloatingPointError(f"non-finite pretraining loss at step {step}")
        if step % pcfg.snapshot_freq == 0 or step == pcfg.n_iters:
            save_specformer_ckpt(path, model)
            logging.info("pretrain checkpoint saved: %s", path)
    return model
