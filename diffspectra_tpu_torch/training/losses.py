"""The joint 3D + edge diffusion loss (port of
``diffspectra_tpu/training/losses.py``: ``process_edge_batch``, the reuse of
the spectra encoding, and ``get_sde_graph_loss_fn``, the path of the
flagship's ``pred_edge=True`` without ``only_2D``).

The draws are apart from the arithmetic: ``draw`` takes ``t`` on
``[T_EPS, 1)``, the node and edge noise and the self-conditioning coin
(``use_sc``, one a batch) from generators, with the seeds of the dropout
masks; the loss takes them, so a test can feed JAX's own draws. The
schedule, the model (``model.name``: ``DMT`` or ``DMT_WO_EQ``), its
variant and ``model.include_fc_charge`` come from the config. The 2D loss
and the node loss belong to the CDGS model's 2-D path (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from ..models.layers import seeded_generator
from ..ops.kabsch import get_align_noise, get_align_position, get_align_position_v2
from ..utils import masks as M
from ..utils.scalers import get_self_cond_fn

T_EPS = 1e-5
SEED_LIMIT = 2**62


def parse_loss_weights(loss_weights) -> tuple:
    if isinstance(loss_weights, str):
        return tuple(float(w) for w in loss_weights.split(","))
    return tuple(float(w) for w in loss_weights)


MODEL_NAMES = ("DMT", "DMT_WO_EQ")


def process_edge_batch(batch, scaler, model_name: str, include_charges: bool = True):
    """Normalise and pack a dense batch of tensors (keys positions,
    atom_mask, edge_mask, atom_one_hot, edge_one_hot, formal_charges,
    context) into ``(xh [B, N, 3+A+1], edge_x, node_mask [B, N, 1],
    edge_mask, context)``; without ``include_charges`` the charge is a
    zero-width channel and ``xh`` is ``[B, N, 3+A]``. The DMT's positions
    are centred; DMT_WO_EQ keeps the translation of the augmentation.
    Another ``model_name`` raises."""
    node_mask = batch["atom_mask"][..., None]
    edge_mask = batch["edge_mask"]
    atom_type = batch["atom_one_hot"]
    fc_charge = batch["formal_charges"] if include_charges else atom_type[..., :0]
    if model_name not in MODEL_NAMES:
        raise NotImplementedError(f"{model_name} not supported yet!")
    pos = batch["positions"]
    if model_name == "DMT":
        pos = M.remove_mean_with_mask(pos, node_mask)
    pos, atom_type, fc_charge, edge_type = scaler(
        pos, atom_type, fc_charge, node_mask, batch["edge_one_hot"], edge_mask,
    )
    xh = torch.cat([pos, atom_type, fc_charge], dim=2)
    return xh, edge_type, node_mask, edge_mask, batch.get("context")


def draw(generator: torch.Generator, host_generator: torch.Generator, batch,
         n_layers: int, include_charges: bool = True) -> dict:
    """One train step's draws for ``batch``: ``t [B]``, ``noise [B, N, 3+F]``
    (CoM-free positions; F the atom types, plus the charge with
    ``include_charges``), ``edge_noise [B, N, N, C]`` (symmetric) from
    ``generator`` on the batch's device; ``use_sc`` and ``seeds`` (the
    encoder's and each block's dropout seed for the two forwards,
    ``2 * n_layers + 1`` integers) from ``host_generator`` on the CPU, so
    the host never waits for the device."""
    node_mask = batch["atom_mask"][..., None]
    bs, n = batch["atom_mask"].shape
    feat = batch["atom_one_hot"].shape[-1]
    if include_charges:
        feat += batch["formal_charges"].shape[-1]
    dev = node_mask.device
    t = torch.rand((bs,), generator=generator, device=dev) * (1.0 - T_EPS) + T_EPS
    noise = M.sample_combined_position_feature_noise(generator, bs, n, feat, node_mask)
    edge_noise = M.sample_symmetric_edge_feature_noise(
        generator, bs, n, batch["edge_one_hot"].shape[-1], batch["edge_mask"])
    use_sc = bool(torch.rand((), generator=host_generator) < 0.5)
    seeds = torch.randint(0, SEED_LIMIT, (2 * n_layers + 1,), generator=host_generator)
    return dict(t=t, noise=noise, edge_noise=edge_noise, use_sc=use_sc, seeds=seeds.tolist())


def get_sde_graph_loss_fn(noise_scheduler, scaler, config):
    """``loss_fn(model, batch, draws) -> loss``, a 0-d tensor. In training
    mode the model draws its dropout masks from ``draws["seeds"]`` and its
    SpecFormer updates its running batch statistics in place (once a step
    with ``model.reuse_cond_emb``, where the spectra are encoded once for
    both self-conditioning forwards; else once a forward)."""
    reduce_mean = config.training.reduce_mean
    noise_align = config.model.noise_align
    pred_data = config.model.pred_data
    w_pos, w_atom, w_edge = parse_loss_weights(config.model.loss_weights)
    self_cond = config.model.self_cond
    cond_process_fn = get_self_cond_fn(config) if self_cond else None
    reuse_cond_emb = bool(config.model.reuse_cond_emb and self_cond)
    include_charges = bool(config.model.include_fc_charge)
    model_name = config.model.name

    def loss_fn(model, batch, draws):
        xh, edge_x, node_mask, edge_mask, context = process_edge_batch(
            batch, scaler, model_name, include_charges)
        bs = xh.shape[0]
        n_atoms = node_mask[..., 0].sum(dim=-1)
        t, noise, edge_noise = draws["t"], draws["noise"], draws["edge_noise"]
        alpha_t, sigma_t = noise_scheduler.marginal_prob(t)
        a, s = alpha_t[:, None, None], sigma_t[:, None, None]
        z_t = a * xh + s * noise
        edge_z_t = a[..., None] * edge_x + s[..., None] * edge_noise

        # the clean positions rotated onto the noisy frame (DMT_WO_EQ's
        # both centred first)
        align_pos = xh[:, :, :3]
        if noise_align:
            if pred_data and model_name == "DMT":
                align_pos = get_align_position(z_t, xh)
            elif pred_data:
                centred = (M.remove_mean_with_mask(x[:, :, :3], node_mask) for x in (z_t, xh))
                align_pos = get_align_position_v2(*centred)
            else:
                noise = get_align_noise(z_t, xh, alpha_t, sigma_t, noise, node_mask)
        noise_level = torch.log(alpha_t**2 / sigma_t**2)

        seeds = draws.get("seeds") if model.training else None
        n_layers = len(model.blocks)
        seeds_of = lambda i: None if seeds is None else seeds[1 + i * n_layers: 1 + (i + 1) * n_layers]
        encoder_gen = seeded_generator(None if seeds is None else seeds[0], xh.device)
        # in eval mode every encoding of the spectra is the same
        ctx = (model.encode_context(context, encoder_gen)
               if reuse_cond_emb or not model.training else None)

        def call_model(cond_x, cond_edge_x, has_cond, block_seeds):
            c = ctx if ctx is not None else model.encode_context(context, encoder_gen)
            return model(t, z_t, node_mask, edge_mask, edge_z_t, noise_level, cond_x,
                         cond_edge_x, has_cond, c, block_seeds)

        zeros_x, zeros_e = torch.zeros_like(xh), torch.zeros_like(edge_x)
        if self_cond and draws["use_sc"]:
            with torch.no_grad():
                cond_x, cond_edge_x = call_model(zeros_x, zeros_e, False, seeds_of(0))
            cond_x, cond_edge_x = cond_process_fn(cond_x, cond_edge_x)
            pred, edge_pred = call_model(cond_x, cond_edge_x, True, seeds_of(1))
        else:
            pred, edge_pred = call_model(zeros_x, zeros_e, False, seeds_of(1))

        if pred_data:
            losses_pos = (pred[:, :, :3] - align_pos).square().mean(-1).sum(-1)
            losses_atom = (pred[:, :, 3:] - xh[:, :, 3:]).square().mean(-1).sum(-1)
            losses_edge = (edge_x - edge_pred).square().mean(-1).reshape(bs, -1).sum(-1)
        else:
            sq_atom = (noise - pred).square()
            losses_pos = sq_atom[:, :, :3].mean(-1).sum(-1)
            losses_atom = sq_atom[:, :, 3:].mean(-1).sum(-1)
            losses_edge = (edge_noise - edge_pred).square().mean(-1).reshape(bs, -1).sum(-1)
        if reduce_mean:
            losses_pos = losses_pos / n_atoms
            losses_atom = losses_atom / n_atoms
            losses_edge = losses_edge / (edge_mask.reshape(bs, -1).sum(-1) + 1e-8)
        losses = w_pos * losses_pos + w_atom * losses_atom + w_edge * losses_edge
        if pred_data:
            losses = torch.sqrt(alpha_t / sigma_t) * losses  # the SNR weight
        return losses.mean()

    return loss_fn
