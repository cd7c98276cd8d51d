"""The diffusion losses (port of ``diffspectra_tpu/training/losses.py``):
``process_edge_batch`` and ``get_sde_graph_loss_fn``, the joint 3D + edge
loss of the flagship (``pred_edge=True`` without ``only_2D``), with the
reuse of the spectra encoding; ``process_batch_2d`` and
``get_sde_2d_loss_fn``, the atoms + bonds loss of the 2-D path
(``only_2D``, CDGS); and ``get_sde_node_loss_fn``, the positions + atoms
loss without bonds (``pred_edge=False``), which no model of the JAX
package runs (``ROADMAP.md``).

The draws are apart from the arithmetic: ``draw`` takes ``t`` on
``[T_EPS, 1)``, the node and edge noise and the self-conditioning coin
(``use_sc``, one a batch) from generators, with the seeds of the dropout
masks; the loss takes them, so a test can feed JAX's own draws. The
schedule, the model (``model.name``), its variant and
``model.include_fc_charge`` come from the config.
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


# the graph loss's models (CDGS takes the 2-D loss, which checks no name)
MODEL_NAMES = ("DMT", "DMT_WO_EQ")


def process_edge_batch(batch, scaler, model_name: str, include_charges: bool = True):
    """Normalise and pack a dense batch of tensors (keys positions,
    atom_mask, edge_mask, atom_one_hot, edge_one_hot, formal_charges,
    context) into ``(xh [B, N, 3+A+1], edge_x, node_mask [B, N, 1],
    edge_mask, context)``; without ``include_charges`` the charge is a
    zero-width channel and ``xh`` is ``[B, N, 3+A]``. The DMT's positions
    are centred; DMT_WO_EQ keeps the translation of the augmentation.
    Another ``model_name`` (CDGS too, a 2-D model) raises."""
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


def process_batch_2d(batch, scaler, include_charges: bool = True):
    """The 2-D path's batch: ``(xh [B, N, A+1], edge_x, node_mask [B, N,
    1], edge_mask, context)``, normalised as ``process_edge_batch``'s
    without positions; without ``include_charges`` ``xh`` is ``[B, N,
    A]``."""
    node_mask = batch["atom_mask"][..., None]
    edge_mask = batch["edge_mask"]
    atom_type = batch["atom_one_hot"]
    fc_charge = batch["formal_charges"] if include_charges else atom_type[..., :0]
    _, atom_type, fc_charge, edge_type = scaler(
        None, atom_type, fc_charge, node_mask, batch["edge_one_hot"], edge_mask)
    return torch.cat([atom_type, fc_charge], dim=2), edge_type, node_mask, edge_mask, \
        batch.get("context")


def draw(generator: torch.Generator, host_generator: torch.Generator, batch,
         n_layers: int, include_charges: bool = True, only_2d: bool = False,
         pred_edge: bool = True) -> dict:
    """One train step's draws for ``batch``: ``t [B]``, ``noise [B, N,
    3+F]`` (CoM-free positions; F the atom types, plus the charge with
    ``include_charges``; with ``only_2d`` ``[B, N, F]``, masked, no
    positions), ``edge_noise [B, N, N, C]`` (symmetric; none without
    ``pred_edge``) from ``generator`` on the batch's device; ``use_sc`` and
    ``seeds`` (the encoder's and each block's dropout seed for the two
    forwards, ``2 * n_layers + 1`` integers) from ``host_generator`` on the
    CPU, so the host never waits for the device."""
    node_mask = batch["atom_mask"][..., None]
    bs, n = batch["atom_mask"].shape
    feat = batch["atom_one_hot"].shape[-1]
    if include_charges:
        feat += batch["formal_charges"].shape[-1]
    if not only_2d:
        feat += 3  # the positions
    dev = node_mask.device
    t = torch.rand((bs,), generator=generator, device=dev) * (1.0 - T_EPS) + T_EPS
    out = dict(t=t, noise=M.sample_node_noise(generator, (bs, n, feat), node_mask, only_2d))
    if pred_edge:
        out["edge_noise"] = M.sample_symmetric_edge_feature_noise(
            generator, bs, n, batch["edge_one_hot"].shape[-1], batch["edge_mask"])
    out["use_sc"] = bool(torch.rand((), generator=host_generator) < 0.5)
    seeds = torch.randint(0, SEED_LIMIT, (2 * n_layers + 1,), generator=host_generator)
    out["seeds"] = seeds.tolist()
    return out


def _model_caller(model, draws, context, encode_once: bool, device):
    """``call(*model_args, forward)``: the model's forward ``forward`` (0,
    the self-conditioning one; 1, the other) with the spectra encoding
    (None without ``context``) and, in training mode, its blocks' dropout
    seeds from ``draws["seeds"]``. The spectra are encoded once for both
    forwards with ``encode_once`` or outside training mode (where every
    encoding is the same), else once a forward."""
    seeds = draws.get("seeds") if model.training else None
    n_layers = len(model.blocks)
    encoder_gen = seeded_generator(None if seeds is None else seeds[0], device)
    encode = lambda: None if context is None else model.encode_context(context, encoder_gen)
    ctx = encode() if encode_once or not model.training else None

    def call(t, z_t, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x, has_cond,
             forward):
        block_seeds = (None if seeds is None
                       else seeds[1 + forward * n_layers: 1 + (forward + 1) * n_layers])
        c = ctx if ctx is not None else encode()
        return model(t, z_t, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x,
                     has_cond, c, block_seeds)

    return call


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

        caller = _model_caller(model, draws, context, reuse_cond_emb, xh.device)

        def call_model(cond_x, cond_edge_x, has_cond, forward):
            return caller(t, z_t, node_mask, edge_mask, edge_z_t, noise_level, cond_x,
                          cond_edge_x, has_cond, forward)

        zeros_x, zeros_e = torch.zeros_like(xh), torch.zeros_like(edge_x)
        if self_cond and draws["use_sc"]:
            with torch.no_grad():
                cond_x, cond_edge_x = call_model(zeros_x, zeros_e, False, 0)
            cond_x, cond_edge_x = cond_process_fn(cond_x, cond_edge_x)
            pred, edge_pred = call_model(cond_x, cond_edge_x, True, 1)
        else:
            pred, edge_pred = call_model(zeros_x, zeros_e, False, 1)

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


def get_sde_2d_loss_fn(noise_scheduler, scaler, config):
    """The 2-D path's loss, atoms and bonds without positions:
    ``loss_fn(model, batch, draws) -> loss``, as the graph loss's, on
    ``process_batch_2d``'s batch with ``draw(..., only_2d=True)``'s masked
    node noise; no noise alignment, and the self-conditioning prediction
    goes back in unprocessed, as JAX's 2-D loss passes it. The spectra are
    encoded as in the graph loss."""
    reduce_mean = config.training.reduce_mean
    pred_data = config.model.pred_data
    _, w_atom, w_edge = parse_loss_weights(config.model.loss_weights)
    self_cond = config.model.self_cond
    reuse_cond_emb = bool(config.model.reuse_cond_emb and self_cond)
    include_charges = bool(config.model.include_fc_charge)

    def loss_fn(model, batch, draws):
        xh, edge_x, node_mask, edge_mask, context = process_batch_2d(batch, scaler,
                                                                     include_charges)
        bs = xh.shape[0]
        n_atoms = node_mask[..., 0].sum(dim=-1)
        t, noise, edge_noise = draws["t"], draws["noise"], draws["edge_noise"]
        alpha_t, sigma_t = noise_scheduler.marginal_prob(t)
        a, s = alpha_t[:, None, None], sigma_t[:, None, None]
        z_t = a * xh + s * noise
        edge_z_t = a[..., None] * edge_x + s[..., None] * edge_noise
        noise_level = torch.log(alpha_t**2 / sigma_t**2)
        caller = _model_caller(model, draws, context, reuse_cond_emb, xh.device)

        def call_model(cond_x, cond_edge_x, has_cond, forward):
            return caller(t, z_t, node_mask, edge_mask, edge_z_t, noise_level, cond_x,
                          cond_edge_x, has_cond, forward)

        zeros_x, zeros_e = torch.zeros_like(xh), torch.zeros_like(edge_x)
        if self_cond and draws["use_sc"]:
            with torch.no_grad():
                cond_x, cond_edge_x = call_model(zeros_x, zeros_e, False, 0)
            pred, edge_pred = call_model(cond_x, cond_edge_x, True, 1)
        else:
            pred, edge_pred = call_model(zeros_x, zeros_e, False, 1)

        target_x, target_e = (xh, edge_x) if pred_data else (noise, edge_noise)
        losses_atom = (pred - target_x).square().mean(-1).sum(-1)
        losses_edge = (edge_pred - target_e).square().mean(-1).reshape(bs, -1).sum(-1)
        if reduce_mean:
            losses_atom = losses_atom / n_atoms
            losses_edge = losses_edge / (edge_mask.reshape(bs, -1).sum(-1) + 1e-8)
        losses = w_atom * losses_atom + w_edge * losses_edge
        if pred_data:
            losses = torch.sqrt(alpha_t / sigma_t) * losses  # the SNR weight
        return losses.mean()

    return loss_fn


def get_sde_node_loss_fn(noise_scheduler, scaler, config):
    """The positions + atoms loss without bonds (``pred_edge=False``):
    ``loss_fn(model, batch, draws) -> loss`` on the centred positions and
    atom types (``batch["one_hot"]`` where the batch has it, else
    ``atom_one_hot``) with ``draw(..., pred_edge=False)``'s draws. The model
    gets a zero-width ``edge_x``, no ``cond_edge_x`` and no spectra, and
    its node prediction is read; the self-conditioning forward's prediction
    goes back in as it is, unprocessed, as JAX's node loss passes it."""
    reduce_mean = config.training.reduce_mean
    noise_align = config.model.noise_align
    pred_data = config.model.pred_data
    w_pos, w_atom, _ = parse_loss_weights(config.model.loss_weights)
    self_cond = config.model.self_cond
    include_charges = bool(config.model.include_fc_charge)

    def loss_fn(model, batch, draws):
        node_mask = batch["atom_mask"][..., None]
        edge_mask = batch["edge_mask"]
        atom_type = batch["one_hot"] if "one_hot" in batch else batch["atom_one_hot"]
        fc_charge = batch["formal_charges"] if include_charges else atom_type[..., :0]
        pos = M.remove_mean_with_mask(batch["positions"], node_mask)
        pos, atom_type, fc_charge = scaler(pos, atom_type, fc_charge, node_mask)
        xh = torch.cat([pos, atom_type, fc_charge], dim=2)
        bs, n = xh.shape[:2]
        n_atoms = node_mask[..., 0].sum(dim=-1)
        t, noise = draws["t"], draws["noise"]
        alpha_t, sigma_t = noise_scheduler.marginal_prob(t)
        z_t = alpha_t[:, None, None] * xh + sigma_t[:, None, None] * noise
        align_pos = xh[:, :, :3]
        if noise_align:
            if pred_data:
                align_pos = get_align_position(z_t, xh)
            else:
                noise = get_align_noise(z_t, xh, alpha_t, sigma_t, noise, node_mask)
        noise_level = torch.log(alpha_t**2 / sigma_t**2)
        caller = _model_caller(model, draws, None, False, xh.device)
        no_edges = xh.new_zeros((bs, n, n, 0))

        def call_model(cond_x, has_cond, forward):
            return caller(t, z_t, node_mask, edge_mask, no_edges, noise_level, cond_x, None,
                          has_cond, forward)[0]

        if self_cond and draws["use_sc"]:
            with torch.no_grad():
                cond_x = call_model(torch.zeros_like(xh), False, 0)
            pred = call_model(cond_x, True, 1)
        else:
            pred = call_model(torch.zeros_like(xh), False, 1)

        if pred_data:
            losses_pos = (pred[:, :, :3] - align_pos).square().mean(-1).sum(-1)
            losses_atom = (pred[:, :, 3:] - xh[:, :, 3:]).square().mean(-1).sum(-1)
        else:
            sq = (noise - pred).square()
            losses_pos = sq[:, :, :3].mean(-1).sum(-1)
            losses_atom = sq[:, :, 3:].mean(-1).sum(-1)
        if reduce_mean:
            losses_pos = losses_pos / n_atoms
            losses_atom = losses_atom / n_atoms
        losses = w_pos * losses_pos + w_atom * losses_atom
        if pred_data:
            losses = torch.sqrt(alpha_t / sigma_t) * losses  # the SNR weight
        return losses.mean()

    return loss_fn
