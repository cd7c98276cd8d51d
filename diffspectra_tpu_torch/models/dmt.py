"""DMT, the SE(3)-equivariant diffusion molecule transformer (port of
``diffspectra_tpu/models/dmt.py``).

Every molecule is padded dense: ``[B, N, .]`` nodes and ``[B, N, N, .]``
pairs with masks. In eval mode (serving, sampling) each
``EquivariantMixBlock`` dispatches as the JAX block does (``use_pallas``
on): its pair-grid attention through the ``mix_attention`` kernel with
``'attn'`` in ``pallas_ops``, its coordinate update through the
``equi_update`` kernel with ``'equi'``, or, with ``'block'`` (and
``cond_time`` and ``dist_gbf`` on), its whole pair-grid chain through the
``block_fused`` kernel (plain versions for CPU tensors); an op without its
kernel runs the JAX package's XLA branch. All paths read the same
parameters. In training mode (the ``deterministic=False`` of the JAX DMT)
the blocks run the XLA branches under autograd, as JAX trains without its
kernels, with dropout drawn from a generator a block seeded by
``dropout_seeds``; ``remat_policy='full'`` recomputes each block in the
backward pass, and ``'dots'`` keeps the outputs of its 2-D weight products
(``aten.mm``, ``aten.addmm``) and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable`` keeps the products without a batch
dimension (torch's selective checkpointing).

The variants of the JAX config: ``cond_time=False`` (no time embedding:
no time MLPs, the blocks' unmodulated branch, zero modulation of the
coordinate update), ``dist_gbf=False`` (the raw 1-wide distance in place
of the Gaussian basis), ``gbf_name`` (``CondGaussianLayer`` or
``GaussianLayer``) and ``in_node_dim`` (the atom types, plus one with
``include_fc_charge``).

``dtype`` is the JAX DMT's ``dtype`` (``training.matmul_precision``): in
bfloat16 each module casts where the JAX module casts. SpecFormer runs in
``dtype`` with ``specformer_bf16`` (``model.specformer_bf16``), else in
float32. A block rounds to
bfloat16 where XLA, compiling the JAX block scan, rounds: a bfloat16 op
whose only readers cast it to float32 stays unrounded
(``Dense.forward_f32``, the edge embedding's bias add ahead of its
LayerNorm, ``1 + scale`` of a float32 modulation), in both modes: JAX
trains and samples through jitted steps. Positions, the distance
features, the skip-concat heads and the kernels' sums stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .. import configs
from ..ops.block_fused import block_fused
from ..ops.equi_update import equi_update
from ..utils import masks as M
from ..utils.registry import register_model
from .layers import (
    GBF_LAYERS,
    CoorsNorm,
    Dense,
    DenseTransMixLayer,
    LearnedSinusoidalPosEmb,
    cast_param,
    dropout,
    empty_param,
    gelu,
    keep_casts,
    layer_norm,
    modulate,
    seeded_generator,
    silu,
)
from .specformer import SpecFormer


class MultiCondEquiUpdate(nn.Module):
    """Equivariant coordinate update with time conditioning. The node-level
    projections, the (shift, scale) time modulation and the CoorsNorm'd
    coordinate differences run here; the pair-grid chain is the
    ``equi_update`` kernel in eval mode with ``kernel``, whose node, edge
    and distance operands and gate weights are in ``dtype``, and the JAX
    module's XLA chain in training mode or without ``kernel``
    (``_update_train``). Without a ``time_dim`` (``cond_time=False``) there
    is no ``time_mlp``: the kernel gets a zero shift and scale, as JAX
    hands its kernel, and the XLA chain skips the modulation."""

    def __init__(self, hidden_dim: int, edge_dim: int, dist_dim: int, time_dim,
                 extra_heads: int, dtype: torch.dtype = torch.float32, kernel: bool = True):
        super().__init__()
        self.hidden_dim, self.edge_dim, self.dtype = hidden_dim, edge_dim, dtype
        self.kernel = kernel
        self.coord_norm = CoorsNorm()
        self.input_lin_kernel = empty_param(2 * hidden_dim + edge_dim + dist_dim, hidden_dim)
        self.input_lin_bias = empty_param(hidden_dim)
        self.time_mlp = None if time_dim is None else Dense(time_dim, 2 * hidden_dim, dtype=dtype)
        self.coord_mlp_0 = Dense(hidden_dim, hidden_dim)
        self.coord_mlp_1 = Dense(hidden_dim, 1 + extra_heads, use_bias=False)
        keep_casts(self, "input_lin_kernel", "input_lin_bias")
        self.eval()  # deterministic until train(), as the JAX module's default

    def forward(self, h, pos, edge_attr, dist, time_emb, adj_extra, edge_mask):
        if self.training or not self.kernel:
            return self._update_train(h, pos, edge_attr, dist, time_emb, adj_extra, edge_mask)
        eq = self.export_for_block(pos, time_emb, rounded_time=True)
        D, De, dt = self.hidden_dim, self.edge_dim, self.dtype
        w, h = cast_param(self, "input_lin_kernel"), h.to(dt)
        agg = equi_update(
            h @ w[:D], h @ w[D : 2 * D], edge_attr.to(dt), dist.to(dt), eq["normed_diff"],
            adj_extra, edge_mask, w[2 * D : 2 * D + De], w[2 * D + De :],
            cast_param(self, "input_lin_bias"), eq["shift"], eq["scale"], eq["k0"], eq["b0"],
            eq["k1"],
        )
        return pos + agg

    def _update_train(self, h, pos, edge_attr, dist, time_emb, adj_extra, edge_mask):
        """The JAX module's chain without its kernel
        (``diffspectra_tpu/models/dmt.py:167-190``), in ``dtype`` but the
        positions: ``[h_i, h_j, e_ij, d_ij] @ W + b`` by parts, LayerNorm,
        the time modulation (with a time embedding), ``silu(@ W0 + b0)``,
        ``tanh(@ W1)``, the mean over the ``[1, adjacency]`` channels, and
        the masked sum of the normalised coordinate differences. Each op
        rounds to ``dtype`` as XLA rounds it, but the two whose result only
        float32 math reads, which XLA leaves unrounded: the bias add
        (LayerNorm reads it in float32) and the tanh (cast to float32)."""
        D, De, dt = self.hidden_dim, self.edge_dim, self.dtype
        w, b = cast_param(self, "input_lin_kernel"), cast_param(self, "input_lin_bias")
        h = h.to(dt)
        normed_diff = self.coord_norm(pos[:, :, None, :] - pos[:, None, :, :])
        inv = ((h @ w[:D])[:, :, None, :] + (h @ w[D : 2 * D])[:, None, :, :]
               + edge_attr.to(dt) @ w[2 * D : 2 * D + De] + dist.to(dt) @ w[2 * D + De :])
        inv = layer_norm(inv.float() + b.float(), dtype=dt)
        if self.time_mlp is not None:
            shift, scale = self.time_mlp(silu(time_emb.to(dt))).chunk(2, dim=-1)
            inv = modulate(inv, shift[:, None, None, :], scale[:, None, None, :])
        k0, b0, k1 = self.coord_mlp_0.kernel, self.coord_mlp_0.bias, self.coord_mlp_1.kernel
        inv = silu(inv @ k0.to(dt) + b0.to(dt))
        inv = torch.tanh((inv @ k1.to(dt)).float())
        adjs = torch.cat([torch.ones_like(adj_extra[..., :1]), adj_extra], dim=-1)
        inv = (inv * adjs).mean(dim=-1, keepdim=True)
        return pos + (normed_diff * inv * edge_mask[..., None]).sum(dim=2)

    def export_for_block(self, pos, time_emb, rounded_time: bool = False) -> dict:
        """The node-level part of the update: the CoorsNorm'd coordinate
        differences, the time modulation and the raw float32 weights, with
        concat([h_i, h_j, e_ij, d_ij]) @ W split by rows (the node parts
        become per-node products broadcast over the pair grid). The time
        modulation comes from a time MLP in ``dtype``, in float32: rounded
        to ``dtype`` first with ``rounded_time`` (the per-op path, where a
        split reads the MLP's output), else not (the whole-block path, where
        only a cast to float32 does); without a time MLP it is zero."""
        D, De = self.hidden_dim, self.edge_dim
        w = self.input_lin_kernel
        if self.time_mlp is None:
            shift = scale = pos.new_zeros((pos.shape[0], D))
        else:
            t = silu(time_emb.to(self.dtype))
            ss = self.time_mlp(t).float() if rounded_time else self.time_mlp.forward_f32(t)
            # chunk order is (shift, scale) here
            shift, scale = (c.contiguous() for c in ss.chunk(2, dim=-1))
        return {
            "normed_diff": self.coord_norm(pos[:, :, None, :] - pos[:, None, :, :]),
            "w_hi": w[:D], "w_hj": w[D : 2 * D], "w_e": w[2 * D : 2 * D + De],
            "w_d": w[2 * D + De :], "bias": self.input_lin_bias,
            "shift": shift, "scale": scale,
            "k0": self.coord_mlp_0.kernel, "b0": self.coord_mlp_0.bias,
            "k1": self.coord_mlp_1.kernel,
        }


class EquivariantMixBlock(nn.Module):
    """One equivariant transformer block, with adaLN time conditioning
    under ``cond_time``. ``ops`` is the JAX block's ``pallas_ops``: in eval
    mode ``'block'`` sends its whole pair-grid chain to ``block_fused``
    where the JAX block does (``cond_time`` and ``dist_gbf`` on), ``'attn'``
    and ``'equi'`` their op to its kernel. In training mode ``generator``
    draws the dropout masks of the attention weights and the two FFNs."""

    def __init__(self, node_dim: int, edge_dim: int, time_dim: int, num_extra_heads: int,
                 num_heads: int, softmax_inf: bool = True, mlp_ratio: int = 2,
                 ops=("attn", "equi"), dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, cond_time: bool = True,
                 dist_gbf: bool = True, gbf_name: str = "CondGaussianLayer"):
        super().__init__()
        self.dropout = dropout
        self.num_heads, self.num_extra_heads = num_heads, num_extra_heads
        self.softmax_inf, self.dtype = softmax_inf, dtype
        self.cond_time, self.dist_gbf = cond_time, dist_gbf
        # the JAX block's dispatch (diffspectra_tpu/models/dmt.py:232-241)
        self.block_kernel = "block" in ops and cond_time and dist_gbf
        time = time_dim if cond_time else None
        dist_dim = edge_dim if dist_gbf else 1
        self.dist_layer = GBF_LAYERS[gbf_name](edge_dim, time) if dist_gbf else None
        self.edge_emb = Dense(dist_dim + edge_dim, edge_dim, dtype=dtype)
        if cond_time:
            self.node_time_mlp = Dense(time_dim, 6 * node_dim, dtype=dtype)
            self.edge_time_mlp = Dense(time_dim, 6 * edge_dim, dtype=dtype)
        self.attn_mpnn = DenseTransMixLayer(
            node_dim, node_dim // num_heads, edge_dim, extra_heads=num_extra_heads,
            heads=num_heads, set_inf=softmax_inf, dropout=dropout, dtype=dtype,
            kernel="attn" in ops,
        )
        self.node2edge_kernel = empty_param(node_dim, edge_dim)
        self.node2edge_bias = empty_param(edge_dim)
        keep_casts(self, "node2edge_kernel")
        self.ff_linear1 = Dense(node_dim, node_dim * mlp_ratio, dtype=dtype)
        self.ff_linear2 = Dense(node_dim * mlp_ratio, node_dim, dtype=dtype)
        self.ff_linear3 = Dense(edge_dim, edge_dim * mlp_ratio, dtype=dtype)
        self.ff_linear4 = Dense(edge_dim * mlp_ratio, edge_dim, dtype=dtype)
        self.equi_update = MultiCondEquiUpdate(
            node_dim, edge_dim, dist_dim, time, num_extra_heads, dtype=dtype,
            kernel="equi" in ops,
        )
        self.eval()

    def forward(self, pos, h, edge_attr, node_mask, edge_mask, extra_heads, time_emb,
                generator=None):
        # the JAX dispatch condition; the port trains without the kernel
        if (self.block_kernel and not self.training
                and extra_heads.shape[-1] == self.num_extra_heads):
            return self._fused_block(pos, h, edge_attr, node_mask, edge_mask, extra_heads,
                                     time_emb)
        dt = self.dtype
        h_in_node, h_in_edge = h, edge_attr
        distance = M.coord2dist_dense(pos)
        if self.dist_gbf:
            distance = self.dist_layer(distance, time_emb)
        k_emb = cast_param(self.edge_emb, "kernel")
        dist_dim = distance.shape[-1]
        # the bias add is read by the LayerNorm's float32 statistics alone
        edge_attr = ((distance.to(dt) @ k_emb[:dist_dim] + edge_attr.to(dt) @ k_emb[dist_dim:])
                     .float() + cast_param(self.edge_emb, "bias").float())

        if self.cond_time:
            # chunk order: (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
            # gate_mlp); in dtype, so that the LayerNorm and modulation of a
            # bfloat16 edge_attr run in bfloat16
            t = silu(time_emb.to(dt))
            n_mods = [m[:, None, :] for m in self.node_time_mlp(t).chunk(6, dim=-1)]
            e_mods = [m[:, None, None, :] for m in self.edge_time_mlp(t).chunk(6, dim=-1)]
            n_shift_msa, n_scale_msa, n_gate_msa, n_shift_mlp, n_scale_mlp, n_gate_mlp = n_mods
            e_shift_msa, e_scale_msa, e_gate_msa, e_shift_mlp, e_scale_mlp, e_gate_mlp = e_mods
            h = modulate(layer_norm(h), n_shift_msa, n_scale_msa)
            edge_attr = modulate(layer_norm(edge_attr, dtype=dt), e_shift_msa, e_scale_msa)
        else:
            h = layer_norm(h)
            edge_attr = layer_norm(edge_attr, dtype=dt)

        h_node = self.attn_mpnn(h, edge_attr, extra_heads, edge_mask, generator)

        # Dense(h_i + h_j) is linear: project per node, broadcast-add
        proj = (h_node.to(dt) @ cast_param(self, "node2edge_kernel")).float()
        h_edge = proj[:, :, None, :] + proj[:, None, :, :] + self.node2edge_bias

        p = self.dropout
        ff_node = lambda x: dropout(self.ff_linear2.forward_f32(
            dropout(silu(self.ff_linear1(x)), p, generator)), p, generator)
        ff_edge = lambda x: dropout(self.ff_linear4.forward_f32(
            dropout(silu(self.ff_linear3(x)), p, generator)), p, generator)
        if self.cond_time:
            h_node = h_in_node + n_gate_msa * h_node
            h_node = modulate(layer_norm(h_node), n_shift_mlp, n_scale_mlp) * node_mask
            h_out = (h_node + n_gate_mlp * ff_node(h_node)) * node_mask
            h_edge = h_in_edge + e_gate_msa * h_edge
            h_edge = modulate(layer_norm(h_edge), e_shift_mlp, e_scale_mlp)
            h_edge_out = h_edge + e_gate_mlp * ff_edge(h_edge)
        else:
            h_node = layer_norm(h_in_node + h_node) * node_mask
            h_out = (h_node + ff_node(h_node)) * node_mask
            h_edge = layer_norm(h_in_edge + h_edge)
            h_edge_out = h_edge + ff_edge(h_edge)

        pos = self.equi_update(h_out, pos, h_edge_out, distance, time_emb, extra_heads, edge_mask)
        return h_out, h_edge_out, pos

    def _fused_block(self, pos, h, edge_attr, node_mask, edge_mask, extra_heads, time_emb):
        """The node-level preprocessing (adaLN vectors, q/k/v, time MLPs, d2,
        CoorsNorm) here, the whole pair-grid chain in one ``block_fused``
        call, from the same parameters as the unfused path. The time MLPs
        and q/k/v run in ``dtype``; the kernel takes q/k/v in ``dtype``,
        everything else in float32, the weights raw."""
        means, stds, g_scale, g_shift = self.dist_layer.export_params(time_emb)
        t = silu(time_emb.to(self.dtype))
        node_mods = self.node_time_mlp.forward_f32(t).chunk(6, dim=-1)
        edge_mods = self.edge_time_mlp.forward_f32(t).chunk(6, dim=-1)
        n_shift_msa, n_scale_msa, n_gate_msa, n_shift_mlp, n_scale_mlp, n_gate_mlp = node_mods
        hm = modulate(layer_norm(h), n_shift_msa[:, None, :], n_scale_msa[:, None, :])
        q, k, v, w0a, w1a = self.attn_mpnn.export_for_block(hm)
        eq = self.equi_update.export_for_block(pos, time_emb)
        de = self.edge_emb.kernel.shape[-1]  # dist_dim == edge_dim
        h_out, edge_out, agg = block_fused(
            h, q, k, v, edge_attr, M.coord2dist_dense(pos), eq["normed_diff"], extra_heads,
            edge_mask, node_mask,
            # shift/scale_msa of the nodes were used on hm above
            torch.stack([n_gate_msa, n_shift_mlp, n_scale_mlp, n_gate_mlp], dim=1),
            torch.stack(edge_mods, dim=1),
            torch.stack([eq["shift"], eq["scale"]], dim=1),
            torch.stack([g_scale, g_shift], dim=-1)[:, None, :],  # (scale, shift)
            means, stds, self.edge_emb.kernel[:de], self.edge_emb.kernel[de:],
            self.edge_emb.bias, w0a, w1a, self.node2edge_kernel, self.node2edge_bias,
            self.ff_linear1.kernel, self.ff_linear1.bias, self.ff_linear2.kernel,
            self.ff_linear2.bias, self.ff_linear3.kernel, self.ff_linear3.bias,
            self.ff_linear4.kernel, self.ff_linear4.bias,
            eq["w_hi"], eq["w_hj"], eq["w_e"], eq["w_d"], eq["bias"], eq["k0"], eq["b0"],
            eq["k1"],
            set_inf=self.softmax_inf, n_heads=self.num_heads, n_extra=self.num_extra_heads,
            out_ch=h.shape[-1] // self.num_heads,
        )
        return h_out, edge_out, pos + agg


class Block(nn.Module):
    """One step of the JAX block scan: the block, CoM removal and the
    skip-concat projections."""

    def __init__(self, node_dim, edge_dim, time_dim, num_extra_heads, num_heads,
                 softmax_inf, mlp_ratio, cat_node_dim, cat_edge_dim, ops, dropout, dtype,
                 cond_time, dist_gbf, gbf_name):
        super().__init__()
        self.e_block = EquivariantMixBlock(
            node_dim, edge_dim, time_dim, num_extra_heads, num_heads, softmax_inf, mlp_ratio,
            ops, dropout, dtype, cond_time, dist_gbf, gbf_name,
        )
        self.node_proj = Dense(node_dim, cat_node_dim)
        self.edge_proj = Dense(edge_dim, cat_edge_dim)

    def forward(self, seed, CoM: bool, pos, h, edge_attr, node_mask, edge_mask, extra_adj,
                time_emb):
        """``(pos, h, edge_attr, cat_h, cat_e)``; the dropout masks come from
        a generator seeded with ``seed`` (None: no dropout), so a
        recomputation in the backward pass draws the same masks."""
        h, edge_attr, pos = self.e_block(pos, h, edge_attr, node_mask, edge_mask, extra_adj,
                                         time_emb, seeded_generator(seed, h.device))
        if CoM:
            pos = M.remove_mean_with_mask(pos, node_mask)
        return pos, h, edge_attr, self.node_proj(h), self.edge_proj(edge_attr)


REMAT_POLICIES = ("full", "dots", "none")
# 'dots': the ops whose outputs a block's backward keeps
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def block_runner(model: nn.Module, dropout_seeds):
    """``(seeds, run)`` for one forward through ``model.blocks``: a dropout
    seed a block (None outside training mode or without
    ``dropout_seeds``) and ``run(block, *args)``, which calls the block, or
    under ``model.remat_policy`` in training mode with gradients
    recomputes it in the backward pass (``torch.utils.checkpoint``; the
    recomputation draws its dropout masks from its own seed). A model in
    training mode with dropout and no ``dropout_seeds`` raises."""
    if model.training and model.dropout > 0 and dropout_seeds is None:
        raise ValueError(f"a {type(model).__name__} in training mode with dropout takes "
                         "dropout_seeds")
    seeds = (list(dropout_seeds) if model.training and dropout_seeds is not None
             else [None] * len(model.blocks))
    if not (model.training and model.remat_policy != "none" and torch.is_grad_enabled()):
        return seeds, lambda block, *args: block(*args)
    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if model.remat_policy == "dots":
        kwargs["context_fn"] = _dots_context
    return seeds, lambda block, *args: checkpoint(block, *args, **kwargs)


def skip_heads(model: nn.Module, atom_hids, edge_hids, node_mask, edge_mask):
    """The skip-concat prediction heads that the DMT and DMT_WO_EQ share:
    ``(atom_pred [B, N, F], edge_final [B, N, N, edge_ch])`` from the node
    and edge embeddings of before the blocks, each concatenated with every
    block's projection; the edge prediction masked and symmetrised."""
    atom_pred = model.node_pred_mlp_2(F.silu(model.node_pred_mlp_1(
        F.silu(model.node_pred_mlp_0(atom_hids))))) * node_mask
    heads = []
    for head in ("edge_exist_mlp", "edge_type_mlp"):
        x = F.silu(getattr(model, f"{head}_0")(edge_hids))
        x = F.silu(getattr(model, f"{head}_1")(x))
        heads.append(getattr(model, f"{head}_2")(x))
    return atom_pred, M.symmetrize_edges(torch.cat(heads, dim=-1) * edge_mask[..., None])


def add_skip_heads(model: nn.Module, hidden_dim: int, edge_dim: int, in_node_dim: int,
                   edge_ch: int, n_layers: int, cat_node_dim: int, cat_edge_dim: int) -> None:
    """The parameters of ``skip_heads`` on ``model``, flax's names."""
    model.node_pred_mlp_0 = Dense(hidden_dim + n_layers * cat_node_dim, hidden_dim)
    model.node_pred_mlp_1 = Dense(hidden_dim, hidden_dim // 2)
    model.node_pred_mlp_2 = Dense(hidden_dim // 2, in_node_dim)
    for head, out in (("edge_exist_mlp", 1), ("edge_type_mlp", edge_ch - 1)):
        setattr(model, f"{head}_0", Dense(edge_dim + n_layers * cat_edge_dim, edge_dim))
        setattr(model, f"{head}_1", Dense(edge_dim, edge_dim // 2))
        setattr(model, f"{head}_2", Dense(edge_dim // 2, out))


@register_model(name="DMT")
class DMT(nn.Module):
    """``forward(t, xh, node_mask, edge_mask, edge_x, noise_level, cond_x,
    cond_edge_x, has_cond, context_emb, dropout_seeds=None) -> (pred [B, N,
    3+F], edge_pred [B, N, N, edge_ch])``. ``has_cond=False`` is the first
    step of self-conditioning: the conditional adjacency is all ones and the
    distance features are zero. ``dropout_seeds``: one integer a block, in
    training mode with ``dropout > 0``. With ``cond_time=False`` the model
    reads neither ``noise_level`` nor ``context_emb``, as the JAX DMT, whose
    spectra encoding no time embedding then reads."""

    def __init__(self, in_node_dim: int = 6, hidden_dim: int = 256, edge_ch: int = 2,
                 n_heads: int = 16, n_extra_heads: int = 2, n_layers: int = 8,
                 edge_quan_th: float = 0.0, CoM: bool = True, mlp_ratio: int = 2,
                 spatial_cut_off: float = 2.0, softmax_inf: bool = True,
                 pred_data: bool = True, spectra_version: str = "ir",
                 patch_len=(20, 50, 50), stride=(10, 25, 25), pallas_ops=("attn", "equi"),
                 dropout: float = 0.0, remat_policy: str = "full",
                 dtype: torch.dtype = torch.float32, cond_time: bool = True,
                 dist_gbf: bool = True, gbf_name: str = "CondGaussianLayer",
                 specformer_bf16: bool = False):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: takes one of {REMAT_POLICIES}")
        if gbf_name not in GBF_LAYERS:
            raise ValueError(f"gbf_name {gbf_name!r}: takes one of {sorted(GBF_LAYERS)}")
        self.dtype, self.dropout, self.remat_policy = dtype, dropout, remat_policy
        self.edge_quan_th, self.CoM, self.pred_data = edge_quan_th, CoM, pred_data
        self.spatial_cut_off, self.cond_time, self.dist_gbf = spatial_cut_off, cond_time, dist_gbf
        De = hidden_dim // 4
        self.edge_hidden_dim = De
        self.dist_dim = De if dist_gbf else 1
        time_dim = hidden_dim * 4
        if cond_time:
            self.time_emb = LearnedSinusoidalPosEmb(16)
            self.time_mlp_1 = Dense(17, time_dim)
            self.time_mlp_2 = Dense(time_dim, time_dim)
        self.cond_encoder = SpecFormer(spectra_version, patch_len, stride, output_dim=hidden_dim,
                                       dtype=dtype if specformer_bf16 else torch.float32)
        self.cond_lin = Dense(hidden_dim, time_dim)
        if dist_gbf:
            self.dist_layer = GBF_LAYERS[gbf_name](De, time_dim if cond_time else None)
        self.node_emb = Dense(2 * in_node_dim, hidden_dim, dtype=dtype)
        self.edge_emb = Dense(2 * edge_ch + self.dist_dim, De, dtype=dtype)
        cat_node_dim = hidden_dim * 2 // n_layers
        cat_edge_dim = De * 2 // n_layers
        self.blocks = nn.ModuleList(
            Block(hidden_dim, De, time_dim, n_extra_heads, n_heads, softmax_inf, mlp_ratio,
                  cat_node_dim, cat_edge_dim, tuple(pallas_ops), dropout, dtype, cond_time,
                  dist_gbf, gbf_name)
            for _ in range(n_layers)
        )
        add_skip_heads(self, hidden_dim, De, in_node_dim, edge_ch, n_layers, cat_node_dim,
                       cat_edge_dim)
        self.eval()  # deterministic until train(), as the JAX DMT's default

    @staticmethod
    def from_config(config) -> "DMT":
        m = config.model
        unknown = set(m.pallas_ops) - {"attn", "equi", "block"}
        if unknown:
            raise ValueError(f"unknown model.pallas_ops {sorted(unknown)}")
        return DMT(
            in_node_dim=config.data.atom_types + int(m.include_fc_charge),
            hidden_dim=m.nf, edge_ch=m.edge_ch, n_heads=m.n_heads,
            n_extra_heads=m.n_extra_heads, n_layers=m.n_layers,
            edge_quan_th=m.edge_quan_th, CoM=m.CoM, mlp_ratio=m.mlp_ratio,
            spatial_cut_off=m.spatial_cut_off, softmax_inf=m.softmax_inf,
            pred_data=m.pred_data, spectra_version=config.data.spectra_version,
            patch_len=tuple(m.patch_len), stride=tuple(m.stride),
            pallas_ops=tuple(m.pallas_ops), dropout=m.dropout,
            remat_policy=m.remat_policy, dtype=configs.model_dtype(config),
            cond_time=m.cond_time, dist_gbf=m.dist_gbf, gbf_name=m.gbf_name,
            specformer_bf16=m.specformer_bf16,
        )

    def encode_context(self, specs, generator=None) -> torch.Tensor:
        """The spectra conditioning ``[B, time_dim]``, computed once per
        request (or train step) and passed to every forward as
        ``context_emb``. In training mode SpecFormer's BatchNorms use the
        batch's statistics and update the running ones
        (``encode_context_train`` of the JAX package)."""
        return self.cond_lin(self.cond_encoder(specs, generator))

    def forward(self, t, xh, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x,
                has_cond: bool, context_emb, dropout_seeds=None):
        B, N, _ = xh.shape
        pos, h = xh[:, :, :3], xh[:, :, 3:]
        if has_cond:
            cond_adj_2d = (cond_edge_x[..., 0:1] >= self.edge_quan_th).to(xh.dtype)
        else:
            cond_x = torch.zeros_like(xh)
            cond_edge_x = torch.zeros_like(edge_x)
            cond_adj_2d = torch.ones_like(edge_x[..., 0:1])
        cond_pos, cond_h = cond_x[:, :, :3], cond_x[:, :, 3:]
        h = torch.cat([h, cond_h], dim=-1)

        time_emb = None
        if self.cond_time:
            temb = self.time_mlp_2(gelu(self.time_mlp_1(self.time_emb(noise_level))))
            time_emb = temb + context_emb

        distances_raw, cond_adj_spatial = M.coord2diff_adj_dense(
            cond_pos, edge_mask, self.spatial_cut_off
        )
        if not has_cond:
            distances = xh.new_zeros((B, N, N, self.dist_dim))
        elif self.dist_gbf:
            distances = self.dist_layer(distances_raw, time_emb)
        else:
            distances = distances_raw
        extra_adj = torch.cat([cond_adj_2d, cond_adj_spatial], dim=-1)
        # the embeddings' bias add is left in float32, as XLA leaves it in
        # JAX's jitted steps (only a cast to float32 reads it)
        edge_attr = self.edge_emb.forward_f32(torch.cat([edge_x, cond_edge_x, distances], dim=-1))
        h = h0 = self.node_emb.forward_f32(h)
        edge_attr0 = edge_attr

        seeds, run = block_runner(self, dropout_seeds)
        cat_h, cat_e = [], []
        for block, seed in zip(self.blocks, seeds):
            pos, h, edge_attr, ch, ce = run(block, seed, self.CoM, pos, h, edge_attr, node_mask,
                                            edge_mask, extra_adj, time_emb)
            cat_h.append(ch)
            cat_e.append(ce)

        # the skip-concat heads read the embeddings from before the blocks
        atom_pred, edge_final = skip_heads(self, torch.cat([h0, *cat_h], dim=-1),
                                           torch.cat([edge_attr0, *cat_e], dim=-1), node_mask,
                                           edge_mask)
        pos = pos * node_mask if self.pred_data else (pos - xh[:, :, :3]) * node_mask
        # a NaN anywhere zeroes the positions of the whole batch, as in the reference
        pos = torch.where(torch.isnan(pos).any(), torch.zeros_like(pos), pos)
        pos = M.remove_mean_with_mask(pos, node_mask)
        return torch.cat([pos, atom_pred], dim=2), edge_final
