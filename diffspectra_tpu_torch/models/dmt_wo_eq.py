"""DMT_WO_EQ, the non-equivariant ablation of the DMT (port of
``diffspectra_tpu/models/dmt_wo_eq.py``).

Positions enter as plain inputs (``NodeEmbed`` reads the noisy positions)
and a ``pos_pred_mlp`` head predicts them directly; rotation and
translation come from the data augmentation, not from equivariance. The
blocks have no coordinate update and no adjacency heads. Their attention,
``DenseTransLayer``, has three forms, ``trans_ver``: ``'v1'`` (per-head
q/k/v, tanh edge gates on the logits and values), ``'v2'`` (the default: a
fused qkv, additive edge key and value) and ``'optim'`` (a fused qkv, tanh
edge gates). JAX runs the model on XLA and so does the port, on PyTorch
ops: it launches no kernel of ``csrc/``.

The same call as the DMT: ``forward(t, xh, node_mask, edge_mask, edge_x,
noise_level, cond_x, cond_edge_x, has_cond, context_emb, dropout_seeds)``
and ``encode_context``. Training mode draws dropout from a generator a
block seeded by ``dropout_seeds`` and recomputes the blocks in the backward
pass under ``remat_policy`` (``'full'``, ``'dots'``, ``'none'``), as the DMT.

``dtype`` (``training.matmul_precision``): in bfloat16 the attention
(its products, logits and weighted sums, the output projection), the FFNs
and the node-to-edge product run in bfloat16, cast where the JAX module
casts; the embeddings, time MLPs, LayerNorms and modulations, residuals,
softmax, heads and SpecFormer stay float32. A bfloat16 op that only a cast
to float32 reads keeps float32 (``Dense.forward_f32``, the sum of the two
``'v2'`` logits), as XLA compiles the JAX module.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import configs
from ..ops.mix_attention import MASK_INF
from ..utils import masks as M
from ..utils.registry import register_model
from .dmt import REMAT_POLICIES, add_skip_heads, block_runner, skip_heads
from .layers import (
    GBF_LAYERS,
    Dense,
    LearnedSinusoidalPosEmb,
    cast_param,
    dropout,
    empty_param,
    gelu,
    keep_casts,
    layer_norm,
    modulate,
    product,
    seeded_generator,
    silu,
)
from .specformer import LayerNorm, SpecFormer

TRANS_VERS = ("v1", "v2", "optim")


class DenseTransLayer(nn.Module):
    """Dense masked multi-head attention over all pairs, ``x [B, N, D]``,
    ``edge_attr [B, N, N, De]``, ``edge_mask [B, N, N]`` -> ``[B, N, D]``
    (float32), ending in the output projection ``proj``. The logits are
    float32 over ``sqrt(D / heads)``, the padding ``MASK_INF``, the softmax
    over j; dropout (with a ``generator``) falls on the weights."""

    def __init__(self, node_dim: int, edge_dim: int, heads: int, dropout: float = 0.0,
                 trans_ver: str = "v2", dtype: torch.dtype = torch.float32):
        super().__init__()
        if trans_ver not in TRANS_VERS:
            raise ValueError(f"unknown trans_ver {trans_ver!r}; takes one of {TRANS_VERS}")
        self.heads, self.dropout, self.trans_ver, self.dtype = heads, dropout, trans_ver, dtype
        width = node_dim // heads * heads
        if trans_ver == "v1":
            self.lin_query = Dense(node_dim, width, dtype=dtype)
            self.lin_key = Dense(node_dim, width, dtype=dtype)
            self.lin_value = Dense(node_dim, width, dtype=dtype)
            self.lin_edge0 = Dense(edge_dim, width, use_bias=False, dtype=dtype)
            self.lin_edge1 = Dense(edge_dim, width, use_bias=False, dtype=dtype)
        else:
            self.lin_qkv = Dense(node_dim, 3 * width, dtype=dtype)
            name = "lin_kv_e" if trans_ver == "v2" else "lin_edge"
            setattr(self, name, Dense(edge_dim, 2 * width, use_bias=False, dtype=dtype))
        self.proj = Dense(width, width, dtype=dtype)

    def forward(self, x, edge_attr, edge_mask, generator=None):
        B, N, _ = x.shape
        H, dt = self.heads, self.dtype
        C = self.proj.kernel.shape[0] // H
        if self.trans_ver == "v1":
            q = self.lin_query(x).reshape(B, N, H, C)
            k = self.lin_key(x).reshape(B, N, H, C)
            v = self.lin_value(x).reshape(B, N, H, C)
            ek = torch.tanh(self.lin_edge0(edge_attr)).reshape(B, N, N, H, C)
            ev = torch.tanh(self.lin_edge1(edge_attr)).reshape(B, N, N, H, C)
        else:
            # per head, q, k and v (and the edge key and value) interleave
            q, k, v = self.lin_qkv(x).reshape(B, N, H, 3, C).unbind(3)
            if self.trans_ver == "v2":
                ekv = self.lin_kv_e(edge_attr)
            else:
                ekv = torch.tanh(self.lin_edge(edge_attr))
            ek, ev = ekv.reshape(B, N, N, H, 2, C).unbind(4)
        if self.trans_ver == "v2":
            # q_i . (k_j + ek_ij): two products, added in float32
            logits = (product("bihc,bjhc->bijh", q, k, dtype=dt).float()
                      + product("bihc,bijhc->bijh", q, ek, dtype=dt).float())
        else:
            # q_i * k_j first, then the gate, as jnp.einsum orders the three
            qk = q[:, :, None] * k[:, None]
            logits = product("bijhc,bijhc->bijh", qk, ek, dtype=dt).float()
        logits = logits * (1.0 / math.sqrt(C))  # XLA's multiply by the reciprocal
        logits = torch.where(edge_mask[..., None] > 0, logits, torch.full_like(logits, MASK_INF))
        alpha = dropout(torch.softmax(logits, dim=2).to(dt), self.dropout, generator)
        if self.trans_ver == "v2":
            out = (product("bijh,bjhc->bihc", alpha, v, dtype=dt)
                   + product("bijh,bijhc->bihc", alpha, ev, dtype=dt))
        else:
            # the gate times the weight first, then the value
            out = product("bijhc,bjhc->bihc", ev * alpha[..., None], v, dtype=dt)
        return self.proj.forward_f32(out.reshape(B, N, H * C))


class DMTWoEqBlock(nn.Module):
    """A transformer block without coordinate update: adaLN time modulation
    with ``cond_time`` (float32 time MLPs), else affine LayerNorms; the
    attention, masked by ``node_mask``; the node update; and the edge
    update from the attention output, ``concat([h_i, h_j]) @ W + b`` as two
    per-node products broadcast over the pair grid. FFNs use gelu."""

    def __init__(self, node_dim: int, edge_dim: int, time_dim: int, num_heads: int,
                 cond_time: bool = True, mlp_ratio: int = 2, dropout: float = 0.0,
                 trans_ver: str = "v2", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cond_time, self.dropout, self.dtype = cond_time, dropout, dtype
        if cond_time:
            self.node_time_mlp = Dense(time_dim, 6 * node_dim)
            self.edge_time_mlp = Dense(time_dim, 6 * edge_dim)
        else:
            for name, width in (("norm1_node", node_dim), ("norm1_edge", edge_dim),
                                ("norm2_node", node_dim), ("norm2_edge", edge_dim)):
                setattr(self, name, LayerNorm(width))
        self.attn_mpnn = DenseTransLayer(node_dim, edge_dim, num_heads, dropout, trans_ver, dtype)
        self.ff_linear1 = Dense(node_dim, node_dim * mlp_ratio, dtype=dtype)
        self.ff_linear2 = Dense(node_dim * mlp_ratio, node_dim, dtype=dtype)
        self.ff_linear3 = Dense(edge_dim, edge_dim * mlp_ratio, dtype=dtype)
        self.ff_linear4 = Dense(edge_dim * mlp_ratio, edge_dim, dtype=dtype)
        self.node2edge_kernel = empty_param(2 * node_dim, edge_dim)
        self.node2edge_bias = empty_param(edge_dim)
        keep_casts(self, "node2edge_kernel")

    def forward(self, h, edge_attr, node_mask, edge_mask, time_emb, generator=None):
        h_in_node, h_in_edge = h, edge_attr
        p, dt = self.dropout, self.dtype
        ff_node = lambda x: dropout(self.ff_linear2.forward_f32(
            dropout(gelu(self.ff_linear1(x)), p, generator)), p, generator)
        ff_edge = lambda x: dropout(self.ff_linear4.forward_f32(
            dropout(gelu(self.ff_linear3(x)), p, generator)), p, generator)
        if self.cond_time:
            # chunk order: (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp)
            t = silu(time_emb)
            n_shift_msa, n_scale_msa, n_gate_msa, n_shift_mlp, n_scale_mlp, n_gate_mlp = (
                m[:, None, :] for m in self.node_time_mlp(t).chunk(6, dim=-1))
            e_shift_msa, e_scale_msa, e_gate_msa, e_shift_mlp, e_scale_mlp, e_gate_mlp = (
                m[:, None, None, :] for m in self.edge_time_mlp(t).chunk(6, dim=-1))
            h = modulate(layer_norm(h), n_shift_msa, n_scale_msa)
            edge_attr = modulate(layer_norm(edge_attr), e_shift_msa, e_scale_msa)
        else:
            h = self.norm1_node(h)
            edge_attr = self.norm1_edge(edge_attr)

        # padded rows carry no attention output
        h_node = self.attn_mpnn(h, edge_attr, edge_mask, generator) * node_mask

        if self.cond_time:
            h_node_res = h_in_node + n_gate_msa * h_node
            h_out = h_node_res + n_gate_mlp * ff_node(
                modulate(layer_norm(h_node_res), n_shift_mlp, n_scale_mlp))
        else:
            h_node_res = h_in_node + h_node
            h_out = h_node_res + ff_node(self.norm2_node(h_node_res))

        # the edge update reads the attention output, not the updated nodes
        D = h_node.shape[-1]
        w, hk = cast_param(self, "node2edge_kernel"), h_node.to(dt)
        proj_i, proj_j = (hk @ w[:D]).float(), (hk @ w[D:]).float()
        h_edge = proj_i[:, :, None, :] + proj_j[:, None, :, :] + self.node2edge_bias
        if self.cond_time:
            h_edge_res = h_in_edge + e_gate_msa * h_edge
            h_edge_out = h_edge_res + e_gate_mlp * ff_edge(
                modulate(layer_norm(h_edge_res), e_shift_mlp, e_scale_mlp))
        else:
            h_edge_res = h_in_edge + h_edge
            h_edge_out = h_edge_res + ff_edge(self.norm2_edge(h_edge_res))
        return h_out, h_edge_out


class NodeEmbed(nn.Module):
    """``mlp_out(gelu(x_linear(x) + pos_linear(pos)))``, float32."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.x_linear = Dense(in_dim, 2 * hidden_size)
        self.pos_linear = Dense(3, 2 * hidden_size)
        self.mlp_out = Dense(2 * hidden_size, hidden_size)

    def forward(self, x, pos):
        return self.mlp_out(gelu(self.x_linear(x) + self.pos_linear(pos)))


class Block(nn.Module):
    """One step of the JAX block scan: the block and the skip-concat
    projections."""

    def __init__(self, node_dim, edge_dim, time_dim, num_heads, cond_time, mlp_ratio, dropout,
                 trans_ver, dtype, cat_node_dim, cat_edge_dim):
        super().__init__()
        self.dmt_block = DMTWoEqBlock(node_dim, edge_dim, time_dim, num_heads, cond_time,
                                      mlp_ratio, dropout, trans_ver, dtype)
        self.node_proj = Dense(node_dim, cat_node_dim)
        self.edge_proj = Dense(edge_dim, cat_edge_dim)

    def forward(self, seed, h, edge_attr, node_mask, edge_mask, time_emb):
        """``(h, edge_attr, cat_h, cat_e)``; the dropout masks come from a
        generator seeded with ``seed`` (None: no dropout)."""
        h, edge_attr = self.dmt_block(h, edge_attr, node_mask, edge_mask, time_emb,
                                      seeded_generator(seed, h.device))
        return h, edge_attr, self.node_proj(h), self.edge_proj(edge_attr)


@register_model(name="DMT_WO_EQ")
class DMT_WO_EQ(nn.Module):
    """``forward(...) -> (pred [B, N, 3+F], edge_pred [B, N, N, edge_ch])``,
    the DMT's call. ``has_cond=False``: no self-conditioning input, zero
    distance features. Without ``cond_time`` the model reads neither
    ``noise_level`` nor ``context_emb``."""

    def __init__(self, in_node_dim: int = 6, hidden_dim: int = 256, edge_ch: int = 2,
                 n_heads: int = 16, n_layers: int = 8, dropout: float = 0.0,
                 cond_time: bool = True, dist_gbf: bool = True,
                 gbf_name: str = "CondGaussianLayer", mlp_ratio: int = 2,
                 spatial_cut_off: float = 2.0, trans_ver: str = "v2",
                 spectra_version: str = "ir", patch_len=(20, 50, 50), stride=(10, 25, 25),
                 remat_policy: str = "full", dtype: torch.dtype = torch.float32):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: takes one of {REMAT_POLICIES}")
        if gbf_name not in GBF_LAYERS:
            raise ValueError(f"gbf_name {gbf_name!r}: takes one of {sorted(GBF_LAYERS)}")
        self.dtype, self.dropout, self.remat_policy = dtype, dropout, remat_policy
        self.cond_time, self.dist_gbf, self.spatial_cut_off = cond_time, dist_gbf, spatial_cut_off
        De = hidden_dim // 4
        self.dist_dim = De if dist_gbf else 1
        time_dim = hidden_dim * 4
        self.node_emb = NodeEmbed(2 * in_node_dim, hidden_dim)
        self.cond_encoder = SpecFormer(spectra_version, patch_len, stride, output_dim=hidden_dim)
        self.cond_lin = Dense(hidden_dim, time_dim)
        if cond_time:
            self.time_emb = LearnedSinusoidalPosEmb(16)
            self.time_mlp_1 = Dense(17, time_dim)
            self.time_mlp_2 = Dense(time_dim, time_dim)
        if dist_gbf:
            self.dist_layer = GBF_LAYERS[gbf_name](De, time_dim if cond_time else None)
        self.edge_emb = Dense(2 * edge_ch + self.dist_dim, De)
        cat_node_dim = hidden_dim * 2 // n_layers
        cat_edge_dim = De * 2 // n_layers
        self.blocks = nn.ModuleList(
            Block(hidden_dim, De, time_dim, n_heads, cond_time, mlp_ratio, dropout, trans_ver,
                  dtype, cat_node_dim, cat_edge_dim)
            for _ in range(n_layers)
        )
        add_skip_heads(self, hidden_dim, De, in_node_dim, edge_ch, n_layers, cat_node_dim,
                       cat_edge_dim)
        self.pos_pred_mlp_0 = Dense(hidden_dim + n_layers * cat_node_dim, hidden_dim,
                                    use_bias=False)
        self.pos_pred_mlp_1 = Dense(hidden_dim, 3, use_bias=False)
        self.eval()  # deterministic until train(), as the JAX model's default

    @staticmethod
    def from_config(config) -> "DMT_WO_EQ":
        m = config.model
        return DMT_WO_EQ(
            in_node_dim=config.data.atom_types + int(m.include_fc_charge),
            hidden_dim=m.nf, edge_ch=m.edge_ch, n_heads=m.n_heads, n_layers=m.n_layers,
            dropout=m.dropout, cond_time=m.cond_time, dist_gbf=m.dist_gbf,
            gbf_name=m.gbf_name, mlp_ratio=m.mlp_ratio, spatial_cut_off=m.spatial_cut_off,
            trans_ver=m.trans_ver, spectra_version=config.data.spectra_version,
            patch_len=tuple(m.patch_len), stride=tuple(m.stride),
            remat_policy=m.remat_policy, dtype=configs.model_dtype(config),
        )

    def encode_context(self, specs, generator=None) -> torch.Tensor:
        """The spectra conditioning ``[B, time_dim]``, computed once per
        request (or train step) and passed to every forward as
        ``context_emb``; in training mode SpecFormer's BatchNorms use the
        batch's statistics and update the running ones."""
        return self.cond_lin(self.cond_encoder(specs, generator))

    def forward(self, t, xh, node_mask, edge_mask, edge_x, noise_level, cond_x, cond_edge_x,
                has_cond: bool, context_emb, dropout_seeds=None):
        B, N, _ = xh.shape
        if not has_cond:
            cond_x, cond_edge_x = torch.zeros_like(xh), torch.zeros_like(edge_x)
        # the noisy positions, not the self-conditioning ones
        h = h0 = self.node_emb(torch.cat([xh[:, :, 3:], cond_x[:, :, 3:]], dim=-1), xh[:, :, :3])

        time_emb = None
        if self.cond_time:
            time_emb = self.time_mlp_2(gelu(self.time_mlp_1(self.time_emb(noise_level))))
            if context_emb is not None:
                time_emb = time_emb + context_emb

        if has_cond:
            distances, _ = M.coord2diff_adj_dense(cond_x[:, :, :3], edge_mask,
                                                  self.spatial_cut_off)
            if self.dist_gbf:
                distances = self.dist_layer(distances, time_emb)
        else:
            distances = xh.new_zeros((B, N, N, self.dist_dim))
        edge_attr = edge_attr0 = self.edge_emb(torch.cat([edge_x, cond_edge_x, distances], -1))

        seeds, run = block_runner(self, dropout_seeds)
        cat_h, cat_e = [], []
        for block, seed in zip(self.blocks, seeds):
            h, edge_attr, ch, ce = run(block, seed, h, edge_attr, node_mask, edge_mask, time_emb)
            cat_h.append(ch)
            cat_e.append(ce)

        # the skip-concat heads read the embeddings from before the blocks
        atom_hids = torch.cat([h0, *cat_h], dim=-1)
        atom_pred, edge_final = skip_heads(self, atom_hids, torch.cat([edge_attr0, *cat_e], -1),
                                           node_mask, edge_mask)
        pos = self.pos_pred_mlp_1(torch.tanh(self.pos_pred_mlp_0(atom_hids))) * node_mask
        # a NaN anywhere zeroes the positions of the whole batch, then the
        # prediction is centred (the input was not)
        pos = torch.where(torch.isnan(pos).any(), torch.zeros_like(pos), pos)
        pos = M.remove_mean_with_mask(pos, node_mask)
        return torch.cat([pos, atom_pred], dim=2), edge_final
