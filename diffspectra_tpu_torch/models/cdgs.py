"""CDGS, the 2-D graph noise-prediction model of the ``only_2D`` path (port
of ``diffspectra_tpu/models/cdgs.py``).

The model sees atoms and bonds, no positions. Each ``HybridMPBlock`` adds
a local message pass over the discretised adjacency (``DenseGINE``) to a
global attention over every real pair (``DenseEdgeGateTransLayer``), each
followed by a GroupNorm, then feed-forward nets on the nodes and on the
pairs. Random-walk landing probabilities and a shortest-path one-hot
(``utils/masks.py``) encode the graph's structure. JAX runs the model on
XLA and so does the port, on PyTorch ops: it launches no kernel of
``csrc/``.

The DMT's call: ``forward(t, xh, node_mask, edge_mask, edge_x,
noise_level, cond_x, cond_edge_x, has_cond, context_emb, dropout_seeds)``
and ``encode_context``; ``xh [B, N, atom_types]`` (with the charge, when
``in_node_dim`` counts it). The model reads ``t`` (as ``999 t``), not
``noise_level``, and no self-conditioning input. It returns the noise
scores ``(atom [B, N, atom_ch], bond [B, N, N, edge_ch])``, the bond
channels ``[exist, type]``, symmetric. Training mode draws dropout from a
generator a block seeded by ``dropout_seeds``; the model has no remat, as
JAX's has none.

``dtype`` (``training.matmul_precision``): in bfloat16 the layers that the
JAX module gives ``dtype=self.dtype`` compute in bfloat16: the ``proj_cate``,
``proj_exist``, ``proj_spd`` and ``proj_edge`` projections, the blocks'
time projections, GINE, the attention and the FFNs. The other
projections, the time MLP, the GroupNorms, the heads and SpecFormer stay
float32, and a bfloat16 op that only a cast to float32 reads keeps float32
(``Dense.forward_f32``), as XLA compiles the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import configs
from ..utils import masks as M
from ..utils.registry import register_model
from .layers import (
    Dense,
    DenseEdgeGateTransLayer,
    dropout,
    empty_param,
    seeded_generator,
    silu,
    sinusoidal_timestep_embedding,
)
from .specformer import SpecFormer


class DenseGINE(nn.Module):
    """Masked dense GINEConv: ``out_i = mlp((1 + eps) x_i + sum_j adj_ij
    relu(x_j + e_ij))``, ``eps`` a scalar parameter; the messages in
    ``dtype``, their sum and the self term in float32 (the float32 ``eps``
    promotes it), the MLP in ``dtype``, its output float32."""

    def __init__(self, dim_h: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = empty_param(())
        self.gin_nn_0 = Dense(dim_h, dim_h, dtype=dtype)
        self.gin_nn_1 = Dense(dim_h, dim_h, dtype=dtype)

    def forward(self, x, edge_attr, adj):
        dt = self.dtype
        x = x.to(dt)
        msgs = F.relu(x[:, None, :, :] + edge_attr.to(dt))  # [b, i, j]: x_j + e_ij
        # the sum in float32, unrounded: XLA keeps it so where only float32 reads it
        agg = torch.einsum("bij,bijd->bid", adj.to(dt).float(), msgs.float())
        out = (1 + self.eps) * x.float() + agg
        return self.gin_nn_1.forward_f32(F.relu(self.gin_nn_0(out)))


class _GroupNormParams(nn.Module):
    """flax ``nn.GroupNorm``'s parameters, per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = empty_param(channels)
        self.bias = empty_param(channels)


class GroupNormChannels(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(C // 4, 32), epsilon=1e-6)`` over
    the trailing channel axis of ``[B, ..., C]``: each group's mean and
    variance (``E[x^2] - E[x]^2``, at least 0) over every axis but the
    batch, the padding counted, in float32; its parameters sit under
    ``GroupNorm_0``, as flax names them."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = min(channels // 4, 32), eps
        self.GroupNorm_0 = _GroupNormParams(channels)

    def forward(self, x):
        G, C = self.groups, x.shape[-1]
        xg = x.float().reshape(x.shape[0], -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        p = self.GroupNorm_0
        mul = torch.rsqrt(var + self.eps) * p.scale.reshape(G, C // G)
        return ((xg - mean) * mul + p.bias.reshape(G, C // G)).reshape(x.shape)


class HybridMPBlock(nn.Module):
    """The local GINE over the discretised adjacency and the global
    edge-gated attention over every real pair, each added to the block's
    input and normalised, then the FFNs of the nodes and of the pairs
    (rebuilt from the nodes, ``h_i + h_j``); ``temb`` (None without
    ``cond_time``) shifts the inputs first."""

    def __init__(self, dim_h: int, num_heads: int = 8, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, cond_time: bool = True):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        if cond_time:
            self.t_edge = Dense(dim_h, dim_h, dtype=dtype)
            self.t_node = Dense(dim_h, dim_h, dtype=dtype)
        self.local_model = DenseGINE(dim_h, dtype)
        self.norm1_local = GroupNormChannels(dim_h)
        self.self_attn = DenseEdgeGateTransLayer(dim_h, dim_h // num_heads, num_heads, dropout,
                                                 dtype)
        self.norm1_attn = GroupNormChannels(dim_h)
        self.ff_linear1 = Dense(dim_h, 2 * dim_h, dtype=dtype)
        self.ff_linear2 = Dense(2 * dim_h, dim_h, dtype=dtype)
        self.ff_linear3 = Dense(dim_h, 2 * dim_h, dtype=dtype)
        self.ff_linear4 = Dense(2 * dim_h, dim_h, dtype=dtype)
        self.norm2_node = GroupNormChannels(dim_h)
        self.norm2_edge = GroupNormChannels(dim_h)

    def forward(self, x, dense_edge, adj, node_mask, edge_mask, temb=None, generator=None):
        """``x [B, N, D]``, ``dense_edge [B, N, N, D]``, ``adj [B, N, N]``
        (discretised), ``node_mask [B, N, 1]``, ``edge_mask [B, N, N]`` ->
        ``(h, h_edge)``, float32."""
        p = self.dropout
        drop = lambda v: dropout(v, p, generator)
        adj_mask = edge_mask[..., None]
        h_in1, h_in2 = x, dense_edge
        if temb is not None:
            temb_act = silu(temb.to(self.dtype))
            h_edge = (dense_edge + self.t_edge(temb_act).float()[:, None, None, :]) * adj_mask
            h = (x + self.t_node(temb_act).float()[:, None, :]) * node_mask
        else:
            h_edge, h = dense_edge, x

        h_local = self.local_model(h, h_edge, adj) * node_mask
        h_local = self.norm1_local(h_in1 + drop(h_local))
        h_attn = self.self_attn(h, h_edge, edge_mask, generator) * node_mask
        h_attn = self.norm1_attn(h_in1 + drop(h_attn))

        h = (h_local + h_attn) * node_mask
        h_edge = h[:, :, None, :] + h[:, None, :, :]
        ff = lambda v, first, second: drop(second.forward_f32(drop(silu(first(v)))))
        h = h + ff(h, self.ff_linear1, self.ff_linear2)
        h = self.norm2_node(h) * node_mask
        h_edge = h_in2 + ff(h_edge, self.ff_linear3, self.ff_linear4)
        return h, self.norm2_edge(h_edge) * adj_mask


@register_model(name="CDGS")
class CDGS(nn.Module):
    """``forward(...) -> (atom_score [B, N, atom_ch], bond_score [B, N, N,
    edge_ch])``. Without ``cond_time`` the blocks get no time embedding and
    the model reads neither ``t`` nor ``context_emb``."""

    def __init__(self, atom_ch: int = 5, in_node_dim: int = 5, nf: int = 256, n_layers: int = 8,
                 n_heads: int = 8, dropout: float = 0.0, cond_time: bool = True,
                 rw_depth: int = 8, edge_ch: int = 2, centered: bool = True,
                 spectra_version: str = "ir", patch_len=(20, 50, 50), stride=(10, 25, 25),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout, self.cond_time = dtype, dropout, cond_time
        self.nf, self.n_layers, self.rw_depth, self.centered = nf, n_layers, rw_depth, centered
        self.cond_encoder = SpecFormer(spectra_version, patch_len, stride, output_dim=nf)
        self.cond_lin = Dense(nf, nf)
        if cond_time:
            self.temb_0 = Dense(nf, 2 * nf)
            self.temb_1 = Dense(2 * nf, nf)
        bond_se_ch = int(nf * 0.4)
        bond_type_ch = int(0.5 * (nf - bond_se_ch))
        self.proj_cate = Dense(edge_ch - 1, bond_type_ch, dtype=dtype)
        self.proj_exist = Dense(1, bond_type_ch, dtype=dtype)
        self.proj_spd = Dense(rw_depth + 1, bond_se_ch, dtype=dtype)
        self.proj_edge = Dense(2 * bond_type_ch + bond_se_ch, nf, dtype=dtype)
        atom_se_ch = int(nf * 0.2)
        atom_type_ch = nf - 2 * atom_se_ch
        self.proj_degree = Dense(edge_ch, atom_se_ch)
        self.proj_atom = Dense(in_node_dim, atom_type_ch)
        self.proj_rwl = Dense(rw_depth, atom_se_ch)
        self.proj_node = Dense(2 * atom_se_ch + atom_type_ch, nf)
        cat_dim = 2 * nf // n_layers
        for i in range(n_layers):
            setattr(self, f"block_{i}", HybridMPBlock(nf, n_heads, dropout, dtype, cond_time))
            setattr(self, f"node_{i}", Dense(nf, cat_dim))
            setattr(self, f"edge_{i}", Dense(nf, cat_dim))
        self.atom_out_0 = Dense(atom_type_ch + n_layers * cat_dim, nf)
        self.atom_out_1 = Dense(nf, nf // 2)
        self.atom_out_2 = Dense(nf // 2, atom_ch)
        for head, in_dim, out in (("bond", bond_type_ch, edge_ch - 1), ("exist", bond_type_ch, 1)):
            setattr(self, f"{head}_out_0", Dense(in_dim + n_layers * cat_dim, nf))
            setattr(self, f"{head}_out_1", Dense(nf, nf // 2))
            setattr(self, f"{head}_out_2", Dense(nf // 2, out))
        self.eval()  # deterministic until train(), as the JAX model's default

    @property
    def blocks(self):
        """The blocks in order (flax names them ``block_<i>``, unstacked)."""
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    @staticmethod
    def from_config(config) -> "CDGS":
        m = config.model
        return CDGS(
            atom_ch=config.data.atom_types,
            in_node_dim=config.data.atom_types + int(m.include_fc_charge),
            nf=m.nf, n_layers=m.n_layers, n_heads=m.n_heads, dropout=m.dropout,
            cond_time=m.cond_time, rw_depth=m.rw_depth, edge_ch=m.edge_ch,
            centered=config.data.centered, spectra_version=config.data.spectra_version,
            patch_len=tuple(m.patch_len), stride=tuple(m.stride),
            dtype=configs.model_dtype(config),
        )

    def encode_context(self, specs, generator=None) -> torch.Tensor:
        """The spectra conditioning ``[B, nf]`` (SpecFormer in float32, then
        ``cond_lin``), computed once per request (or train step) and passed
        to every forward as ``context_emb``; in training mode SpecFormer's
        BatchNorms use the batch's statistics and update the running ones."""
        return self.cond_lin(self.cond_encoder(specs, generator))

    def forward(self, t, xh, node_mask, edge_mask, edge_x, noise_level=None, cond_x=None,
                cond_edge_x=None, has_cond: bool = False, context_emb=None, dropout_seeds=None):
        if self.training and self.dropout > 0 and dropout_seeds is None:
            raise ValueError("a CDGS in training mode with dropout takes dropout_seeds")
        seeds = (list(dropout_seeds) if self.training and dropout_seeds is not None
                 else [None] * self.n_layers)
        atom_feat, bond_feat = xh, edge_x
        edge_exist, edge_cate = bond_feat[..., 0:1], bond_feat[..., 1:]

        temb = None
        if self.cond_time:
            temb = sinusoidal_timestep_embedding(t * 999.0, self.nf)
            temb = self.temb_1(silu(self.temb_0(temb)))
            if context_emb is not None:
                temb = temb + context_emb

        if not self.centered:
            atom_feat = atom_feat * 2.0 - 1.0
            bond_feat = bond_feat * 2.0 - 1.0

        with torch.no_grad():
            # the discretised adjacency of the noisy exist channel, its
            # random-walk landing probabilities and shortest-path one-hot
            adj = (edge_exist[..., 0] >= 0.0).to(xh.dtype) * edge_mask
            rw_map = M.random_walk_maps(self.rw_depth, adj)
            rw_landing = torch.diagonal(rw_map, dim1=2, dim2=3).transpose(1, 2)
            spd = M.spd_onehot(rw_map, self.rw_depth)

        adj_mask = edge_mask[..., None]
        dense_cate = self.proj_cate.forward_f32(edge_cate) * adj_mask
        dense_exist = self.proj_exist.forward_f32(edge_exist) * adj_mask
        dense_spd = self.proj_spd.forward_f32(spd) * adj_mask
        dense_edge = self.proj_edge.forward_f32(
            torch.cat([dense_cate, dense_exist, dense_spd], dim=-1)) * adj_mask

        atom_degree = self.proj_degree(bond_feat.sum(dim=2))  # the noisy bonds, summed over j
        atom_cate = self.proj_atom(atom_feat)
        h_atom = self.proj_node(torch.cat([atom_degree, atom_cate, self.proj_rwl(rw_landing)], -1))

        h_edge = dense_edge
        atom_hids, bond_hids = [], []
        for i, (block, seed) in enumerate(zip(self.blocks, seeds)):
            h_atom, h_edge = block(h_atom, h_edge, adj, node_mask, edge_mask, temb,
                                   seeded_generator(seed, xh.device))
            atom_hids.append(getattr(self, f"node_{i}")(h_atom))
            bond_hids.append(getattr(self, f"edge_{i}")(h_edge))
        atom_hids, bond_hids = torch.cat(atom_hids, -1), torch.cat(bond_hids, -1)

        atom_score = F.silu(self.atom_out_0(torch.cat([atom_cate, atom_hids], -1))) * node_mask
        atom_score = self.atom_out_2(F.silu(self.atom_out_1(atom_score)))
        scores = []
        for head, first in (("exist", dense_exist), ("bond", dense_cate)):
            s = F.silu(getattr(self, f"{head}_out_0")(torch.cat([first, bond_hids], -1)))
            s = F.silu(getattr(self, f"{head}_out_1")(s * adj_mask))
            scores.append(getattr(self, f"{head}_out_2")(s))
        bond_score = M.symmetrize_edges(torch.cat(scores, dim=-1))
        return atom_score * node_mask, bond_score * adj_mask
