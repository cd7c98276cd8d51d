"""Masked dense-graph tensor helpers (port of ``diffspectra_tpu/utils/masks.py``).

Every molecule lives in padded dense tensors: node features ``[B, N, F]``
with ``node_mask [B, N, 1]`` and pair features ``[B, N, N, C]`` with
``edge_mask [B, N, N]`` (float 0/1, diagonal excluded). Random draws take an
explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import torch


def build_masks(n_nodes: torch.Tensor, max_n: int):
    """``n_nodes [B]`` -> ``node_mask [B, N, 1]``, ``edge_mask [B, N, N]``
    (diagonal zeroed)."""
    ar = torch.arange(max_n, device=n_nodes.device)
    node_mask = (ar[None, :] < n_nodes[:, None]).float()
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    edge_mask = edge_mask * (1.0 - torch.eye(max_n, device=n_nodes.device))[None]
    return node_mask[:, :, None], edge_mask


def remove_mean_with_mask(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Subtract the masked mean over atoms (centre of mass removal)."""
    n = node_mask.sum(dim=1, keepdim=True)
    mean = x.sum(dim=1, keepdim=True) / n
    return x - mean * node_mask


def sample_combined_position_feature_noise(generator, bs, n_nodes, feat_nf, node_mask):
    """CoM-free position noise concatenated with masked feature noise,
    ``[B, N, 3 + feat_nf]``."""
    dev = node_mask.device
    z_x = torch.randn((bs, n_nodes, 3), generator=generator, device=dev) * node_mask
    z_x = remove_mean_with_mask(z_x, node_mask)
    z_h = torch.randn((bs, n_nodes, feat_nf), generator=generator, device=dev) * node_mask
    return torch.cat([z_x, z_h], dim=2)


def sample_symmetric_edge_feature_noise(generator, bs, n_nodes, edge_ch, edge_mask):
    """Symmetric normal noise ``[B, N, N, C]`` (strict lower triangle plus
    its transpose), zero off the real edges."""
    dev = edge_mask.device
    z = torch.randn((bs, n_nodes, n_nodes, edge_ch), generator=generator, device=dev)
    z = z * torch.tril(torch.ones((n_nodes, n_nodes), device=dev), -1)[None, :, :, None]
    z = z + z.transpose(1, 2)
    return z * edge_mask[..., None]


def coord2dist_dense(pos: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances ``[B, N, 3] -> [B, N, N, 1]``."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    return (diff * diff).sum(dim=-1, keepdim=True)


def coord2diff_adj_dense(pos, edge_mask, spatial_th: float = 2.0):
    """Squared distances and the spatial adjacency (d2 <= th) on real edges."""
    radial = coord2dist_dense(pos)
    adj = (radial[..., 0] <= spatial_th).to(pos.dtype) * edge_mask
    return radial, adj[..., None]


def symmetrize_edges(edge: torch.Tensor) -> torch.Tensor:
    """``0.5 * (E + E^T)`` over the two node axes."""
    return 0.5 * (edge + edge.transpose(1, 2))
