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


def sample_gaussian_with_mask(generator, shape, node_mask):
    """Standard normal noise of ``shape`` zeroed at padded atoms (the 2-D
    path's node noise: no positions to centre)."""
    return torch.randn(shape, generator=generator, device=node_mask.device) * node_mask


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


def sample_node_noise(generator, shape, node_mask, only_2d: bool = False):
    """Node noise of ``shape`` ``[B, N, F]``: with ``only_2d`` masked (no
    positions), else CoM-free in the first three (position) channels."""
    if only_2d:
        return sample_gaussian_with_mask(generator, shape, node_mask)
    bs, n_nodes, nf = shape
    return sample_combined_position_feature_noise(generator, bs, n_nodes, nf - 3, node_mask)


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


def random_walk_maps(k_step: int, dense_adj: torch.Tensor) -> torch.Tensor:
    """``k_step`` random-walk maps ``[B, k, N, N]`` of ``dense_adj [B, N,
    N]``: with ``ad = adj / (degree + 1e-8)`` (a padded row, of degree 0,
    walks nowhere), the powers ``ad^2 ... ad^(k+1)``, as the JAX model
    stacks them (its first product is ``ad @ ad``)."""
    ad = dense_adj / (dense_adj.sum(dim=-1, keepdim=True) + 1e-8)
    maps = [ad @ ad]
    for _ in range(k_step - 1):
        maps.append(maps[-1] @ ad)
    return torch.stack(maps, dim=1)


def spd_onehot(rw_map: torch.Tensor, k_step: int) -> torch.Tensor:
    """The shortest-path-distance one-hot ``[B, N, N, k_step + 1]`` of the
    walk maps ``[B, k, N, N]``: the index is the number of steps that do not
    reach j from i (a probability <= 0). The JAX function sorts the maps
    over the steps first, which leaves that count as it is."""
    return torch.nn.functional.one_hot((rw_map <= 0).sum(dim=1), k_step + 1).float()


def get_rw_feat_dense(k_step: int, dense_adj: torch.Tensor) -> torch.Tensor:
    """The k-step random-walk shortest-path-distance one-hot features
    ``[B, N, N, k_step + 1]`` of ``dense_adj [B, N, N]``, without
    gradient."""
    with torch.no_grad():
        return spd_onehot(random_walk_maps(k_step, dense_adj), k_step)
