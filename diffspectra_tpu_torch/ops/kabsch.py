"""Batched Kabsch rotation alignment (port of
``diffspectra_tpu/ops/kabsch.py``): a 3x3 ``torch.linalg.svd`` a molecule,
under ``torch.no_grad()`` as JAX's under ``stop_gradient``, with the sign of
the determinant fixed so the rotation is proper. Not a Pallas kernel."""

from __future__ import annotations

import torch


@torch.no_grad()
def kabsch_batch(coords_pred: torch.Tensor, coords_tar: torch.Tensor) -> torch.Tensor:
    """Rotations ``[B, 3, 3]`` aligning ``coords_tar`` onto ``coords_pred``
    (both ``[B, N, 3]``)."""
    a = torch.einsum("bki,bkj->bij", coords_pred, coords_tar)
    u, _, vt = torch.linalg.svd(a, full_matrices=False)
    corr = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    corr[:, -1] = torch.sign(torch.linalg.det(a))
    return torch.einsum("bij,bj,bjk->bik", u, corr, vt)


@torch.no_grad()
def get_align_position(z_t: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """The clean positions (``xh[..., :3]``) rotated onto the noisy
    positions' (``z_t[..., :3]``) frame: ``pos_0 @ R^T``."""
    pos_0 = xh[..., :3]
    return pos_0 @ kabsch_batch(z_t[..., :3], pos_0).transpose(1, 2)


@torch.no_grad()
def get_align_position_v2(pos_t_com: torch.Tensor, pos_0_com: torch.Tensor) -> torch.Tensor:
    """The same on positions whose centre of mass is already removed."""
    return pos_0_com @ kabsch_batch(pos_t_com, pos_0_com).transpose(1, 2)


@torch.no_grad()
def get_align_noise(z_t, xh, alpha_t, sigma_t, noise, node_mask):
    """The position noise consistent with the rotation-aligned clean
    positions (for noise prediction)."""
    a, s = alpha_t[:, None, None], sigma_t[:, None, None]
    noise_pos = (z_t[..., :3] - a * get_align_position(z_t, xh)) / s
    return torch.cat([noise_pos, noise[..., 3:]], dim=-1)
