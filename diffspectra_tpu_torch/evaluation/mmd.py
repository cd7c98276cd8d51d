"""Multi-kernel Gaussian MMD over scalar samples, the port of
``diffspectra_tpu/evaluation/mmd.py`` (the DIG implementation): the
bandwidth is the mean pairwise squared distance over the pooled sample,
divided by ``kernel_mul ** (kernel_num // 2)``, and five kernels sit at
powers of ``kernel_mul`` from it.

The O(n^2) kernel sums run on the device (``cuda`` unless ``device="cpu"``)
as one PyTorch function in float32, in blocks of rows, so that no pooled
``[n, n]`` matrix beyond a block is held: at the sub-geometry MMDs' cap of
10,000 samples a side that matrix would hold 4e8 floats. Only each block's
sum is added in float64. ``kernel_sums_plain`` is the JAX package's float64
numpy loop, the plain version the tests and ``chip_smoke.py`` hold the
device sums to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# elements of one block of the pairwise matrix (64 MiB in float32)
BLOCK_ELEMENTS = 1 << 24


def _bandwidths(bandwidth, kernel_mul: float, kernel_num: int):
    base = bandwidth / (kernel_mul ** (kernel_num // 2))
    return [base * (kernel_mul**i) for i in range(kernel_num)]


def kernel_sums(total: torch.Tensor, n_source: int, kernel_mul: float = 2.0,
                kernel_num: int = 5, fix_sigma=None):
    """``(xx, yy, xy)``: the sums of the five kernels over source x source,
    target x target and source x target pairs of the pooled float32 sample
    ``total`` (the source its first ``n_source`` entries), on ``total``'s
    device. The bandwidth is ``fix_sigma`` where given, else the mean
    pairwise squared distance over ``total``."""
    n = total.numel()
    rows = max(1, BLOCK_ELEMENTS // n)
    if fix_sigma:
        bandwidth = fix_sigma
    else:
        d2_sum = torch.zeros((), dtype=torch.float64, device=total.device)
        for start in range(0, n, rows):
            d2_sum += ((total[start : start + rows, None] - total[None, :]) ** 2).sum().double()
        bandwidth = (d2_sum / (n * n - n)).float()
    bandwidths = _bandwidths(bandwidth, kernel_mul, kernel_num)

    def block_sum(block, cols):
        d2 = (block[:, None] - cols[None, :]) ** 2
        k = torch.exp(-d2 / bandwidths[0])
        for bw in bandwidths[1:]:
            k += torch.exp(-d2 / bw)
        return k

    sums = torch.zeros(3, dtype=torch.float64, device=total.device)  # xx, yy, xy
    source, target = total[:n_source], total[n_source:]
    for start in range(0, n_source, rows):  # source rows against every column
        k = block_sum(source[start : start + rows], total)
        sums[0] += k[:, :n_source].sum().double()
        sums[2] += k[:, n_source:].sum().double()
    for start in range(0, n - n_source, rows):  # target rows against the targets
        sums[1] += block_sum(target[start : start + rows], target).sum().double()
    xx, yy, xy = sums.tolist()
    return xx, yy, xy


def kernel_sums_plain(total: np.ndarray, n_source: int, kernel_mul: float = 2.0,
                      kernel_num: int = 5, fix_sigma=None, batch_size: int = 1000):
    """The plain version of ``kernel_sums``: the JAX package's batched
    numpy loop (``_kernel_sums_numpy``) in float64."""
    total = np.asarray(total, dtype=np.float64)
    n = len(total)
    if fix_sigma:
        bandwidth = fix_sigma
    else:
        bandwidth = 0.0
        for start in range(0, n, batch_size):
            chunk = total[start : start + batch_size]
            bandwidth += ((total[None, :] - chunk[:, None]) ** 2).sum()
        bandwidth /= n**2 - n
    bandwidths = _bandwidths(bandwidth, kernel_mul, kernel_num)

    xx = yy = xy = 0.0
    for start in range(0, n, batch_size):
        chunk = total[start : start + batch_size]
        d2 = (chunk[:, None] - total[None, :]) ** 2
        k = sum(np.exp(-d2 / bw) for bw in bandwidths)
        rows = np.arange(start, min(start + batch_size, n))
        src_rows = rows < n_source
        xx += k[src_rows][:, :n_source].sum()
        yy += k[~src_rows][:, n_source:].sum()
        xy += k[src_rows][:, n_source:].sum()
    return float(xx), float(yy), float(xy)


def mmd_from_sums(xx: float, yy: float, xy: float, n_source: int, n_target: int) -> float:
    return float(xx / (n_source**2) + yy / (n_target**2) - 2 * xy / (n_source * n_target))


def compute_mmd(source, target, kernel_mul: float = 2.0, kernel_num: int = 5,
                fix_sigma=None, device=None) -> float:
    """The MMD between two scalar samples, its kernel sums on ``device``
    (``cuda`` unless ``device="cpu"``)."""
    device = resolve_device(device)
    source = np.asarray(source, dtype=np.float32).reshape(-1)
    target = np.asarray(target, dtype=np.float32).reshape(-1)
    total = torch.from_numpy(np.concatenate([source, target])).to(device)
    xx, yy, xy = kernel_sums(total, len(source), kernel_mul, kernel_num, fix_sigma)
    return mmd_from_sums(xx, yy, xy, len(source), len(target))
