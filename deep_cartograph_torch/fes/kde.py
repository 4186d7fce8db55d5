"""Free-energy surfaces: Gaussian KDE + block-error estimation on the device.

The port of the JAX package's fes/kde.py. Small problems evaluate the whole
(grid, samples) log-kernel matrix in plain PyTorch; above 5e7 grid x sample
pairs the streaming kernel K2 (ops/kde.py) evaluates each block's
logsumexp without ever holding that matrix.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.ops.kde import kde_logsumexp
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

KB_KJ_MOL = 0.00831446261815324  # kJ/(mol K)

# Above this many grid x sample pairs the streaming kernel takes over.
STREAMING_THRESHOLD = 50_000_000


def _inv_two_bw2(bandwidth: float) -> float:
    """1 / (2 bw^2) rounded as float32 arithmetic computes it."""
    bw = np.float32(bandwidth)
    return float(np.float32(1.0) / (np.float32(2.0) * bw * bw))


def _kde_fes_device(samples, grid_points, bandwidth, kt, num_blocks: int):
    """FES on grid points + per-block FES for error bars.

    samples: (n, d) tensor — n must be divisible by num_blocks (caller trims).
    grid_points: (g, d) tensor on the same device.
    """
    n = samples.shape[0]
    diff2 = torch.sum(
        (grid_points[:, None, :] - samples[None, :, :]) ** 2, dim=-1
    )  # (g, n)
    logk = -diff2 * _inv_two_bw2(bandwidth)

    # Full-data density (unnormalized is fine: FES is shifted to min 0)
    logp = torch.logsumexp(logk, dim=1) - math.log(n)
    fes = -kt * logp
    fes = fes - torch.min(fes)

    # Block FES estimates
    blocks = logk.reshape(grid_points.shape[0], num_blocks, n // num_blocks)
    logp_b = torch.logsumexp(blocks, dim=2) - math.log(n // num_blocks)
    fes_b = -kt * logp_b
    fes_b = fes_b - torch.amin(fes_b, dim=0, keepdim=True)
    error = torch.std(fes_b, dim=1, correction=0) / math.sqrt(num_blocks)
    return fes, error


def _blockwise_fes(
    data: torch.Tensor,
    kt: float,
    num_blocks: int,
    block_logsumexp: Callable[[torch.Tensor], torch.Tensor],
):
    """Blockwise FES: per-block raw logsumexp densities combine exactly into
    the full-data estimate (logsumexp over all samples = logsumexp_b of the
    block values); block FES estimates give the standard block error.
    `block_logsumexp(chunk) -> (grid,)` raw logsumexp over the chunk."""
    n = data.shape[0]
    block_len = n // num_blocks
    block_lse = torch.stack([
        block_logsumexp(data[b * block_len : (b + 1) * block_len])
        for b in range(num_blocks)
    ])  # (num_blocks, grid)
    full_logp = torch.logsumexp(block_lse, dim=0) - math.log(n)
    fes = -kt * full_logp
    fes = fes - fes.min()
    if num_blocks > 1:
        fes_b = -kt * (block_lse - math.log(block_len))
        fes_b = fes_b - fes_b.amin(dim=1, keepdim=True)
        error = fes_b.std(dim=0, correction=0) / math.sqrt(num_blocks)
    else:
        error = None
    return fes, error


def _kde_fes_streaming(
    data: np.ndarray,
    grid_points: np.ndarray,
    bandwidth: float,
    kt: float,
    num_blocks: int,
    device: DeviceLike = None,
):
    """Blockwise FES through the streaming logsumexp kernel K2. Returns
    numpy arrays (fes, error or None)."""
    dev = resolve_device(device)
    inv_two_bw2 = 1.0 / (2.0 * bandwidth * bandwidth)
    grid_d = torch.as_tensor(np.asarray(grid_points, np.float32), device=dev)
    data_d = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    fes, error = _blockwise_fes(
        data_d, kt, num_blocks,
        lambda chunk: kde_logsumexp(grid_d, chunk, inv_two_bw2),
    )
    return fes.cpu().numpy(), None if error is None else error.cpu().numpy()


def compute_fes(
    data: np.ndarray,
    temperature: float = 300.0,
    bandwidth: float = 0.05,
    num_bins: int = 100,
    num_blocks: int = 1,
    bounds: Optional[Sequence[Tuple[float, float]]] = None,
    device: DeviceLike = None,
) -> Tuple[List[np.ndarray], np.ndarray, Optional[np.ndarray]]:
    """KDE free-energy surface (kJ/mol, min set to zero).

    Returns (grid_axes, fes, error). 1-D: fes shape (num_bins,);
    2-D: (num_bins, num_bins) with fes[i, j] at (x=grid[0][i], y=grid[1][j]).
    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host.
    """
    dev = resolve_device(device)
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n, d = data.shape
    if d > 2:
        raise ValueError("FES supports 1 or 2 dimensions")
    kt = KB_KJ_MOL * temperature

    if bounds is None:
        bounds = [(data[:, i].min(), data[:, i].max()) for i in range(d)]
    axes = [
        np.linspace(lo, hi, num_bins).astype(np.float32) for lo, hi in bounds
    ]
    if d == 1:
        grid_points = axes[0][:, None]
    else:
        gx, gy = np.meshgrid(axes[0], axes[1], indexing="ij")
        grid_points = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)

    num_blocks = max(1, min(num_blocks, n))
    n_trim = (n // num_blocks) * num_blocks

    if grid_points.shape[0] * n_trim > STREAMING_THRESHOLD:
        fes, error = _kde_fes_streaming(
            data[:n_trim], grid_points, bandwidth, kt, num_blocks, dev
        )
    else:
        fes_t, error_t = _kde_fes_device(
            torch.as_tensor(data[:n_trim], device=dev),
            torch.as_tensor(grid_points, device=dev),
            bandwidth,
            kt,
            num_blocks,
        )
        fes = fes_t.cpu().numpy()
        error = error_t.cpu().numpy() if num_blocks > 1 else None
    if d == 2:
        fes = fes.reshape(num_bins, num_bins)
        if error is not None:
            error = error.reshape(num_bins, num_bins)
    return axes, fes, error
