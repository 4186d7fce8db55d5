"""Free-energy surfaces: Gaussian KDE + block-error estimation on the device.

The port of the JAX package's fes/kde.py. Small problems evaluate the whole
(grid, samples) log-kernel matrix in plain PyTorch; above 5e7 grid x sample
pairs the streaming kernel K2 (ops/kde.py) evaluates each block's
logsumexp without ever holding that matrix, each block's samples sharded
over the call's mesh (`parallel.mesh.mesh_for`: the device alone, or
several, K2 on every shard). `plot_fes` computes the surface, then draws
it (matplotlib, imported only there).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.parallel.mesh import mesh_for
from deep_cartograph_torch.parallel.sharding import sharded_kde_logsumexp
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
    """Blockwise FES through the streaming logsumexp kernel K2, each
    block's samples sharded over `mesh_for(device)`
    (`parallel.sharding.sharded_kde_logsumexp`). Returns numpy arrays
    (fes, error or None)."""
    dev = resolve_device(device)
    mesh = mesh_for(dev)
    inv_two_bw2 = 1.0 / (2.0 * bandwidth * bandwidth)
    grid_d = torch.as_tensor(np.asarray(grid_points, np.float32), device=dev)
    data_d = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    fes, error = _blockwise_fes(
        data_d, kt, num_blocks,
        lambda chunk: sharded_kde_logsumexp(grid_d, chunk, inv_two_bw2, mesh),
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


def plot_fes(
    data: np.ndarray,
    cv_labels: Sequence[str],
    settings: Dict,
    output_path: str,
    num_blocks: int = 1,
    sup_data: Optional[List[np.ndarray]] = None,
    sup_data_labels: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> None:
    """Compute and draw the FES (fes_<labels>.png in `output_path`) and, with
    `settings["save"]`, save it with its grid and block error as .npy. With
    `settings["compute"]` false nothing happens; otherwise the surface is
    computed before matplotlib is imported, so a missing matplotlib raises
    after the computation."""
    from deep_cartograph_torch.figures.plots import pyplot

    if not settings.get("compute", True):
        return
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    d = data.shape[1]
    axes_grid, fes, error = compute_fes(
        data,
        temperature=settings.get("temperature", 300),
        bandwidth=settings.get("bandwidth", 0.05),
        num_bins=settings.get("num_bins", 100),
        num_blocks=num_blocks,
        device=device,
    )
    max_fes = settings.get("max_fes")
    plt = pyplot()

    os.makedirs(output_path, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 5))
    masked = np.where(
        (fes > max_fes) if max_fes is not None else np.zeros_like(fes, bool),
        np.nan,
        fes,
    )
    if d == 1:
        ax.plot(axes_grid[0], masked, color="#4878d0")
        if error is not None:
            ax.fill_between(
                axes_grid[0],
                masked - 2 * error,
                masked + 2 * error,
                alpha=0.3,
                color="#4878d0",
            )
        if sup_data is not None:
            for si, sup in enumerate(sup_data):
                label = (
                    sup_data_labels[si]
                    if sup_data_labels and si < len(sup_data_labels)
                    else f"sup_{si}"
                )
                heights = np.interp(np.asarray(sup).ravel(), axes_grid[0], masked)
                ax.scatter(np.asarray(sup).ravel(), heights, s=12, label=label)
            ax.legend(fontsize=7)
        ax.set_xlabel(cv_labels[0])
        ax.set_ylabel("FES (kJ/mol)")
    else:
        cs = ax.contourf(
            axes_grid[0],
            axes_grid[1],
            masked.T,
            levels=settings.get("num_fes_levels", 10),
            cmap="fessa" if "fessa" in plt.colormaps() else "viridis",
        )
        fig.colorbar(cs, ax=ax, label="FES (kJ/mol)")
        if sup_data is not None:
            for si, sup in enumerate(sup_data):
                label = (
                    sup_data_labels[si]
                    if sup_data_labels and si < len(sup_data_labels)
                    else f"sup_{si}"
                )
                ax.scatter(sup[:, 0], sup[:, 1], s=12, label=label)
            ax.legend(fontsize=7)
        ax.set_xlabel(cv_labels[0])
        ax.set_ylabel(cv_labels[1])

    name = "_".join(str(lbl).replace(" ", "_") for lbl in cv_labels)
    fig.savefig(
        os.path.join(output_path, f"fes_{name}.png"), dpi=150, bbox_inches="tight"
    )
    plt.close(fig)

    if settings.get("save", False):
        np.save(os.path.join(output_path, f"fes_{name}.npy"), fes)
        for i, axis in enumerate(axes_grid):
            np.save(os.path.join(output_path, f"grid_{name}_{i}.npy"), axis)
        if error is not None:
            np.save(os.path.join(output_path, f"fes_error_{name}.npy"), error)
