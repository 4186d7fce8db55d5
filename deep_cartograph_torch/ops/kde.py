"""K2: streaming KDE logsumexp, log sum_j exp(-|g_i - x_j|^2 * inv_two_bw2).

`kde_logsumexp` launches the CUDA kernel `csrc/kde_logsumexp.cu` for CUDA
tensors and takes the plain PyTorch version `kde_logsumexp_plain` only for
CPU tensors. Both see grid and samples pre-scaled by sqrt(inv_two_bw2),
exactly as the TPU kernel's wrapper scales them, so the kernel computes a
plain squared distance.
"""

from __future__ import annotations

import ctypes

import torch

from deep_cartograph_torch.ops.build import (
    KernelStats,
    check_status,
    current_stream,
    load_library,
)

STATS = KernelStats("kde_logsumexp_kernel")

MAX_DIM = 8


def kde_logsumexp_plain(
    grid_scaled: torch.Tensor, samples_scaled: torch.Tensor, block: int = 2048
) -> torch.Tensor:
    """Plain PyTorch version on pre-scaled inputs: (G, D), (N, D) -> (G,).

    An online (max, sum) over sample blocks of `block`, as the TPU kernel
    streams them, so the (G, N) matrix is never held whole."""
    G = grid_scaled.shape[0]
    m = torch.full((G,), float("-inf"), dtype=torch.float32, device=grid_scaled.device)
    s = torch.zeros((G,), dtype=torch.float32, device=grid_scaled.device)
    for blk in torch.split(samples_scaled, block):
        diff = grid_scaled[:, None, :] - blk[None, :, :]
        logk = -torch.sum(diff * diff, dim=-1)
        new_m = torch.maximum(m, logk.amax(dim=1))
        s = s * torch.exp(m - new_m) + torch.exp(logk - new_m[:, None]).sum(dim=1)
        m = new_m
    return m + torch.log(torch.clamp_min(s, 1e-38))


def _scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * scale).contiguous()


def kde_logsumexp(
    grid_points: torch.Tensor, samples: torch.Tensor, inv_two_bw2: float
) -> torch.Tensor:
    """log sum_j exp(-|g_i - x_j|^2 / (2 bw^2)) for all grid points.

    grid_points (G, D), samples (N, D), 1 <= D <= 8, N >= 1. Returns (G,)
    float32 on the inputs' device.
    """
    if grid_points.dim() != 2 or samples.dim() != 2:
        raise ValueError("grid_points and samples must be 2-D")
    G, D = grid_points.shape
    N = samples.shape[0]
    if samples.shape[1] != D or not 1 <= D <= MAX_DIM:
        raise ValueError(
            f"grid (G, {D}) and samples (N, {samples.shape[1]}) need one "
            f"dimension D in 1..{MAX_DIM}"
        )
    if N == 0:
        raise ValueError("kde_logsumexp needs at least one sample")
    if grid_points.device != samples.device:
        raise ValueError("grid_points and samples must be on the same device")
    device = grid_points.device
    scale = torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32)).to(device)
    grid_s = _scale(grid_points, scale)
    samples_s = _scale(samples, scale)
    if device.type == "cpu":
        STATS.count_plain()
        return kde_logsumexp_plain(grid_s, samples_s)
    if device.type != "cuda":
        raise ValueError(f"Unsupported device: {device}")
    out = torch.empty((G,), dtype=torch.float32, device=device)
    launch(grid_s, samples_s, out)
    STATS.count_launch()
    return out


def launch(grid_s: torch.Tensor, samples_s: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked, pre-scaled, contiguous CUDA tensors,
    counting nothing (for timing the bare kernel); `kde_logsumexp` is the
    checked entry point."""
    lib = _library()
    device = grid_s.device
    (G, D), N = grid_s.shape, samples_s.shape[0]
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = lib.kde_logsumexp_splits(G, N, D, num_sms)
    part = torch.empty((2, splits, G), dtype=torch.float32, device=device)
    # The launcher sets the thread's device; the guard restores the
    # caller's, which a launch on another card of a mesh would move.
    with torch.cuda.device(device):
        status = lib.kde_logsumexp(
            grid_s.data_ptr(), samples_s.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), out.data_ptr(), G, N, D, splits, device.index,
            current_stream(device),
        )
    check_status(lib, status, "kde_logsumexp_kernel launch")


def _library() -> ctypes.CDLL:
    lib = load_library("kde_logsumexp")
    if lib.kde_logsumexp.argtypes is None:
        lib.kde_logsumexp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.kde_logsumexp.restype = ctypes.c_int
        lib.kde_logsumexp_splits.argtypes = [ctypes.c_int] * 4
        lib.kde_logsumexp_splits.restype = ctypes.c_int
    return lib
