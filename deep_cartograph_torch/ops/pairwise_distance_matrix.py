"""K3: all-pairs distance matrix per frame.

`pairwise_distance_matrix` launches the CUDA kernel
`csrc/pairwise_distance_matrix.cu` for CUDA tensors and takes the plain
PyTorch version `pairwise_distance_matrix_plain` only for CPU tensors. Both
compute exact per-channel differences, as the TPU kernel does. No path of
the JAX package calls its TPU kernel; this op is the port's counterpart,
held to it by the tests.
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

STATS = KernelStats("pairwise_distance_matrix_kernel")

# Elements of the (frames, A, A, 3) difference tensor the plain version
# materializes at once: frames are taken in chunks under this budget.
PLAIN_ELEMENT_BUDGET = 1 << 27
_MAX_ATOMS = 32 * 65535  # the kernel's row tiles span gridDim.y


def pairwise_distance_matrix_plain(coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: coords (F, A, 3) -> (F, A, A), frame chunk by
    frame chunk so the difference tensor never lands whole."""
    F, A, _ = coords.shape
    out = torch.empty((F, A, A), dtype=coords.dtype, device=coords.device)
    chunk = max(1, PLAIN_ELEMENT_BUDGET // max(3 * A * A, 1))
    for start in range(0, F, chunk):
        c = coords[start : start + chunk]
        diff = c[:, :, None, :] - c[:, None, :, :]
        out[start : start + chunk] = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return out


def pairwise_distance_matrix(coords: torch.Tensor) -> torch.Tensor:
    """All-pairs Euclidean distances of every frame.

    coords (F, A, 3) float32 -> (F, A, A) float32, in the units of coords.
    """
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (F, A, 3), got {tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device.type == "cpu":
        STATS.count_plain()
        return pairwise_distance_matrix_plain(coords)
    if coords.device.type != "cuda":
        raise ValueError(f"Unsupported device: {coords.device}")
    if not coords.is_contiguous():
        raise ValueError("pairwise_distance_matrix needs contiguous coords")
    if coords.shape[1] > _MAX_ATOMS:
        raise ValueError(f"{coords.shape[1]} atoms exceed the kernel's grid")
    F, A, _ = coords.shape
    out = torch.empty((F, A, A), dtype=torch.float32, device=coords.device)
    launch(coords, out)
    STATS.count_launch()
    return out


def launch(coords: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA tensors, counting nothing (for
    timing the bare kernel); `pairwise_distance_matrix` is the checked
    entry point."""
    lib = _library()
    F, A, _ = coords.shape
    # The launcher sets the thread's device; the guard restores the
    # caller's, which a launch on another card of a mesh would move.
    with torch.cuda.device(coords.device):
        status = lib.pairwise_distance_matrix(
            coords.data_ptr(), out.data_ptr(), F, A, coords.device.index,
            current_stream(coords.device),
        )
    check_status(lib, status, "pairwise_distance_matrix_kernel launch")


def _library() -> ctypes.CDLL:
    lib = load_library("pairwise_distance_matrix")
    if lib.pairwise_distance_matrix.argtypes is None:
        lib.pairwise_distance_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.pairwise_distance_matrix.restype = ctypes.c_int
    return lib
