"""K1: pair distances (nm) from Angstrom coordinates and pair indices.

`pair_distances` launches the CUDA kernel `csrc/pair_distances.cu` for CUDA
tensors and takes the plain PyTorch version `pair_distances_plain` only for
CPU tensors. `selector_pair_distances` keeps the TPU kernel's signature
(coordinates and a +/-1 selector) by turning each selector column into a
pair of indices.
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

ANGSTROM_TO_NM = 0.1

STATS = KernelStats("pair_distances_kernel")


def pair_distances_plain(points: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: points (C, N, 3), pairs (P, 2) -> (C, P).

    A pair with an index outside [0, N) gives NaN, as in the kernel."""
    pairs = pairs.long()
    inside = ((pairs >= 0) & (pairs < points.shape[1])).all(dim=1)
    pairs = torch.where(inside[:, None], pairs, 0)
    diff = points[:, pairs[:, 0]] - points[:, pairs[:, 1]]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1)) * ANGSTROM_TO_NM
    return torch.where(inside, dist, float("nan"))


def _check(points: torch.Tensor, pairs: torch.Tensor) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (C, N, 3), got {tuple(points.shape)}")
    if pairs.dim() != 2 or pairs.shape[-1] != 2:
        raise ValueError(f"pairs must be (P, 2), got {tuple(pairs.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if pairs.dtype != torch.int32:
        raise TypeError(f"pairs must be int32, got {pairs.dtype}")
    if points.device != pairs.device:
        raise ValueError("points and pairs must be on the same device")


def pair_distances(points: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Distances between point pairs of every frame.

    points (C, N, 3) float32 Angstrom; pairs (P, 2) int32 with indices in
    [0, N). Returns (C, P) float32 nm. The indices are not checked here, as
    that would wait for the device on every call: callers check them once
    where they build the pairs, and a pair outside [0, N) gives NaN.
    """
    _check(points, pairs)
    if points.device.type == "cpu":
        STATS.plain_calls += 1
        return pair_distances_plain(points, pairs)
    if points.device.type != "cuda":
        raise ValueError(f"Unsupported device: {points.device}")
    if not (points.is_contiguous() and pairs.is_contiguous()):
        raise ValueError("pair_distances needs contiguous points and pairs")
    if pairs.data_ptr() % 8:
        raise ValueError("pairs must be 8-byte aligned (read as int2)")
    lib = _library()
    if points.shape[1] * 12 > lib.pair_distances_max_smem(points.device.index):
        raise ValueError(
            f"{points.shape[1]} points per frame exceed the shared-memory tile"
        )
    out = torch.empty(
        (points.shape[0], pairs.shape[0]), dtype=torch.float32, device=points.device
    )
    launch(points, pairs, out)
    STATS.launches += 1
    return out


def launch(points: torch.Tensor, pairs: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA tensors, counting nothing (for
    timing the bare kernel); `pair_distances` is the checked entry point."""
    lib = _library()
    C, N, _ = points.shape
    P = pairs.shape[0]
    status = lib.pair_distances(
        points.data_ptr(), pairs.data_ptr(), out.data_ptr(),
        C, N, P, points.device.index, current_stream(points.device),
    )
    check_status(lib, status, "pair_distances_kernel launch")


def _library() -> ctypes.CDLL:
    lib = load_library("pair_distances")
    if lib.pair_distances.argtypes is None:
        lib.pair_distances.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.pair_distances.restype = ctypes.c_int
        lib.pair_distances_max_smem.argtypes = [ctypes.c_int]
        lib.pair_distances_max_smem.restype = ctypes.c_int
    return lib


def selector_to_pairs(sel_t: torch.Tensor) -> torch.Tensor:
    """(A, P) selector columns -> (P, 2) int32 pairs (row of +1, row of -1).

    An all-zero column (padding) becomes pair (0, 0), whose distance is 0.
    Raises on a column that is neither all zero nor exactly one +1 and one -1.
    """
    sel = sel_t.detach().to("cpu", torch.float32)
    if sel.dim() != 2:
        raise ValueError(f"sel_t must be (A, P), got {tuple(sel.shape)}")
    plus = sel == 1
    minus = sel == -1
    zero = sel == 0
    n_plus = plus.sum(0)
    n_minus = minus.sum(0)
    valid = (plus | minus | zero).all(0) & (
        ((n_plus == 1) & (n_minus == 1)) | ((n_plus == 0) & (n_minus == 0))
    )
    if not bool(valid.all()):
        bad = torch.nonzero(~valid).flatten()[:5].tolist()
        raise ValueError(
            f"selector columns {bad} are not one +1 and one -1 (or all zero)"
        )
    pairs = torch.stack([plus.int().argmax(0), minus.int().argmax(0)], dim=1)
    return pairs.to(torch.int32).to(sel_t.device).contiguous()


def selector_pair_distances(coords: torch.Tensor, sel_t: torch.Tensor) -> torch.Tensor:
    """Pair distances (nm) with the TPU kernel's signature.

    coords (F, A, 3) Angstrom; sel_t (A, P) columns of one +1 and one -1 per
    pair, or all zero for padding. Returns (F, P).
    """
    if coords.dim() != 3 or coords.shape[1] != sel_t.shape[0]:
        raise IndexError(
            f"coords {tuple(coords.shape)} do not have the selector's "
            f"{sel_t.shape[0]} atoms"
        )
    return pair_distances(coords, selector_to_pairs(sel_t))
