"""Quantized host-to-device coordinate upload (int16 fixed point).

Coordinates tolerate fixed-point transport: GROMACS' XTC stores positions
at 1e-3 nm. Here each block is quantized per axis to int16 around its
midpoint, with a maximum error of span / 2 / 32767 per coordinate (about
1.5e-3 Angstrom for a 100 Angstrom span), and the bytes sent to the card
halve (float32 to int16).

  * `quantize_coords`: on the host, numpy: per-axis offset and scale over
    the block, rounded to int16.
  * `dequantize_coords`: on the device, `q.float() * scale + offset`.
  * `upload_coords`: quantize, copy, dequantize; or a plain float32 copy.
  * `upload_coords_sharded`: quantize the block once, then copy each
    device's contiguous slice of frames of the codes and dequantize it
    there (the sharded branch of the JAX package's `_eval_quantized`).

`Featurizer.featurize_trajectory(upload="int16")` (geom/engine.py) sends
every chunk this way; its default is float32, and it refuses any mode but
the two of `UPLOAD_MODES`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from deep_cartograph_torch.parallel.mesh import Mesh, run_per_device, split
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import annotate

__all__ = [
    "quantize_coords",
    "dequantize_coords",
    "upload_coords",
    "upload_coords_sharded",
    "quantization_step",
]

# int16 symmetric range; one code point spare so the grid is symmetric
# around the offset and rounding can never overflow the dtype.
_QLEVELS = 32767
UPLOAD_MODES = ("int16", "float32")


def quantize_coords(block: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize an (..., 3) coordinate block to int16 fixed point.

    Returns (q, scale, offset) with x ~= q * scale + offset and (3,)
    float32 scale and offset. The largest error is scale / 2 per axis. An
    axis of zero span round-trips exactly.
    """
    x = np.asarray(block, np.float32)
    # Reduce the leading axis repeatedly: each pass stays vectorized over
    # the contiguous trailing axes.
    mn, mx = x, x
    while mn.ndim > 1:
        mn, mx = mn.min(0), mx.max(0)
    offset = ((mn + mx) * 0.5).astype(np.float32)
    span = (mx - mn).astype(np.float32)
    # A zero span keeps a finite scale, and q becomes exactly 0.
    scale = np.maximum(span / (2.0 * _QLEVELS), 1e-30).astype(np.float32)
    y = x - offset
    y *= (1.0 / scale).astype(np.float32)
    np.rint(y, out=y)
    return y.astype(np.int16), scale, offset


def dequantize_coords(q: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor) -> torch.Tensor:
    """The inverse of `quantize_coords`, on q's device: float32 coordinates."""
    return q.float() * scale + offset


def quantization_step(scale: np.ndarray) -> float:
    """The largest per-coordinate absolute error that `scale` implies."""
    return float(np.max(np.asarray(scale)) * 0.5)


def upload_coords(block: np.ndarray, mode: str = "int16",
                  device: DeviceLike = None) -> torch.Tensor:
    """Copy a coordinate block to the device as float32. mode="int16" sends
    2 bytes a coordinate and dequantizes on the device; mode="float32" is a
    plain copy. `device`: None means CUDA (raises without a card)."""
    dev = resolve_device(device)
    if mode == "float32":
        return torch.as_tensor(np.asarray(block, np.float32)).to(dev)
    if mode != "int16":
        raise ValueError(f"unknown upload mode {mode!r} (int16|float32)")
    return upload_coords_sharded(block, Mesh((dev,)))[0]


def upload_coords_sharded(block: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """int16 upload of a coordinate block over a mesh: the block's codes
    (one scale and offset for the whole block, so each frame has the codes
    of an unsharded upload) sliced by frames, each slice copied to its
    device and dequantized to float32 there by its entry's worker
    (`parallel.mesh.run_per_device`). Returns the slices in mesh order."""
    q, scale, offset = quantize_coords(block)
    scale, offset = torch.from_numpy(scale), torch.from_numpy(offset)

    def upload(dev, part):
        with annotate("transfer.h2d"):
            return dequantize_coords(part.to(dev), scale.to(dev), offset.to(dev))

    return run_per_device(upload, mesh, split(q, mesh))

