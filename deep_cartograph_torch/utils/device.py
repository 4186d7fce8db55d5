"""Device selection: the CUDA device unless the caller asks for the CPU.

The JAX package routes small work to the host (`utils/device.py::maybe_cpu`,
the Featurizer's "auto" policy). The port has no such fallback: `None`
means CUDA, and a missing card is an error, never a silent CPU run.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the current CUDA device; raises when CUDA is requested
    (explicitly or by default) and no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. deep_cartograph_torch runs on the GPU by "
            "default; pass device='cpu' to run on the host."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device: {dev}")
    return dev
