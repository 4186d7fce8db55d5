"""Trajectory dispatch layer: chunked reading for the featurization engine.

The counterpart of the JAX package's io/traj.py. All in-memory coordinates
are float32 Angstroms with shape (n_frames, n_atoms, 3).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np


def iter_frame_chunks(
    trajectory_path: str,
    chunk: int,
    topology_path: Optional[str] = None,
    stride: int = 1,
) -> Iterator[np.ndarray]:
    """Yield (<=chunk, n_atoms, 3) arrays of a DCD trajectory, read chunk by
    chunk. `topology_path` is accepted for the JAX package's signature."""
    suffix = Path(trajectory_path).suffix.lower()
    if suffix != ".dcd":
        raise NotImplementedError(
            f"Trajectory format {suffix!r} is not ported yet (ROADMAP, "
            "Queue 1: tools, pipeline, CLI); the port reads DCD."
        )
    from deep_cartograph_torch.io.dcd import read_dcd, read_dcd_header

    _, n_frames, _, _, _ = read_dcd_header(trajectory_path)
    for start in range(0, n_frames, chunk * stride):
        stop = min(start + chunk * stride, n_frames)
        yield read_dcd(trajectory_path, start, stop, stride)
