"""XYZ trajectory reading/writing (plain text, Angstroms)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def read_xyz(path: str) -> np.ndarray:
    frames: List[np.ndarray] = []
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n_atoms = int(line)
        block = lines[i + 2 : i + 2 + n_atoms]
        coords = np.asarray(
            [[float(v) for v in ln.split()[1:4]] for ln in block], dtype=np.float32
        )
        frames.append(coords)
        i += n_atoms + 2
    if not frames:
        raise ValueError(f"No frames parsed from {path}")
    return np.stack(frames)


def write_xyz(path: str, coords: np.ndarray, names: Optional[np.ndarray] = None) -> None:
    coords = np.asarray(coords)
    n_frames, n_atoms, _ = coords.shape
    with open(path, "w") as fh:
        for f in range(n_frames):
            fh.write(f"{n_atoms}\n")
            fh.write(f"frame {f}\n")
            for a in range(n_atoms):
                nm = str(names[a]) if names is not None else "X"
                x, y, z = coords[f, a]
                fh.write(f"{nm} {x:.5f} {y:.5f} {z:.5f}\n")
