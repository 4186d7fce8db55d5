"""GRO structure/trajectory reading (GROMACS fixed-column text, nm units)."""

from __future__ import annotations

from typing import List

import numpy as np

_NM_TO_ANGSTROM = 10.0


def parse_gro(path: str):
    """Parse the first frame of a .gro file into a Topology (Angstroms)."""
    from deep_cartograph_torch.io.topology import Topology, _guess_element

    with open(path) as fh:
        lines = fh.readlines()
    n_atoms = int(lines[1])
    names, resids, resnames, xyz = [], [], [], []
    for line in lines[2 : 2 + n_atoms]:
        resids.append(int(line[0:5]))
        resnames.append(line[5:10].strip())
        names.append(line[10:15].strip())
        x = float(line[20:28]) * _NM_TO_ANGSTROM
        y = float(line[28:36]) * _NM_TO_ANGSTROM
        z = float(line[36:44]) * _NM_TO_ANGSTROM
        xyz.append((x, y, z))
    n = len(names)
    return Topology(
        names=np.asarray(names, dtype=object),
        resids=np.asarray(resids, dtype=np.int64),
        resnames=np.asarray(resnames, dtype=object),
        chain_ids=np.asarray([""] * n, dtype=object),
        segids=np.asarray([""] * n, dtype=object),
        elements=np.asarray(
            [_guess_element(nm, rn) for nm, rn in zip(names, resnames)],
            dtype=object,
        ),
        positions=np.asarray(xyz, dtype=np.float32),
        occupancies=np.ones(n, dtype=np.float32),
        bfactors=np.zeros(n, dtype=np.float32),
        record_types=np.asarray(["ATOM"] * n, dtype=object),
        source_path=path,
    )


def read_gro_frames(path: str) -> np.ndarray:
    """Read all frames of a multi-frame .gro as (n_frames, n_atoms, 3) Angstroms."""
    frames: List[np.ndarray] = []
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines) - 1:
        try:
            n_atoms = int(lines[i + 1])
        except ValueError:
            break
        coords = np.empty((n_atoms, 3), dtype=np.float32)
        for k in range(n_atoms):
            line = lines[i + 2 + k]
            coords[k] = (
                float(line[20:28]),
                float(line[28:36]),
                float(line[36:44]),
            )
        frames.append(coords * _NM_TO_ANGSTROM)
        i += n_atoms + 3  # title + natoms + atoms + box
    if not frames:
        raise ValueError(f"No frames parsed from {path}")
    return np.stack(frames)
