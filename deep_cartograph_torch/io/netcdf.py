"""Amber NetCDF trajectory (.nc) read/write via scipy's netcdf_file.

Completes the output-format list of the augmentation tool
(reference yaml_schemas/traj_augmentation.py traj_format options).
AMBER convention: float32 `coordinates` (frame, atom, spatial) in Angstroms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_nc(path: str, start: int = 0, stop: Optional[int] = None,
            stride: int = 1) -> np.ndarray:
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        coords = np.array(nc.variables["coordinates"][:], dtype=np.float32)
    return coords[start:stop:stride]


def write_nc(path: str, coords: np.ndarray, title: str = "deep_cartograph_torch") -> None:
    from scipy.io import netcdf_file

    coords = np.ascontiguousarray(coords, np.float32)
    n_frames, n_atoms, _ = coords.shape
    with netcdf_file(path, "w") as nc:
        nc.Conventions = b"AMBER"
        nc.ConventionVersion = b"1.0"
        nc.title = title.encode()
        nc.program = b"deep_cartograph_torch"
        nc.createDimension("frame", None)
        nc.createDimension("atom", n_atoms)
        nc.createDimension("spatial", 3)
        var = nc.createVariable(
            "coordinates", np.float32, ("frame", "atom", "spatial")
        )
        var[: n_frames] = coords
        var.units = b"angstrom"
