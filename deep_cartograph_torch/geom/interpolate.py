"""Trajectory interpolation (pchip / akima) for data augmentation.

Parity with the reference md.interpolate_trajectory
(deep_cartograph/modules/md/md.py:1018-1137): same frame-generation rules
(keep_original_frames merge vs evenly spaced offset grid), same seeded
Gaussian noise, same output naming.

Host numpy and scipy, as in the JAX package; the port's copy differs only in
its imports.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Literal, Optional, Tuple

import numpy as np

from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import read_traj, write_traj

logger = logging.getLogger(__name__)


def interpolate_trajectory(
    topology_file: str,
    trajectory_file: str,
    num_frames: int,
    keep_original_frames: bool = True,
    interpolation_method: Optional[Literal["akima", "pchip"]] = "pchip",
    noise_std: Optional[float] = None,
    random_seed: int = 42,
    atom_selection: str = "all",
    traj_format: Literal["xtc", "dcd", "nc", "pdb"] = "xtc",
    prepare_trajectory: bool = False,
    output_path: Optional[str] = None,
    suffix: str = "",
) -> Tuple[str, str]:
    """Interpolate a trajectory to num_frames; returns (traj_path, top_path)."""
    traj_name = Path(trajectory_file).stem
    out_dir = output_path if output_path else "."
    new_traj_path = os.path.join(
        out_dir, f"{traj_name}_augmented_{interpolation_method}{suffix}.{traj_format}"
    )
    new_top_path = os.path.join(
        out_dir, f"{traj_name}_augmented_{interpolation_method}{suffix}.pdb"
    )
    if os.path.exists(new_traj_path) and os.path.exists(new_top_path):
        logger.info(
            "Interpolated trajectory and topology already exist at %s / %s. "
            "Skipping interpolation.",
            new_traj_path,
            new_top_path,
        )
        return new_traj_path, new_top_path

    topology = Topology.from_file(topology_file)
    sel_idx = topology.select(atom_selection)
    if len(sel_idx) == 0:
        raise ValueError(
            f"Selection '{atom_selection}' matched 0 atoms; refusing to "
            "write an empty interpolated trajectory."
        )
    if prepare_trajectory:
        from deep_cartograph_torch.geom.pbc import prepare_frames
        from deep_cartograph_torch.io.boxes import read_box

        raw = read_traj(trajectory_file, topology_file)
        box = read_box(trajectory_file)
        bonds = topology.guess_bonds(box=box[0] if box is not None else None)
        coords = prepare_frames(raw, box, bonds, group=sel_idx)[:, sel_idx]
    else:
        coords = read_traj(trajectory_file, topology_file)[:, sel_idx]
    frames = np.arange(coords.shape[0], dtype=np.float64)

    if keep_original_frames:
        additional = np.linspace(
            frames[0], frames[-1], num_frames - len(frames) + 2
        )[1:-1]
        new_frames = np.sort(np.concatenate((frames, additional)))
    else:
        new_frames = np.linspace(frames[0] + 0.5, frames[-1] + 0.5, num_frames)

    if interpolation_method == "akima":
        from scipy.interpolate import Akima1DInterpolator

        interpolator = Akima1DInterpolator(frames, coords, axis=0, method="makima")
        new_coords = interpolator(new_frames)
    elif interpolation_method == "pchip":
        from scipy.interpolate import PchipInterpolator

        interpolator = PchipInterpolator(frames, coords, axis=0)
        new_coords = interpolator(new_frames)
    elif interpolation_method is None:
        new_coords = coords
    else:
        raise ValueError(
            f"Interpolation method '{interpolation_method}' not supported. "
            "Use 'akima' or 'pchip'."
        )

    if noise_std is not None:
        np.random.seed(random_seed)
        new_coords = new_coords + np.random.normal(0, noise_std, new_coords.shape)

    sub_top = topology.subset(sel_idx)
    sub_top.write_pdb(new_top_path)
    write_traj(new_traj_path, np.asarray(new_coords, np.float32), sub_top)
    return new_traj_path, new_top_path
