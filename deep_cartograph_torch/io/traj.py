"""Trajectory dispatch layer: read and write every supported format.

The counterpart of the JAX package's io/traj.py. All in-memory coordinates
are float32 Angstroms with shape (n_frames, n_atoms, 3).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SUPPORTED_TRAJ_FORMATS = (".dcd", ".xtc", ".trr", ".pdb", ".xyz", ".gro", ".crd", ".nc")
SUPPORTED_TOP_FORMATS = (".pdb", ".gro")


def read_pdb_frames(path: str) -> np.ndarray:
    """Read all MODELs of a PDB as coordinate frames."""
    frames: List[List[Tuple[float, float, float]]] = []
    current: List[Tuple[float, float, float]] = []
    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                current.append(
                    (float(line[30:38]), float(line[38:46]), float(line[46:54]))
                )
            elif rec.startswith("ENDMDL") or rec.startswith("END "):
                if current:
                    frames.append(current)
                    current = []
    if current:
        frames.append(current)
    if not frames:
        raise ValueError(f"No coordinate frames parsed from PDB: {path}")
    return np.asarray(frames, dtype=np.float32)


def read_traj(
    trajectory_path: str,
    topology_path: Optional[str] = None,
    start: int = 0,
    stop: Optional[int] = None,
    stride: int = 1,
    selection_indices: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Read trajectory coordinates as (n_frames, n_atoms, 3) float32 Angstroms."""
    suffix = Path(trajectory_path).suffix.lower()
    if suffix == ".dcd":
        from deep_cartograph_torch.io.dcd import read_dcd

        coords = read_dcd(trajectory_path, start, stop, stride)
    elif suffix == ".trr":
        from deep_cartograph_torch.io.trr import read_trr

        coords = read_trr(trajectory_path, start, stop, stride)
    elif suffix == ".xtc":
        from deep_cartograph_torch.io.xtc import read_xtc

        coords = read_xtc(trajectory_path, start, stop, stride)
    elif suffix == ".pdb":
        coords = read_pdb_frames(trajectory_path)[start:stop:stride]
    elif suffix == ".xyz":
        from deep_cartograph_torch.io.xyz import read_xyz

        coords = read_xyz(trajectory_path)[start:stop:stride]
    elif suffix == ".gro":
        from deep_cartograph_torch.io.gro import read_gro_frames

        coords = read_gro_frames(trajectory_path)[start:stop:stride]
    elif suffix == ".crd":
        from deep_cartograph_torch.io.crd import read_crd
        from deep_cartograph_torch.io.topology import Topology

        if topology_path is None:
            raise ValueError("Reading .crd trajectories requires a topology")
        n_atoms = Topology.from_file(topology_path).n_atoms
        coords = read_crd(trajectory_path, n_atoms)[start:stop:stride]
    elif suffix == ".nc":
        from deep_cartograph_torch.io.netcdf import read_nc

        coords = read_nc(trajectory_path, start, stop, stride)
    else:
        raise ValueError(f"Unsupported trajectory format: {trajectory_path}")

    if selection_indices is not None:
        coords = coords[:, np.asarray(selection_indices), :]
    return coords


def write_traj(
    path: str,
    coords: np.ndarray,
    topology=None,
    timestep_ps: float = 1.0,
) -> None:
    """Write coordinates (Angstroms) to the format implied by the extension."""
    suffix = Path(path).suffix.lower()
    if suffix == ".dcd":
        from deep_cartograph_torch.io.dcd import write_dcd

        write_dcd(path, coords, timestep_ps)
    elif suffix == ".trr":
        from deep_cartograph_torch.io.trr import write_trr

        write_trr(path, coords, timestep_ps)
    elif suffix == ".xtc":
        from deep_cartograph_torch.io.xtc import write_xtc

        write_xtc(path, coords, timestep_ps)
    elif suffix == ".xyz":
        from deep_cartograph_torch.io.xyz import write_xyz

        names = topology.names if topology is not None else None
        write_xyz(path, coords, names)
    elif suffix == ".pdb":
        if topology is None:
            raise ValueError("Writing PDB trajectories requires a topology")
        _write_pdb_frames(path, coords, topology)
    elif suffix == ".crd":
        from deep_cartograph_torch.io.crd import write_crd

        write_crd(path, coords)
    elif suffix == ".nc":
        from deep_cartograph_torch.io.netcdf import write_nc

        write_nc(path, coords)
    else:
        raise ValueError(f"Unsupported output trajectory format: {path}")


def _write_pdb_frames(path: str, coords: np.ndarray, topology) -> None:
    with open(path, "w") as fh:
        for f in range(coords.shape[0]):
            fh.write(f"MODEL     {f + 1}\n")
            fh.write(_render_pdb_atoms(topology, coords[f]))
            fh.write("ENDMDL\n")
        fh.write("END\n")


def _render_pdb_atoms(top, pos) -> str:
    from deep_cartograph_torch.io.topology import _format_atom_name

    lines = []
    for i in range(top.n_atoms):
        serial = (i + 1) % 100000
        name_field = _format_atom_name(str(top.names[i]), str(top.elements[i]))
        resname = str(top.resnames[i])[:4]
        chain = (str(top.chain_ids[i]) or " ")[:1]
        resid = int(top.resids[i]) % 10000
        x, y, z = pos[i]
        lines.append(
            f"ATOM  {serial:>5} {name_field}{'':1}{resname:<4}{chain}{resid:>4}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}\n"
        )
    return "".join(lines)


def get_num_frames(trajectory_path: str, topology_path: Optional[str] = None) -> int:
    """Frame count without decoding payloads where the format allows."""
    suffix = Path(trajectory_path).suffix.lower()
    if suffix == ".dcd":
        from deep_cartograph_torch.io.dcd import read_dcd_header

        return read_dcd_header(trajectory_path)[1]
    if suffix == ".xtc":
        from deep_cartograph_torch.io.xtc import count_xtc_frames

        return count_xtc_frames(trajectory_path)
    if suffix == ".trr":
        from deep_cartograph_torch.io.trr import count_trr_frames

        return count_trr_frames(trajectory_path)
    return read_traj(trajectory_path, topology_path).shape[0]


def iter_frame_chunks(
    trajectory_path: str,
    chunk: int,
    topology_path: Optional[str] = None,
    stride: int = 1,
) -> Iterator[np.ndarray]:
    """Yield (<=chunk, n_atoms, 3) arrays. DCD (at stride 1) and XTC chunks
    decode on background threads (decode overlaps the caller's device
    work); a DCD at another stride is read slice by slice; other formats are
    loaded once and sliced."""
    suffix = Path(trajectory_path).suffix.lower()
    if suffix == ".dcd" and stride == 1:
        from deep_cartograph_torch.io.dcd import iter_dcd_chunks_prefetch

        yield from iter_dcd_chunks_prefetch(trajectory_path, chunk)
    elif suffix == ".xtc":
        from deep_cartograph_torch.io.xtc import iter_xtc_chunks_prefetch

        yield from iter_xtc_chunks_prefetch(trajectory_path, chunk, stride=stride)
    elif suffix == ".dcd":
        from deep_cartograph_torch.io.dcd import read_dcd, read_dcd_header

        _, n_frames, _, _, _ = read_dcd_header(trajectory_path)
        for start in range(0, n_frames, chunk * stride):
            stop = min(start + chunk * stride, n_frames)
            yield read_dcd(trajectory_path, start, stop, stride)
    else:
        coords = read_traj(trajectory_path, topology_path, stride=stride)
        for start in range(0, coords.shape[0], chunk):
            yield coords[start : start + chunk]


def extract_frames_to_pdb(
    trajectory_path: str, topology_path: str, frame: int, pdb_path: str
) -> None:
    """Extract one frame to PDB without CONECT records."""
    from deep_cartograph_torch.io.topology import Topology

    top = Topology.from_file(topology_path)
    coords = read_traj(trajectory_path, topology_path, start=frame, stop=frame + 1)
    top.write_pdb(pdb_path, positions=coords[0])


def extract_frames_to_traj(
    trajectory_path: str,
    topology_path: str,
    frames: List[int],
    new_traj_path: str,
) -> None:
    """Extract selected frames into a new trajectory, sorted ascending."""
    if len(frames) == 0:
        logger.warning("No frames requested for %s.", new_traj_path)
        return
    frames = sorted(int(f) for f in frames)
    from deep_cartograph_torch.io.topology import Topology

    top = Topology.from_file(topology_path)
    coords = read_traj(trajectory_path, topology_path)
    write_traj(new_traj_path, coords[frames], top)
