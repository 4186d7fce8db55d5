"""MDAnalysis-style compatibility surface.

Users of the reference import these names from `deep_cartograph.modules.md`
(deep_cartograph/modules/md/md.py); this module maps every public helper onto
the port's implementations so existing scripts keep working after
switching frameworks. The port of the JAX package's md.py: the same names
and signatures; RMSD, RMSF and dRMSD also take the port's `device`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from deep_cartograph_torch.features.discovery import (
    find_coordinates as _find_coordinates,
    find_dihedrals as _find_dihedrals,
    find_distances as _find_distances,
    get_coordinate_labels as _get_coordinate_labels,
    get_dihedral_labels as _get_dihedral_labels,
    get_distance_labels as _get_distance_labels,
    get_features_list,
)
from deep_cartograph_torch.features.grammar import to_entity_name, to_mda_selection
from deep_cartograph_torch.geom.analysis import RMSD, RMSF, dRMSD
from deep_cartograph_torch.geom.interpolate import interpolate_trajectory
from deep_cartograph_torch.geom.structure import (
    create_plumed_rmsd_template,
    create_rmsd_waypoint_reference,
    map_sensitivity_to_structure,
)
from deep_cartograph_torch.io.topology import Topology, create_pdb
from deep_cartograph_torch.io.traj import (
    SUPPORTED_TOP_FORMATS,
    SUPPORTED_TRAJ_FORMATS,
    extract_frames_to_pdb,
    extract_frames_to_traj,
    get_num_frames,
    read_traj,
)

__all__ = [
    "RMSD", "RMSF", "dRMSD", "atom_entity_to_index", "create_pdb",
    "create_plumed_rmsd_template", "create_rmsd_waypoint_reference",
    "extract_PDB", "extract_XTC", "find_coordinates", "find_dihedrals",
    "find_distances", "find_supported_top", "find_supported_traj",
    "get_coordinate_labels", "get_dihedral_labels", "get_distance_labels",
    "find_virtual_dihedral", "find_protein_back_dihedrals",
    "find_all_real_dihedrals",
    "get_features_list", "get_indices", "get_num_frames", "get_number_atoms",
    "interpolate_trajectory", "load_coordinates", "load_universe",
    "map_sensitivity_to_structure", "to_entity_name", "to_mda_selection",
]


def _top(topology_path: str) -> Topology:
    return Topology.from_file(topology_path)


# -- discovery wrappers taking paths (reference signatures) -----------------

def find_distances(topology_path, selection1, selection2, stride1, stride2,
                   skip_neighbors, skip_bonded_atoms):
    return _find_distances(
        _top(topology_path), selection1, selection2, stride1, stride2,
        skip_neighbors, skip_bonded_atoms,
    )


def find_dihedrals(topology_path, selection, search_mode):
    return _find_dihedrals(_top(topology_path), selection, search_mode)


def find_coordinates(topology_path, selection, stride):
    return _find_coordinates(_top(topology_path), selection, stride)


def get_distance_labels(topology_path, definition):
    return _get_distance_labels(_top(topology_path), definition)


def get_dihedral_labels(topology_path, definition):
    return _get_dihedral_labels(_top(topology_path), definition)


def get_coordinate_labels(topology_path, definition):
    return _get_coordinate_labels(_top(topology_path), definition)


# -- atom/selection helpers (cf. reference md.py:826-890, 1576-1606) --------

def get_number_atoms(topology: str, selection: Optional[str] = None) -> int:
    return len(_top(topology).select(selection))


def get_indices(topology: str, selection: Optional[str] = None) -> List[int]:
    """1-based indices, PLUMED convention."""
    return _top(topology).indices_one_based(selection)


def atom_entity_to_index(atom_entity: str, topology_path: str) -> int:
    name = atom_entity.split("_")[0][1:]
    resid = int(atom_entity.split("_")[1])
    return _top(topology_path).atom_index(name, resid)


# -- trajectory helpers -----------------------------------------------------

def load_coordinates(
    topology_file: str,
    trajectory_file: str,
    selection: str = "all",
    prepare_trajectory: bool = False,
    start: Optional[int] = None,
    stop: Optional[int] = None,
    step: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(frame_array, coords_array) like the reference md.py:892-946.

    With prepare_trajectory=True, molecules are unwrapped across periodic
    boundaries (bond spanning forest) and every frame is re-centred on the
    selection — the reference's MDAnalysis unwrap + center_in_box transform
    stack (md.py:948-1016)."""
    top = _top(topology_file)
    sel = top.select(selection)
    if prepare_trajectory:
        from deep_cartograph_torch.geom.pbc import prepare_frames
        from deep_cartograph_torch.io.boxes import read_box

        coords = read_traj(
            trajectory_file, topology_file,
            start=start or 0, stop=stop, stride=step or 1,
        )
        box = read_box(trajectory_file)
        if box is not None:
            box = box[start or 0 : stop : step or 1]
        bonds = top.guess_bonds(box=box[0] if box is not None else None)
        coords = prepare_frames(coords, box, bonds, group=sel)
        coords = coords[:, np.asarray(sel), :]
    else:
        coords = read_traj(
            trajectory_file, topology_file,
            start=start or 0, stop=stop, stride=step or 1,
            selection_indices=sel,
        )
    frames = np.arange(coords.shape[0], dtype=np.float32)
    return frames, coords


def extract_PDB(trajectory_path, topology_path, pdb_frame, pdb_path):
    extract_frames_to_pdb(trajectory_path, topology_path, pdb_frame, pdb_path)


def extract_XTC(trajectory_path, topology_path, traj_frames, new_traj_path):
    extract_frames_to_traj(
        trajectory_path, topology_path, list(traj_frames), new_traj_path
    )


def find_supported_traj(parent_path, filename=None) -> List[str]:
    if filename is None:
        filename = "*"
    files = glob.glob(os.path.join(parent_path, filename))
    supported = [f for f in files if Path(f).suffix in SUPPORTED_TRAJ_FORMATS]
    supported.sort()
    return supported


def find_supported_top(parent_path, filename=None) -> List[str]:
    if filename is None:
        filename = "*"
    files = glob.glob(os.path.join(parent_path, filename))
    supported = [f for f in files if Path(f).suffix in SUPPORTED_TOP_FORMATS]
    supported.sort()
    return supported


# -- remaining reference md.py names (path-taking wrappers + Universe shim) --

def find_virtual_dihedral(topology_path: str, selection: str) -> List[str]:
    from deep_cartograph_torch.features.discovery import find_virtual_dihedrals

    return find_virtual_dihedrals(_top(topology_path), selection)


def find_protein_back_dihedrals(topology_path: str, selection: str) -> List[str]:
    from deep_cartograph_torch.features.discovery import (
        find_protein_backbone_dihedrals,
    )

    return find_protein_backbone_dihedrals(_top(topology_path), selection)


def find_all_real_dihedrals(topology_path: str, selection: str) -> List[str]:
    from deep_cartograph_torch.features.discovery import find_real_dihedrals

    return find_real_dihedrals(_top(topology_path), selection)


class _AtomGroup:
    def __init__(self, topology: Topology, indices: np.ndarray):
        self.topology = topology
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)


class _TrajectoryView:
    def __init__(self, coords: np.ndarray):
        self.coords = coords
        self.n_frames = coords.shape[0]


class Universe:
    """Minimal stand-in for the MDAnalysis Universe the reference's
    load_universe returns (md.py:948-1016): topology + (optionally
    PBC-prepared) coordinates with a select_atoms surface. Scripts using the
    Universe for selections and frame access keep working; full MDAnalysis
    semantics are out of scope."""

    def __init__(self, topology: Topology, coords: np.ndarray):
        self.topology = topology
        self.trajectory = _TrajectoryView(coords)

    def select_atoms(self, selection: str) -> _AtomGroup:
        return _AtomGroup(self.topology, self.topology.select(selection))

    @property
    def dimensions(self):
        return None


def load_universe(
    topology_file: str,
    trajectory_file: str,
    selection: str = "all",
    prepare_trajectory: bool = False,
) -> Universe:
    """Functional equivalent of the reference's load_universe
    (md.py:948-1016): loads ALL atoms, with PBC unwrap/centering driven by
    the USER'S selection group when prepare_trajectory (the reference
    applies trans.unwrap/center_in_box on the selected group, md.py:993-
    1011 — centering on the whole solvated system instead would diverge)."""
    top = _top(topology_file)
    sel = top.select(selection)
    if len(sel) == 0:
        raise ValueError(f"Selection '{selection}' matched 0 atoms.")
    if prepare_trajectory:
        from deep_cartograph_torch.geom.pbc import prepare_frames
        from deep_cartograph_torch.io.boxes import read_box

        coords = read_traj(trajectory_file, topology_file)
        box = read_box(trajectory_file)
        bonds = top.guess_bonds(box=box[0] if box is not None else None)
        coords = prepare_frames(coords, box, bonds, group=sel)
    else:
        coords = read_traj(trajectory_file, topology_file)
    return Universe(top, coords)
