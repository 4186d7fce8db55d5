"""Structure-level outputs: the PLUMED RMSD template, the waypoint RMSD
reference and the per-atom sensitivity map.

The port of the JAX package's geom/structure.py (cf. reference
md.py:1235-1395, 1608-1655); the waypoint alignment runs through the
port's Kabsch (`geom/kernels.py::kabsch_align`) on the device.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np
import torch

from deep_cartograph_torch.features.mapper import PDBTopologyMapper
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def create_plumed_rmsd_template(
    topology_path: str,
    output_path: str,
    align_selection: str = "backbone",
    rmsd_selection: str = "backbone",
) -> None:
    """PDB template with occupancy 1 on the alignment atoms and B-factor 1
    on the RMSD atoms (PLUMED's FIT_TO_TEMPLATE / RMSD convention)."""
    top = Topology.from_file(topology_path)
    occ, bf = np.zeros((2, top.n_atoms), np.float32)
    for selection, marks in ((align_selection, occ), (rmsd_selection, bf)):
        indices = top.select(selection)
        if len(indices) == 0:
            raise ValueError(
                f"Selection: '{selection}' for topology {topology_path} is "
                "empty, please review the selection string."
            )
        marks[indices] = 1.0
    top.write_pdb(output_path, occupancies=occ, bfactors=bf)


def create_rmsd_waypoint_reference(
    waypoint_structures: List[str],
    plumed_topology_path: str,
    rmsd_restraint_reference_path: str,
    align_waypoint_structures: bool = True,
    distance_threshold: float = 2.0,
    device: DeviceLike = None,
) -> None:
    """Mark with occupancy and B-factor 1 the CA atoms of the residues that
    stay put across all waypoints: the largest pairwise displacement after
    aligning every waypoint onto the first is at most `distance_threshold`
    (Angstrom). The alignment runs on `device` (None means CUDA)."""
    from deep_cartograph_torch.geom.kernels import kabsch_align

    dev = resolve_device(device)
    mappings = [PDBTopologyMapper(plumed_topology_path, wp).mapping
                for wp in waypoint_structures]
    common = set(mappings[0])
    for mapping in mappings[1:]:
        common &= set(mapping)
    sorted_common = sorted(common)
    if not sorted_common:
        logger.warning("No common residues across waypoints.")

    rows_per_waypoint = []
    for wp, mapping in zip(waypoint_structures, mappings):
        wp_top = Topology.from_file(wp)
        rows = []
        for resid in sorted_common:
            try:
                rows.append(wp_top.atom_index("CA", mapping[resid][2]))
            except ValueError:
                logger.warning("Waypoint %s missing CA atom for residue %s.", wp,
                               mapping[resid][2])
                rows.append(-1)
        rows_per_waypoint.append((wp_top, rows))

    valid = [k for k in range(len(sorted_common))
             if all(rows[k] >= 0 for _, rows in rows_per_waypoint)]
    stacked = np.stack([top.positions[[rows[k] for k in valid]]
                        for top, rows in rows_per_waypoint])  # (waypoints, n, 3)
    if align_waypoint_structures and stacked.shape[0] > 1:
        coords = torch.as_tensor(stacked, device=dev)
        aligned = kabsch_align(coords[1:], coords[0])
        stacked = np.concatenate([stacked[:1], aligned.cpu().numpy()])

    # per residue, the largest displacement between two waypoints
    diffs = stacked[:, None, :, :] - stacked[None, :, :, :]
    max_disp = np.sqrt((diffs ** 2).sum(-1)).max(axis=(0, 1))
    stable_resids = [sorted_common[valid[k]] for k in range(len(valid))
                     if max_disp[k] <= distance_threshold]

    plumed_top = Topology.from_file(plumed_topology_path)
    occ = np.zeros(plumed_top.n_atoms, np.float32)
    bf = np.zeros(plumed_top.n_atoms, np.float32)
    if stable_resids:
        mask = np.isin(plumed_top.resids, stable_resids) & (plumed_top.names == "CA")
        occ[mask] = 1.0
        bf[mask] = 1.0
        logger.info("Reference structure created with %d active atoms.", int(mask.sum()))
    else:
        logger.warning("No stable residues found within the distance threshold!")
    plumed_top.write_pdb(rmsd_restraint_reference_path, occupancies=occ, bfactors=bf)


def map_sensitivity_to_structure(
    per_atom_sensitivities: Dict[int, float],
    topology_path: str,
    output_folder: str,
) -> None:
    """Write the sensitivities, scaled to 0-100, into the B-factors of
    sensitivity_structure.pdb."""
    values = np.asarray(list(per_atom_sensitivities.values()), dtype=float)
    if values.size == 0:
        logger.warning("No sensitivities to map.")
        return
    values = np.clip(values, 0.0, None)
    vmin, vmax = values.min(), values.max()
    scale = (vmax - vmin) if vmax > vmin else 1.0

    top = Topology.from_file(topology_path)
    bf = np.zeros(top.n_atoms, np.float32)
    for atom_index, sens in per_atom_sensitivities.items():
        if 0 <= atom_index < top.n_atoms:
            bf[atom_index] = (max(sens, 0.0) - vmin) / scale * 100.0
    top.write_pdb(os.path.join(output_folder, "sensitivity_structure.pdb"), bfactors=bf)
