"""align_trajectories tool: align the CA atoms of many trajectories onto a
reference, residues matched by sequence alignment.

The port of the JAX package's tools/align_trajectories.py: the per-frame
optimal fits run batched on the tool's device (`geom/kernels.py::
kabsch_rotation`).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from deep_cartograph_torch.features.mapper import PDBTopologyMapper
from deep_cartograph_torch.geom.kernels import kabsch_rotation
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import read_traj, write_traj
from deep_cartograph_torch.utils.common import check_data
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


def find_common_resids(ref_topology: str, topologies: List[str]) -> List[int]:
    """The reference's residue ids that every topology maps by sequence
    alignment."""
    if not topologies:
        return []
    mapper = PDBTopologyMapper(ref_topology, topologies[0])
    common = set(mapper.mapping.keys())
    for top in topologies[1:]:
        mapper = PDBTopologyMapper(ref_topology, top)
        common &= set(mapper.mapping.keys())
    return sorted(common)


def build_ca_selection(resids: List[int]) -> str:
    resid_str = " ".join(str(r) for r in resids)
    return f"backbone and name CA and resid {resid_str}"


@traced("align_trajectories")
def align_trajectories(
    trajectory_data: Optional[Union[List[str], str]] = None,
    topology_data: Optional[Union[List[str], str]] = None,
    ref_topology: Optional[str] = None,
    output_folder: str = "align_trajectories",
    device: DeviceLike = None,
) -> None:
    """Each trajectory fitted frame by frame on its common CA atoms to the
    reference's, written with its first frame as PDB to `output_folder`.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("==================")
    logger.info("Align Trajectories")
    logger.info("==================")
    start_time = time.time()
    dev = resolve_device(device)
    os.makedirs(output_folder, exist_ok=True)

    trajectories, topologies = check_data(trajectory_data, topology_data)
    if not trajectories:
        logger.warning("No trajectories provided. Nothing to align.")
        return
    if ref_topology is None:
        ref_topology = topologies[0]
        logger.info(
            "No reference topology provided. Using first topology as "
            "reference: %s",
            Path(ref_topology).name,
        )

    common_ref_resids = find_common_resids(ref_topology, topologies)
    logger.info(
        "Found %d common residues across all topologies.", len(common_ref_resids)
    )
    if not common_ref_resids:
        logger.error(
            "No common residues found across topologies. Cannot align trajectories."
        )
        return

    ref_top = Topology.from_file(ref_topology)
    ref_sel = ref_top.select(build_ca_selection(common_ref_resids))
    ref_coords = torch.as_tensor(np.asarray(ref_top.positions[ref_sel], np.float32),
                                 device=dev)

    for traj, top in zip(trajectories, topologies):
        logger.info(
            "Aligning trajectory '%s' with topology '%s'...",
            Path(traj).name,
            Path(top).name,
        )
        mapper = PDBTopologyMapper(ref_topology, top)
        target_resids = [
            r for r in (mapper.map_residue(x) for x in common_ref_resids)
            if r is not None
        ]
        if not target_resids:
            logger.error(
                "No mappable residues found for topology '%s'. Skipping.",
                Path(top).name,
            )
            continue

        mobile_top = Topology.from_file(top)
        mobile_sel = mobile_top.select(build_ca_selection(target_resids))
        n = min(len(mobile_sel), len(ref_sel))
        coords = torch.as_tensor(read_traj(traj, top), device=dev)
        R, mc, rc = kabsch_rotation(coords[:, mobile_sel[:n]], ref_coords[:n])
        aligned = ((coords - mc) @ R.transpose(-1, -2) + rc).cpu().numpy()
        aligned = np.asarray(aligned, np.float32)

        output_traj = os.path.join(output_folder, Path(traj).name)
        output_top = os.path.join(output_folder, Path(top).stem + ".pdb")
        write_traj(output_traj, aligned, mobile_top)
        mobile_top.write_pdb(output_top, positions=aligned[0])
        logger.info("Aligned trajectory saved to: %s", output_traj)

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Align trajectories): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
