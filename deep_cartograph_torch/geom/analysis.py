"""Trajectory geometry analyses on the device: RMSD, RMSF, dRMSD.

The port of the JAX package's geom/analysis.py, which replaces the
reference's MDAnalysis analysis stack (deep_cartograph/modules/md/md.py:
1397-1574): the per-frame Kabsch fits run batched on the device, and dRMSD
takes its distances through the featurizer (kernel K1). Every entry point
runs on `device` (None means CUDA and raises without a card); nothing is
routed to the host because it is small.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.features.mapper import PDBTopologyMapper
from deep_cartograph_torch.geom.kernels import kabsch_rotation
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import read_traj
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def _require_atoms(idx, selection: str, context: str):
    """Empty selections poison everything downstream with NaN (mean over a
    zero-length axis); fail like the reference does (md.py:983 logs
    'Selection matched 0 atoms' and exits)."""
    if len(idx) == 0:
        raise ValueError(
            f"Selection '{selection}' matched 0 atoms ({context})."
        )
    return idx


def _mapped_resid_selection(selection: str, resids: List[int]) -> str:
    resid_str = " ".join(str(r) for r in resids)
    return f"({selection}) and (resid {resid_str})"


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), device=device).long()


def _apply(x: torch.Tensor, transform) -> torch.Tensor:
    """A per-frame Kabsch transform (R, mobile centroid, reference
    centroid) applied to frames of any atoms."""
    R, mc, rc = transform
    return (x - mc) @ R.transpose(-1, -2) + rc


def RMSD(
    trajectory_path: str,
    topology_path: str,
    selection: str,
    fitting_selection: str,
    reference_path: Optional[str] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-frame optimal-fit RMSD (Angstroms) vs a reference structure
    (first frame of the topology if no reference given), with cross-topology
    residue mapping (cf. reference md.py:1397-1454). The fit selection sets
    the transform; the RMSD is measured over the analysis selection."""
    dev = resolve_device(device)
    topology = Topology.from_file(topology_path)
    ref_structure = reference_path if reference_path else topology_path
    ref_topology = Topology.from_file(ref_structure)

    mapper = PDBTopologyMapper(ref_structure, topology_path)
    pairs = [(ref_id, val[2]) for ref_id, val in mapper.mapping.items()]
    if not pairs:
        logger.error(
            "No common residues found between %s and %s", ref_structure, topology_path
        )
        return np.array([])

    ref_resids = [p[0] for p in pairs]
    sim_resids = [p[1] for p in pairs]
    fit_ref = _require_atoms(
        ref_topology.select(_mapped_resid_selection(fitting_selection, ref_resids)),
        fitting_selection, "RMSD fit (reference)",
    )
    fit_sim = _require_atoms(
        topology.select(_mapped_resid_selection(fitting_selection, sim_resids)),
        fitting_selection, "RMSD fit (trajectory)",
    )
    ana_ref = _require_atoms(
        ref_topology.select(_mapped_resid_selection(selection, ref_resids)),
        selection, "RMSD analysis (reference)",
    )
    ana_sim = _require_atoms(
        topology.select(_mapped_resid_selection(selection, sim_resids)),
        selection, "RMSD analysis (trajectory)",
    )
    if len(ana_ref) != len(ana_sim) or len(fit_ref) != len(fit_sim):
        logger.error(
            "Number of atoms in simulation and reference selections do not match."
        )
        return np.array([])

    coords = read_traj(trajectory_path, topology_path)
    frames = torch.as_tensor(coords, device=dev)
    reference = torch.as_tensor(ref_topology.positions, device=dev)
    # Fit on the fitting selection, measure on the analysis selection
    transform = kabsch_rotation(frames.index_select(1, _index(fit_sim, dev)),
                                reference.index_select(0, _index(fit_ref, dev)))
    aligned_ana = _apply(frames.index_select(1, _index(ana_sim, dev)), transform)
    diff = aligned_ana - reference.index_select(0, _index(ana_ref, dev))
    return torch.sqrt(torch.mean(torch.sum(diff * diff, -1), dim=-1)).cpu().numpy()


def RMSF(
    trajectory_path: str,
    topology_path: str,
    selection: str,
    fitting_selection: str,
    device: DeviceLike = None,
) -> Tuple[List[float], List[int]]:
    """Per-residue RMSF after aligning to the average structure
    (cf. reference md.py:1456-1497): frames are aligned to frame 0, averaged,
    re-aligned to the average, then per-atom fluctuations are averaged per
    residue."""
    dev = resolve_device(device)
    topology = Topology.from_file(topology_path)
    coords = read_traj(trajectory_path, topology_path)
    fit_idx = _require_atoms(
        topology.select(fitting_selection), fitting_selection, "RMSF fit"
    )
    rmsf_idx = _require_atoms(
        topology.select(selection), selection, "RMSF analysis"
    )

    frames = torch.as_tensor(coords, device=dev)
    fit = _index(fit_idx, dev)
    mobile_fit = frames.index_select(1, fit)
    # Step 1: average structure from frames aligned to frame 0 on fit atoms
    transform = kabsch_rotation(mobile_fit, mobile_fit[0])
    average = torch.mean(_apply(frames, transform), dim=0)
    # Step 2: all frames aligned to the average
    aligned = _apply(frames, kabsch_rotation(mobile_fit, average.index_select(0, fit)))
    # Per-atom RMSF over the analysis selection
    sel = aligned.index_select(1, _index(rmsf_idx, dev))
    mean_pos = torch.mean(sel, dim=0)
    rmsf_atoms = torch.sqrt(
        torch.mean(torch.sum((sel - mean_pos) ** 2, -1), dim=0)).cpu().numpy()

    resids = topology.resids[rmsf_idx]
    residues = sorted(set(int(r) for r in resids))
    rmsf_per_residue = [
        float(np.mean(rmsf_atoms[resids == r])) for r in residues
    ]
    return rmsf_per_residue, residues


def dRMSD(
    trajectory_path: str,
    topology_path: str,
    selection: str,
    selection_stride: int,
    reference_path: str,
    output_path: Optional[str] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-frame distance-matrix RMSD vs a reference structure
    (cf. reference md.py:1499-1574, which shells out to compute_features;
    here the reference's and the trajectory's pair distances run through
    the featurizer, kernel K1)."""
    from deep_cartograph_torch.features.discovery import get_distance_labels
    from deep_cartograph_torch.features.translator import Translator
    from deep_cartograph_torch.geom.engine import Featurizer

    dev = resolve_device(device)
    group = {
        "first_selection": selection,
        "second_selection": selection,
        "first_stride": selection_stride,
        "second_stride": selection_stride,
        "skip_neigh_residues": True,
        "skip_bonded_atoms": True,
    }
    ref_topology = Topology.from_file(reference_path)
    labels = get_distance_labels(ref_topology, group)
    if not labels:
        raise ValueError("No pairwise distances found for dRMSD selection.")

    # Reference distances (single frame)
    ref_featurizer = Featurizer(ref_topology, labels, device=dev)
    ref_distances = ref_featurizer(ref_topology.positions[None])[0]

    # Trajectory distances (translated features)
    traj_labels = Translator(reference_path, topology_path, labels).run()
    keep = [i for i, t in enumerate(traj_labels) if t is not None]
    if len(keep) < len(labels):
        logger.warning(
            "%d dRMSD distances could not be translated and were dropped.",
            len(labels) - len(keep),
        )
    topology = Topology.from_file(topology_path)
    featurizer = Featurizer(topology, [traj_labels[i] for i in keep], device=dev)
    coords = read_traj(trajectory_path, topology_path)
    traj_distances = featurizer(coords)

    diff = traj_distances - ref_distances[keep]
    return np.asarray(np.sqrt(np.mean(diff**2, axis=1)))
