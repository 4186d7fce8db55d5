"""Hydrogen-bond analysis on the device: batched donor-H-acceptor geometry.

The port of the JAX package's geom/hbonds.py, the replacement for the
MDAnalysis HydrogenBondAnalysis workflow of the reference's extra notebook
(examples/notebooks/extra/h_bond_analysis.ipynb): every frame and every
(donor, hydrogen, acceptor) triplet is evaluated in a few batched tensor
ops (gathers, a distance, an angle, two compares). The criteria match
MDAnalysis defaults: donor-acceptor distance <= d_a_cutoff (Angstrom) AND
donor-hydrogen-acceptor angle >= d_h_a_angle_cutoff (degrees).

Where the JAX package returns a DataFrame, the port returns a dict of numpy
columns with the same names, in the same row order; the barcode plot
(`plot_multibond_barcode`) takes such dicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

DEFAULT_DH_CUTOFF = 1.25  # Angstrom: covalent D-H pairing distance

EVENT_COLUMNS = ("frame", "donor_index", "hydrogen_index", "acceptor_index",
                 "distance", "angle")

# Soft budget for one frame chunk's (frames, triplets, 3) intermediates.
_MASK_BYTE_BUDGET = 1 << 30
_MASK_BYTES_PER_TRIPLET = 4 * 24


def _hbond_mask(
    coords: torch.Tensor,  # (F, N, 3)
    donors: torch.Tensor,  # (T,) atom indices
    hydrogens: torch.Tensor,  # (T,)
    acceptors: torch.Tensor,  # (T,)
    d_a_cutoff: float,
    angle_cutoff_deg: float,
) -> torch.Tensor:
    """(F, T) bool: triplet t forms an H-bond in frame f."""
    d = coords[:, donors]  # (F, T, 3)
    h = coords[:, hydrogens]
    a = coords[:, acceptors]
    da = torch.linalg.vector_norm(a - d, dim=-1)  # (F, T)
    v1 = d - h
    v2 = a - h
    cos = torch.sum(v1 * v2, dim=-1) / (
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
        + 1e-12
    )
    angle = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    return (da <= d_a_cutoff) & (angle >= angle_cutoff_deg)


def hbond_mask(
    coords: np.ndarray,
    donors: np.ndarray,
    hydrogens: np.ndarray,
    acceptors: np.ndarray,
    d_a_cutoff: float,
    angle_cutoff_deg: float,
    device: DeviceLike = None,
) -> np.ndarray:
    """(F, T) bool mask of H-bond events on the device: the frames go up
    once and are evaluated in chunks that keep the intermediates within
    `_MASK_BYTE_BUDGET` (each frame's value depends on that frame alone)."""
    dev = resolve_device(device)
    frames = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    idx = [torch.as_tensor(np.ascontiguousarray(i), device=dev).long()
           for i in (donors, hydrogens, acceptors)]
    n_frames, n_triplets = frames.shape[0], len(donors)
    chunk = max(1, _MASK_BYTE_BUDGET // max(1, n_triplets * _MASK_BYTES_PER_TRIPLET))
    parts = [
        _hbond_mask(frames[s:s + chunk], *idx, float(d_a_cutoff), float(angle_cutoff_deg))
        for s in range(0, n_frames, chunk)
    ]
    if not parts:
        return np.zeros((0, n_triplets), bool)
    return torch.cat(parts).cpu().numpy()


def pair_donor_hydrogens(
    coords_frame: np.ndarray,
    donor_indices: np.ndarray,
    hydrogen_indices: np.ndarray,
    dh_cutoff: float = DEFAULT_DH_CUTOFF,
) -> List[Tuple[int, int]]:
    """Covalently pair each hydrogen with its donor heavy atom (within
    dh_cutoff Angstrom in the given frame), like MDAnalysis' donor-hydrogen
    bonding inference."""
    pairs: List[Tuple[int, int]] = []
    if len(donor_indices) == 0:
        return pairs
    for hyd in hydrogen_indices:
        dists = np.linalg.norm(
            coords_frame[donor_indices] - coords_frame[hyd], axis=-1
        )
        j = int(np.argmin(dists))
        if dists[j] <= dh_cutoff:
            pairs.append((int(donor_indices[j]), int(hyd)))
    return pairs


def hbond_triplets(
    topology,
    coords_frame: np.ndarray,
    donors_sel: str,
    hydrogens_sel: str,
    acceptors_sel: str,
    first_selection: Optional[str] = None,
    second_selection: Optional[str] = None,
    dh_cutoff: float = DEFAULT_DH_CUTOFF,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Enumerate candidate (donor, hydrogen, acceptor) triplets.

    donors/hydrogens are restricted to `first_selection` and acceptors to
    `second_selection` when given (the notebook's residue-pair scoping).
    """
    from deep_cartograph_torch.io.selection import evaluate_selection

    def idx(sel: str, scope: Optional[str]) -> np.ndarray:
        mask = evaluate_selection(sel, topology)
        if scope:
            mask = mask & evaluate_selection(scope, topology)
        return np.nonzero(mask)[0]

    donor_idx = idx(donors_sel, first_selection)
    hyd_idx = idx(hydrogens_sel, first_selection)
    acc_idx = idx(acceptors_sel, second_selection)
    dh_pairs = pair_donor_hydrogens(coords_frame, donor_idx, hyd_idx, dh_cutoff)

    donors, hydrogens, acceptors = [], [], []
    for don, hyd in dh_pairs:
        for acc in acc_idx:
            if int(acc) == don:
                continue
            donors.append(don)
            hydrogens.append(hyd)
            acceptors.append(int(acc))
    return (
        np.asarray(donors, np.int32),
        np.asarray(hydrogens, np.int32),
        np.asarray(acceptors, np.int32),
    )


def _events(coords: np.ndarray, mask: np.ndarray, donors: np.ndarray,
            hydrogens: np.ndarray, acceptors: np.ndarray) -> Dict[str, np.ndarray]:
    """One row per (frame, triplet) event of the mask, with its distance
    and angle in float32 on the host, as the JAX package computes them."""
    frames_i, trip_i = np.nonzero(mask)
    d = coords[frames_i, donors[trip_i]]
    h = coords[frames_i, hydrogens[trip_i]]
    a = coords[frames_i, acceptors[trip_i]]
    dist = np.linalg.norm(a - d, axis=-1)
    v1, v2 = d - h, a - h
    cos = np.sum(v1 * v2, axis=-1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-12
    )
    angle = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    return dict(zip(EVENT_COLUMNS, (frames_i, donors[trip_i], hydrogens[trip_i],
                                    acceptors[trip_i], dist, angle)))


def analyze_residue_hbonds(
    topology_file: str,
    trajectory_file: str,
    first_selection: str,
    second_selection: str,
    d_a_cutoff: float = 3.0,
    d_h_a_angle_cutoff: float = 150.0,
    donors_sel: Optional[str] = None,
    hydrogens_sel: Optional[str] = None,
    acceptors_sel: Optional[str] = None,
    remove_pbc: bool = False,
    device: DeviceLike = None,
) -> Tuple[Dict[str, np.ndarray], int]:
    """H-bonds between two selections along a trajectory.

    The reference notebook's helper (h_bond_analysis.ipynb
    `analyze_residue_hbonds`): one row per (frame, donor, hydrogen,
    acceptor) H-bond event, as a dict of numpy columns frame / donor_index
    / hydrogen_index / acceptor_index / distance / angle, plus the
    trajectory's frame count. The geometry runs on `device` (None means
    CUDA) for all frames.
    """
    from deep_cartograph_torch.io.topology import parse_pdb
    from deep_cartograph_torch.io.traj import read_traj

    dev = resolve_device(device)
    topology = parse_pdb(topology_file)
    coords = read_traj(trajectory_file, topology_file)  # (F, N, 3) Angstrom
    if remove_pbc:
        # Unwrap molecules across the box and re-center (the notebook's
        # remove_pbc flag; same transform stack as traj preparation).
        from deep_cartograph_torch.geom.pbc import prepare_frames
        from deep_cartograph_torch.io.boxes import read_box

        box = read_box(trajectory_file)
        bonds = topology.guess_bonds(
            box=box[0] if box is not None else None
        )
        coords = prepare_frames(coords, box, bonds)
    n_frames = coords.shape[0]

    donors, hydrogens, acceptors = hbond_triplets(
        topology,
        coords[0],
        donors_sel or "name N* or name O*",
        hydrogens_sel or "name H*",
        acceptors_sel or "name O*",
        first_selection=first_selection,
        second_selection=second_selection,
    )
    mask = hbond_mask(coords, donors, hydrogens, acceptors, d_a_cutoff,
                      d_h_a_angle_cutoff, dev) if donors.size else \
        np.zeros((n_frames, 0), bool)
    return _events(coords, mask, donors, hydrogens, acceptors), n_frames


def hbond_occupancy(events: Dict[str, np.ndarray], n_frames: int) -> float:
    """Fraction of frames with at least one H-bond event."""
    frames = np.asarray(events["frame"])
    if frames.size == 0:
        return 0.0
    return float(len(np.unique(frames))) / float(n_frames)


def plot_multibond_barcode(
    hbond_dict: Dict[str, Dict[str, np.ndarray]],
    total_frames: int,
    dt: float = 1.0,
    title: str = "",
    file_path: Optional[str] = None,
):
    """Barcode plot: one lane per labelled bond (its events as a dict of
    columns), a tick at every frame where the bond exists, and its
    occupancy at the lane's end."""
    from deep_cartograph_torch.figures.plots import pyplot

    plt = pyplot()
    n = len(hbond_dict)
    fig, ax = plt.subplots(figsize=(10, 0.8 * n + 1.2))
    for lane, (label, events) in enumerate(hbond_dict.items()):
        frames = np.unique(np.asarray(events["frame"]))
        for f in frames:
            ax.plot(
                [f * dt, f * dt],
                [lane - 0.35, lane + 0.35],
                color="tab:blue",
                linewidth=0.8,
            )
        occ = hbond_occupancy(events, total_frames) * 100
        ax.text(total_frames * dt * 1.01, lane, f"{occ:.0f}%", va="center")
    ax.set_yticks(range(n))
    ax.set_yticklabels(list(hbond_dict.keys()))
    ax.set_xlim(0, total_frames * dt * 1.08)
    ax.set_xlabel("time")
    ax.set_title(title)
    fig.tight_layout()
    if file_path:
        fig.savefig(file_path, dpi=120)
        plt.close(fig)
        return None
    return fig
