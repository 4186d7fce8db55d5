"""Synthetic peptide backbones for tests and the card's smoke run.

The part of the JAX package's utils/demo_data.py that builds an all-atom-ish
peptide (N, H, CA, C, O per residue) with a bimodal torsion, copied so the
port imports nothing of that package. The rest of that module (the demo
datasets) is not ported yet.
"""

from __future__ import annotations

import numpy as np

AA_CYCLE = ["ALA", "GLY", "SER", "VAL", "LEU", "THR", "PRO", "PHE"]


def _rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def backbone_coords(
    n_residues: int = 6,
    n_frames: int = 120,
    seed: int = 13,
    with_polar_atoms: bool = True,
    temperature_scale: float = 1.0,
):
    """All-atom-ish peptide backbone (N[,H], CA, C[,O] per residue) whose
    second half rotates about a mid-chain CA-C bond between two metastable
    torsion states. Returns (coords (F,N,3), names, resnames, resids)."""
    rng = np.random.default_rng(seed)

    names, resnames, resids, base = [], [], [], []
    x = 0.0
    for r in range(1, n_residues + 1):
        zig = 0.55 * ((r % 2) * 2 - 1)
        x += 1.33
        n_pos = np.array([x, zig, 0.08 * r])
        entries = [("N", n_pos)]
        if with_polar_atoms:
            entries.append(("H", n_pos + np.array([-0.35, -0.93, 0.0])))
        x += 1.46
        ca_pos = np.array([x, -zig, 0.12 * r])
        entries.append(("CA", ca_pos))
        x += 1.52
        c_pos = np.array([x, zig * 0.4, 0.05 * r])
        entries.append(("C", c_pos))
        if with_polar_atoms:
            entries.append(("O", c_pos + np.array([0.15, 1.22, 0.0])))
        for name, pos in entries:
            names.append(name)
            resnames.append(AA_CYCLE[(r - 1) % len(AA_CYCLE)])
            resids.append(r)
            base.append(pos)
    base = np.asarray(base, np.float64)
    resids_arr = np.asarray(resids)

    mid = n_residues // 2
    ca_idx = next(
        i for i in range(len(names)) if resids_arr[i] == mid and names[i] == "CA"
    )
    c_idx = next(
        i for i in range(len(names)) if resids_arr[i] == mid and names[i] == "C"
    )
    axis = base[c_idx] - base[ca_idx]
    downstream = np.array(
        [i for i in range(len(names)) if resids_arr[i] > mid], dtype=int
    )

    state = (np.arange(n_frames) >= n_frames // 2).astype(float)
    frames = []
    for f in range(n_frames):
        theta = np.deg2rad(-55.0 + 110.0 * state[f]) + 0.15 * np.sin(
            2 * np.pi * f / 23.0
        )
        R = _rodrigues(axis, theta)
        crd = base.copy()
        crd[downstream] = (crd[downstream] - base[ca_idx]) @ R.T + base[ca_idx]
        crd += 0.04 * temperature_scale * rng.standard_normal(crd.shape)
        frames.append(crd)
    return np.asarray(frames, np.float32), names, resnames, resids


def write_backbone_pdb(path, coords_frame, names, resnames, resids) -> None:
    with open(path, "w") as fh:
        for i, nm in enumerate(names):
            fh.write(
                f"ATOM  {i + 1:>5}  {nm:<3} {resnames[i]:<4}A{resids[i]:>4}    "
                f"{coords_frame[i, 0]:8.3f}{coords_frame[i, 1]:8.3f}"
                f"{coords_frame[i, 2]:8.3f}{1.0:6.2f}{0.0:6.2f}           {nm[0]}\n"
            )
        fh.write("END\n")
