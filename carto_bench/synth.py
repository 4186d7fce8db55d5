"""Inputs made from a seed: molecules, trajectories, DCD and PDB files,
feature labels and the served model's weights.

The trajectory generator is `chip_smoke.py::make_trajectory` (a helix with
8 slow sine modes and 0.2 Angstrom of thermal jitter per coordinate and
frame; without the jitter deep-TICA's batch eigenvalues sit at 1 and its
tries are rejected), with the helix laid out at a protein's spacing (one
residue per 100 degrees and 1.5 Angstrom of rise, so neighbouring CA atoms
lie 3.8 Angstrom apart) and every backbone atom of a residue moving with
its CA. Its sizes come from the configuration file; it runs on the device
in a few large calls.

Nothing here imports the program: the labels and files are the inputs both
the program and the reference read.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

RESIDUE_NAMES = ("ALA", "GLY", "SER", "VAL", "LEU", "THR", "PRO", "PHE")


@dataclass(frozen=True)
class Molecule:
    """The atoms of a configuration's molecule and its CA feature set."""

    n_residues: int
    atom_names: tuple      # backbone atom names of one residue, in file order

    @classmethod
    def from_config(cls, cfg: dict) -> "Molecule":
        mol = cfg["molecule"]
        return cls(int(mol["residues"]), tuple(mol["atoms_per_residue"]))

    @property
    def n_atoms(self) -> int:
        return self.n_residues * len(self.atom_names)

    @property
    def ca_index(self) -> np.ndarray:
        """0-based atom index of every residue's CA."""
        return (np.arange(self.n_residues) * len(self.atom_names)
                + self.atom_names.index("CA"))

    @property
    def pairs(self) -> np.ndarray:
        """(P, 2) residue indices of every CA pair but chain neighbours."""
        n = self.n_residues
        return np.array([(i, j) for i in range(n) for j in range(i + 2, n)], np.int64)

    @property
    def quads(self) -> np.ndarray:
        """(Q, 4) residue indices of every CA virtual dihedral."""
        i = np.arange(self.n_residues - 3)
        return np.stack([i, i + 1, i + 2, i + 3], 1)

    @property
    def n_features(self) -> int:
        return len(self.pairs) + 2 * len(self.quads)

    def labels(self) -> List[str]:
        """`chip_smoke.py::make_labels`: every non-neighbour CA distance,
        then sin and cos of each CA virtual dihedral (residue numbers)."""
        out = [f"dist-@CA_{i + 1}-@CA_{j + 1}" for i, j in self.pairs]
        for q in self.quads + 1:
            body = "-".join(f"@CA_{k}" for k in q)
            out += [f"sin-{body}", f"cos-{body}"]
        return out


def trajectory(cfg: dict, n_frames: int, seed: int, device) -> torch.Tensor:
    """(n_frames, n_atoms, 3) float32 Angstrom coordinates on `device`."""
    mol = Molecule.from_config(cfg)
    syn = cfg["synthetic"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = {"device": device, "dtype": torch.float64}
    i = torch.arange(mol.n_residues, **kw)
    turn = math.radians(syn["turn_degrees"])
    t = i * turn
    radius, rise = syn["radius"], syn["rise"]
    ca = torch.stack([radius * torch.cos(t), radius * torch.sin(t), rise * i], 1)
    # Each backbone atom sits at a fixed offset from its CA in the helix's
    # local frame (radial, tangential, axial).
    radial = torch.stack([torch.cos(t), torch.sin(t), torch.zeros_like(t)], 1)
    tangential = torch.stack([-torch.sin(t), torch.cos(t), torch.zeros_like(t)], 1)
    axial = torch.zeros_like(radial)
    axial[:, 2] = 1.0
    atoms = []
    for name in mol.atom_names:
        r, tg, ax = syn["offsets"][name]
        atoms.append(ca + r * radial + tg * tangential + ax * axial)
    base = torch.stack(atoms, 1).reshape(1, mol.n_atoms, 3)

    n_modes = int(syn["modes"])
    u = torch.rand(2, n_modes, generator=gen, **kw)
    phases = 2 * math.pi * u[0]
    freqs = 0.5 + 2.5 * u[1]
    shapes = syn["mode_amplitude"] * torch.randn(n_modes, mol.n_residues, 3,
                                                 generator=gen, **kw)
    # a residue's atoms move together, so bond lengths hold
    shapes = shapes.repeat_interleave(len(mol.atom_names), dim=1).reshape(n_modes, -1)
    tt = torch.arange(n_frames, **kw) / n_frames * 2 * math.pi
    waves = torch.sin(freqs[None] * tt[:, None] + phases[None])
    coords = (base.reshape(1, -1) + waves @ shapes).reshape(n_frames, mol.n_atoms, 3)
    coords = coords.float()
    coords += syn["jitter"] * torch.randn(coords.shape, generator=gen, device=device)
    return coords


def write_pdb(path: str, mol: Molecule, frame: np.ndarray) -> None:
    """One frame as a PDB of the molecule's backbone atoms."""
    lines = []
    for a, (x, y, z) in enumerate(frame):
        res = a // len(mol.atom_names)
        name = mol.atom_names[a % len(mol.atom_names)]
        lines.append(
            f"ATOM  {a + 1:>5}  {name:<3} {RESIDUE_NAMES[res % 8]:<4}A{res + 1:>4}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           {name[0]}\n")
    with open(path, "w") as fh:
        fh.write("".join(lines) + "END\n")


def write_dcd(path: str, coords: np.ndarray, block: int = 16384) -> None:
    """(F, A, 3) float32 coordinates as a little-endian CHARMM DCD, written
    in blocks of frames: each frame is three records [4A][x_1..x_A][4A]."""
    n_frames, n_atoms, _ = coords.shape

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    icntrl = [0] * 20
    icntrl[0], icntrl[1], icntrl[2], icntrl[3], icntrl[19] = n_frames, 1, 1, n_frames, 24
    with open(path, "wb") as fh:
        fh.write(rec(b"CORD" + struct.pack("<20i", *icntrl)))
        fh.write(rec(struct.pack("<i", 1) + b"carto_bench synthetic trajectory".ljust(80)))
        fh.write(rec(struct.pack("<i", n_atoms)))
        for start in range(0, n_frames, block):
            part = coords[start:start + block]
            body = np.empty((len(part), 3, n_atoms + 2), "<i4")
            body[:, :, 0] = body[:, :, -1] = 4 * n_atoms
            body[:, :, 1:-1] = np.ascontiguousarray(
                part.transpose(0, 2, 1), dtype="<f4").view("<i4")
            fh.write(body.tobytes())


def dense_weights(layers, seed: int, device) -> dict:
    """Served network weights from the seed, float32 as they are served:
    lecun-normal kernels and small normal biases, named as the program's
    model files name them ("nn/dense_<i>/kernel", "nn/dense_<i>/bias")."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for i, (fan_in, fan_out) in enumerate(zip(layers[:-1], layers[1:])):
        out[f"nn/dense_{i}/kernel"] = (torch.randn(fan_in, fan_out, generator=gen, device=device)
                                       / math.sqrt(fan_in))
        out[f"nn/dense_{i}/bias"] = 0.1 * torch.randn(fan_out, generator=gen, device=device)
    return out


def log_lengths(lo: int, hi: int, count: int, seed: int) -> np.ndarray:
    """`count` call lengths spread log-uniformly over [lo, hi] on a fixed
    grid, in an order drawn from the seed: every seed serves the same
    frames, in another order."""
    grid = np.unique(np.round(np.geomspace(lo, hi, count)).astype(np.int64))
    return np.random.default_rng(seed).permutation(grid)


def scratch_dir(tag: str) -> str:
    """A directory for a run's input files under TMPDIR (the run's own)."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"carto_bench_{tag}_", dir=os.environ.get("TMPDIR"))
