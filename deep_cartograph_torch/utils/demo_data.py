"""Generator-backed demo datasets and the synthetic systems behind them.

The reference ships bundled binary datasets under `deep_cartograph/data/`
(alanine_dipeptide, calpha_transitions, muller_brown, peptide_ensemble,
protein_1BM8). These are generated on demand instead, with the same
directory layout and file names (`materialize`). The physics is synthetic
but structured (two-state CA chains, bimodal-torsion peptides, a
Müller-Brown Langevin walk), so every downstream stage has signal to find.
Trajectories are written through the port's `io/dcd.py` and `io/xtc.py`.
Host-only: nothing here takes a device.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

AA_CYCLE = ["ALA", "GLY", "SER", "VAL", "LEU", "THR", "PRO", "PHE"]

DATASETS = (
    "alanine_dipeptide",
    "calpha_transitions",
    "muller_brown",
    "peptide_ensemble",
    "protein_1BM8",
)


# ---------------------------------------------------------------------------
# Synthetic systems (shared with tests/fixtures.py)
# ---------------------------------------------------------------------------
def ca_coords(n_residues: int, n_frames: int, seed: int = 7) -> np.ndarray:
    """A wobbling helix-ish CA chain: smooth frame-to-frame motion with two
    metastable-looking basins (switch at the trajectory midpoint)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, n_residues)
    base = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * t], axis=1)

    phases = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    state = (np.arange(n_frames) >= n_frames // 2).astype(float)
    frames = []
    for f in range(n_frames):
        bend = 0.8 * state[f] * np.sin(t)[:, None] * np.array([1.0, 0.0, 0.3])
        breathe = 0.35 * np.sin(phases[f] + t)[:, None] * np.array([0.5, 1.0, 0.0])
        noise = 0.05 * rng.standard_normal((n_residues, 3))
        frames.append(base + bend + breathe + noise)
    return np.asarray(frames, dtype=np.float32)


def write_ca_pdb(path: str, coords_frame: np.ndarray) -> None:
    n = coords_frame.shape[0]
    with open(path, "w") as fh:
        for i in range(n):
            resname = AA_CYCLE[i % len(AA_CYCLE)]
            x, y, z = coords_frame[i]
            fh.write(
                f"ATOM  {i + 1:>5}  CA  {resname:<4}A{i + 1:>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           C\n"
            )
        fh.write("END\n")


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


def muller_brown_trajectory(
    n_steps: int = 4000, seed: int = 5, kt: float = 15.0, dt: float = 1e-4
) -> np.ndarray:
    """Overdamped Langevin walk on the Müller-Brown potential (numpy;
    the on-device sampler is data/muller_brown.py)."""
    A = np.array([-200.0, -100.0, -170.0, 15.0])
    a = np.array([-1.0, -1.0, -6.5, 0.7])
    b = np.array([0.0, 0.0, 11.0, 0.6])
    c = np.array([-10.0, -10.0, -6.5, 0.7])
    x0 = np.array([1.0, 0.0, -0.5, -1.0])
    y0 = np.array([0.0, 0.5, 1.5, 1.0])

    rng = np.random.default_rng(seed)
    pos = np.array([-0.55, 1.44])
    out = np.empty((n_steps, 2), np.float64)
    for i in range(n_steps):
        dx = pos[0] - x0
        dy = pos[1] - y0
        e = A * np.exp(a * dx**2 + b * dx * dy + c * dy**2)
        gx = np.sum(e * (2 * a * dx + b * dy))
        gy = np.sum(e * (b * dx + 2 * c * dy))
        pos = pos - dt * np.array([gx, gy]) + np.sqrt(
            2 * kt * dt
        ) * rng.standard_normal(2)
        out[i] = pos
    return out.astype(np.float32)


def _np_dihedral(coords: np.ndarray, quad) -> np.ndarray:
    """Dihedral over frames for one atom quadruplet (praxeolitic, IUPAC)."""
    p0, p1, p2, p3 = (coords[:, i] for i in quad)
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    b1 = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    v = b0 - np.sum(b0 * b1, -1, keepdims=True) * b1
    w = b2 - np.sum(b2 * b1, -1, keepdims=True) * b1
    x = np.sum(v * w, -1)
    y = np.sum(np.cross(b1, v) * w, -1)
    return np.arctan2(y, x)


# ---------------------------------------------------------------------------
# Dataset materialization (reference data/ layout)
# ---------------------------------------------------------------------------
_FEATURE_CONFIGS = {
    "distances_config.yml": """compute_features:
  plumed_settings:
    traj_stride: 1
    features:
      distance_groups:
        dist:
          first_selection: "all"
          second_selection: "all"
          first_stride: 2
          second_stride: 3
          skip_neigh_residues: False
          skip_bonded_atoms: True

filter_features:
  filter_settings:
    compute_diptest: True
    compute_entropy: False
    compute_std: False
    diptest_significance_level: 0.05

train_colvars:
  cvs: ['pca', 'tica', 'deep_tica', 'ae', 'vae']
  common:
    dimension: 2
    lag_time: 5
    features_normalization: 'mean_std'
    architecture:
      encoder:
        layers: [8, 4]
        activation: ['leaky_relu', 'leaky_relu']
        batchnorm: [False, False]
        dropout: [null, null]
      decoder:
        layers: [4, 8]
        activation: ['leaky_relu', 'leaky_relu']
        batchnorm: [False, False]
        dropout: [null, null]
    training:
      general:
        num_tries: 1
        seed: 42
        batch_size: 64
        max_epochs: 100
      optimizer:
        name: Adam
        kwargs:
          lr: 1.0e-03

traj_cluster:
  run: False
""",
    "torsions_config.yml": """compute_features:
  plumed_settings:
    traj_stride: 1
    features:
      dihedral_groups:
        tor:
          selection: "name CA"
          periodic_encoding: True
          search_mode: virtual

filter_features:
  filter_settings:
    compute_diptest: False
    compute_entropy: False
    compute_std: True
    std_quantile: 0.2

train_colvars:
  cvs: ['pca', 'tica', 'deep_tica', 'ae', 'vae']
  common:
    dimension: 2
    lag_time: 5
    features_normalization: 'mean_std'
    architecture:
      encoder:
        layers: [8, 4]
    training:
      general:
        num_tries: 1
        seed: 42
        batch_size: 64
        max_epochs: 100

traj_cluster:
  run: False
""",
}

# Validation-workflow configs (reference input/distances_config_validation.yml
# and torsions_config_validation.yml): dip-test-only filtering, deterministic
# single-try training, hierarchical clustering over an optimized cluster count.
_VALIDATION_CONFIGS = {
    "distances_config_validation.yml": """compute_features:
  plumed_settings:
    traj_stride: 1
    features:
      distance_groups:
        dist:
          first_selection: "name CA"
          second_selection: "name CA"
          first_stride: 1
          second_stride: 2
          skip_neigh_residues: True

filter_features:
  filter_settings:
    compute_diptest: True
    compute_entropy: False
    compute_std: False
    diptest_significance_level: 0.05
    entropy_quantile: 0
    std_quantile: 0

train_colvars:
  cvs: ['pca', 'deep_tica', 'tica', 'ae']
  common:
    dimension: 2
    lag_time: 1
    features_normalization: 'mean_std'
    input_colvars:
      start: 0
      stop: null
      stride: 1
    architecture:
      encoder:
        layers: [5, 3]
        dropout: [0.1, 0.1]
    training:
      general:
        num_tries: 1
        seed: 42
        lengths: [0.8, 0.2]
        batch_size: 128
        max_epochs: 200
        shuffle: False
        random_split: True
        check_val_every_n_epoch: 1
        save_check_every_n_epoch: 1
      early_stopping:
        patience: 100
        min_delta: 1.0e-05
      optimizer:
        name: Adam
        kwargs:
          lr: 1.0e-03
          weight_decay: 0
  clustering:
    run: True
    algorithm: hierarchical
    opt_num_clusters: True
    search_interval: [5, 15]
    num_clusters: 3
    linkage: complete
""",
    "torsions_config_validation.yml": """compute_features:
  plumed_settings:
    traj_stride: 1
    features:
      dihedral_groups:
        tor:
          selection: "all"
          periodic_encoding: True
          search_mode: virtual

filter_features:
  filter_settings:
    compute_diptest: True
    compute_entropy: False
    compute_std: False
    diptest_significance_level: 0.05
    entropy_quantile: 0
    std_quantile: 0

train_colvars:
  cvs: ['pca', 'deep_tica', 'tica', 'ae']
  common:
    dimension: 2
    lag_time: 1
    features_normalization: 'mean_std'
    input_colvars:
      start: 0
      stop: null
      stride: 1
    architecture:
      encoder:
        layers: [5, 3]
        dropout: [0.1, 0.1]
    training:
      general:
        num_tries: 1
        seed: 42
        lengths: [0.8, 0.2]
        batch_size: 128
        max_epochs: 200
        shuffle: False
        random_split: True
        check_val_every_n_epoch: 1
        save_check_every_n_epoch: 1
      early_stopping:
        patience: 100
        min_delta: 1.0e-05
      optimizer:
        name: Adam
        kwargs:
          lr: 1.0e-03
          weight_decay: 0
  clustering:
    run: True
    algorithm: hierarchical
    opt_num_clusters: True
    search_interval: [5, 15]
    num_clusters: 3
    linkage: complete
""",
}


def _write_configs(folder: str) -> None:
    for name, text in _FEATURE_CONFIGS.items():
        with open(os.path.join(folder, name), "w") as fh:
            fh.write(text)


# The six GOdMD transition systems of the reference dataset
# (deep_cartograph/data/calpha_transitions/input/ upstream): only
# 6IRS_7DSQ carries the GOdMD_ file prefix there; the others name files
# after the system. Values: (file prefix or None for system name, rng seed,
# n_residues).
CALPHA_SYSTEMS = {
    "1rcs_B-3ssx_R-3": (None, 4, 16),
    "2olu_A-2olv_A-1": (None, 5, 14),
    "3cw2_E-2qmu_A-3": (None, 6, 18),
    "3hif_B-4bhp_A-3": (None, 8, 15),
    "3ts7_B-3ts7_A-1": (None, 9, 17),
    "6IRS_7DSQ": ("GOdMD_6IRS_7DSQ", 3, 16),
}


def _materialize_calpha_transitions(root: str) -> None:
    """CA transition systems mirroring the reference's GOdMD inputs
    (input/<system>/{<system>.dcd,.pdb} + the two *_validation.yml configs
    + experiments/ — same directory listing as the reference dataset)."""
    from deep_cartograph_torch.io.dcd import write_dcd

    inp = os.path.join(root, "input")
    os.makedirs(inp, exist_ok=True)
    _write_configs(inp)
    for cfg in ("distances_config_validation.yml",
                "torsions_config_validation.yml"):
        with open(os.path.join(inp, cfg), "w") as fh:
            fh.write(_VALIDATION_CONFIGS[cfg])
    exp = os.path.join(root, "experiments")
    os.makedirs(exp, exist_ok=True)
    with open(os.path.join(exp, "torsions_config.yml"), "w") as fh:
        fh.write(_FEATURE_CONFIGS["torsions_config.yml"])
    for name, (prefix, seed, n_res) in CALPHA_SYSTEMS.items():
        stem = prefix or name
        folder = os.path.join(inp, name)
        os.makedirs(folder, exist_ok=True)
        coords = ca_coords(n_res, 200, seed=seed)
        write_ca_pdb(os.path.join(folder, f"{stem}.pdb"), coords[0])
        write_dcd(os.path.join(folder, f"{stem}.dcd"), coords)
        ref = os.path.join(root, "reference", name)
        os.makedirs(ref, exist_ok=True)
        write_ca_pdb(os.path.join(ref, f"{name}_reference.pdb"), coords[-1])


def _materialize_peptide_ensemble(root: str) -> None:
    """peptide{1,2,7} backbone systems + active-conformation references."""
    from deep_cartograph_torch.io.xtc import write_xtc

    inp = os.path.join(root, "input")
    os.makedirs(inp, exist_ok=True)
    _write_configs(inp)
    with open(os.path.join(inp, "all_config.yml"), "w") as fh:
        fh.write(_FEATURE_CONFIGS["distances_config.yml"])
    for name, (n_res, seed) in {
        "peptide1": (6, 101),
        "peptide2": (7, 102),
        "peptide7": (5, 107),
    }.items():
        folder = os.path.join(inp, name)
        os.makedirs(folder, exist_ok=True)
        coords, names, resnames, resids = backbone_coords(
            n_residues=n_res, n_frames=160, seed=seed
        )
        write_backbone_pdb(
            os.path.join(folder, f"{name}.pdb"), coords[0], names, resnames,
            resids,
        )
        write_xtc(os.path.join(folder, f"{name}.xtc"), coords)
        active = os.path.join(folder, "active_conformation")
        os.makedirs(active, exist_ok=True)
        write_backbone_pdb(
            os.path.join(active, "active_conformation.pdb"),
            coords[-1], names, resnames, resids,
        )
        write_xtc(
            os.path.join(active, "active_conformation.xtc"),
            coords[int(0.8 * len(coords)):],
        )


def _materialize_alanine_dipeptide(root: str) -> None:
    """aladip-style inputs: topology.pdb + 300K/400K/500K trajectory.xtc
    with phi_psi.dat colvars."""
    from deep_cartograph_torch.io.xtc import write_xtc

    inp = os.path.join(root, "input")
    os.makedirs(inp, exist_ok=True)
    _write_configs(inp)
    for temp, seed in (("300K", 31), ("400K", 41), ("500K", 51)):
        coords, names, resnames, resids = backbone_coords(
            n_residues=3, n_frames=200, seed=seed,
            temperature_scale=1.0 + (seed - 31) / 20.0,
        )
        if temp == "300K":
            write_backbone_pdb(
                os.path.join(inp, "topology.pdb"), coords[0], names,
                resnames, resids,
            )
        folder = os.path.join(inp, temp)
        os.makedirs(folder, exist_ok=True)
        write_xtc(os.path.join(folder, "trajectory.xtc"), coords)
        # phi/psi colvars for the middle residue (PLUMED text format);
        # numpy praxeolitic dihedral — no device work for data generation
        idx = {(r, n): i for i, (r, n) in enumerate(zip(resids, names))}
        phi = _np_dihedral(
            coords,
            [idx[(1, "C")], idx[(2, "N")], idx[(2, "CA")], idx[(2, "C")]],
        )
        psi = _np_dihedral(
            coords,
            [idx[(2, "N")], idx[(2, "CA")], idx[(2, "C")], idx[(3, "N")]],
        )
        with open(os.path.join(folder, "phi_psi.dat"), "w") as fh:
            fh.write("#! FIELDS time phi psi\n")
            for i in range(len(phi)):
                fh.write(f"{float(i):.1f}\t{phi[i]:.6f}\t{psi[i]:.6f}\n")


def _materialize_muller_brown(root: str) -> None:
    """px_py.dat: PLUMED-style 2D positions from a Langevin walk."""
    os.makedirs(root, exist_ok=True)
    traj = muller_brown_trajectory(4000, seed=5)
    with open(os.path.join(root, "px_py.dat"), "w") as fh:
        fh.write("#! FIELDS time p.x p.y\n")
        for i, (x, y) in enumerate(traj):
            fh.write(f"{i * 0.5:.1f}\t{x:.6f}\t{y:.6f}\n")


def _materialize_protein_1bm8(root: str) -> None:
    """Topology-only dataset + a workflow config (reference protein_1BM8)."""
    inp = os.path.join(root, "input")
    os.makedirs(inp, exist_ok=True)
    coords = ca_coords(24, 1, seed=8)
    write_ca_pdb(os.path.join(inp, "topology.pdb"), coords[0])
    with open(os.path.join(root, "config.yml"), "w") as fh:
        fh.write(_FEATURE_CONFIGS["distances_config.yml"])


_MATERIALIZERS = {
    "alanine_dipeptide": _materialize_alanine_dipeptide,
    "calpha_transitions": _materialize_calpha_transitions,
    "muller_brown": _materialize_muller_brown,
    "peptide_ensemble": _materialize_peptide_ensemble,
    "protein_1BM8": _materialize_protein_1bm8,
}


# Bump when a generator's CONTENT/layout changes: stale installs (whose
# .generated marker carries an older tag) regenerate on next materialize().
_DATASET_VERSIONS = {
    "alanine_dipeptide": 1,
    "calpha_transitions": 2,   # v2: six systems + validation configs
    "muller_brown": 1,
    "peptide_ensemble": 1,
    "protein_1BM8": 1,
}


def materialize(root: str, datasets: Optional[List[str]] = None,
                force: bool = False) -> None:
    """Generate the demo datasets under `root` (skips up-to-date ones)."""
    for name in datasets or DATASETS:
        folder = os.path.join(root, name)
        marker = os.path.join(folder, ".generated")
        tag = f"v{_DATASET_VERSIONS.get(name, 1)}"
        if os.path.exists(marker) and not force:
            with open(marker) as fh:
                if tag in fh.read():
                    continue
            # stale layout from an earlier generator version: rebuild
        _MATERIALIZERS[name](folder)
        with open(marker, "w") as fh:
            fh.write(
                f"generated by deep_cartograph_torch.utils.demo_data {tag}\n"
            )
