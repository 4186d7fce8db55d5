"""Feature discovery from topology + selections.

Parity with the reference's MDAnalysis-based discovery
(deep_cartograph/modules/md/md.py:26-717): same label order, same skip rules
(heavy atoms only, bonded-atom and neighbor-residue exclusion, strides), same
group wrappers, so a feature list produced here matches one produced by the
reference for the same config.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from deep_cartograph_torch.features.grammar import to_entity_name
from deep_cartograph_torch.io.topology import COVALENT_BOND_THRESHOLD, Topology

logger = logging.getLogger(__name__)


def _heavy(topology: Topology, indices: np.ndarray) -> np.ndarray:
    """Filter to heavy atoms ('not name H*')."""
    names = topology.names[indices]
    keep = [not str(n).startswith("H") for n in names]
    return indices[np.asarray(keep, dtype=bool)]


def find_distances(
    topology: Topology,
    selection1: str,
    selection2: str,
    stride1: int,
    stride2: int,
    skip_neighbors: bool,
    skip_bonded_atoms: bool,
) -> List[str]:
    """All pairwise heavy-atom distances between two selections
    (cf. reference md.py:26-129). Pair generation is vectorized."""
    first = _heavy(topology, topology.select(selection1))[::stride1]
    second = _heavy(topology, topology.select(selection2))[::stride2]
    if len(first) == 0:
        raise ValueError(
            f"First selection: '{selection1}' is empty, please review the selection string."
        )
    if len(second) == 0:
        raise ValueError(
            f"Second selection: '{selection2}' is empty, please review the selection string."
        )

    resids = topology.resids
    names = topology.names

    # Vectorized pair generation preserving the reference's iteration-order
    # semantics (first-selection-major, first-occurrence dedup of unordered
    # pairs) — the reference's O(n1*n2) Python loop (md.py:89-128) does not
    # scale to the 10k+-feature configs.
    ia = np.repeat(first, len(second))
    ib = np.tile(second, len(first))
    keep = ia != ib
    ia, ib = ia[keep], ib[keep]

    lo = np.minimum(ia, ib)
    hi = np.maximum(ia, ib)
    key = lo.astype(np.int64) * (topology.n_atoms + 1) + hi
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    ia, ib = ia[first_idx], ib[first_idx]

    if skip_neighbors:
        keep = np.abs(resids[ia] - resids[ib]) > 1
        ia, ib = ia[keep], ib[keep]

    if skip_bonded_atoms and len(ia):
        bond_sets = topology.bond_neighbor_sets()
        keep = np.asarray(
            [int(b) not in bond_sets[int(a)] for a, b in zip(ia, ib)],
            dtype=bool,
        )
        ia, ib = ia[keep], ib[keep]

    return [
        f"@{names[a]}_{resids[a]}-@{names[b]}_{resids[b]}"
        for a, b in zip(ia, ib)
    ]


def find_coordinates(topology: Topology, selection: str, stride: int) -> List[str]:
    """Atom entities for coordinate features (cf. reference md.py:179-224)."""
    atoms = topology.select(selection)[::stride]
    if len(atoms) == 0:
        raise ValueError(
            f"Selection: '{selection}' is empty, please review the selection string."
        )
    return [f"@{topology.names[i]}_{topology.resids[i]}" for i in atoms]


def find_virtual_dihedrals(topology: Topology, selection: str) -> List[str]:
    """Consecutive 4-tuples over heavy atoms in selection order — intended for
    coarse-grained (e.g. CA-only) models (cf. reference md.py:226-273)."""
    atoms = _heavy(topology, topology.select(selection))
    if len(atoms) == 0:
        raise ValueError(
            f"Selection: '{selection}' is empty, please review the selection string."
        )
    labels = []
    names, resids = topology.names, topology.resids
    for i in range(3, len(atoms)):
        quad = atoms[i - 3 : i + 1]
        labels.append(
            "-".join(f"@{names[a]}_{resids[a]}" for a in quad)
        )
    return labels


def find_protein_backbone_dihedrals(topology: Topology, selection: str) -> List[str]:
    """@phi_R / @psi_R labels for residues present in the selection
    (cf. reference md.py:275-338)."""
    atoms = topology.select(selection)
    residues = np.unique(topology.resids[atoms])
    resset = set(int(r) for r in residues)
    labels = []
    for residue in residues:
        r = int(residue)
        for dihedral in ("phi", "psi"):
            if dihedral == "phi" and (r - 1) not in resset:
                logger.warning(
                    "Residue %d does not have a previous residue, skipping phi dihedral.", r
                )
                continue
            if dihedral == "psi" and (r + 1) not in resset:
                logger.warning(
                    "Residue %d does not have a next residue, skipping psi dihedral.", r
                )
                continue
            labels.append(f"@{dihedral}_{r}")
    return labels


def find_real_dihedrals(topology: Topology, selection: str) -> List[str]:
    """All 4-tuples of bonded heavy atoms (cf. reference md.py:340-475).

    Uses explicit bonds when available, otherwise the same distance criterion
    (< 2 Angstroms) as the reference.
    """
    atoms = _heavy(topology, topology.select(selection))
    if len(atoms) == 0:
        raise ValueError(
            f"Selection: '{selection}' is empty, please review the selection string."
        )
    heavy_set = set(int(a) for a in atoms)
    names, resids = topology.names, topology.resids

    if topology.has_bonds():
        bonds = topology.bonds
    else:
        logger.info(
            "Topology does not contain bonds. Bonds will be guessed with a "
            "distance criterion (bond_length < %s).",
            COVALENT_BOND_THRESHOLD,
        )
        bonds = topology.guess_bonds()

    neighbors: Dict[int, set] = {int(a): set() for a in atoms}
    heavy_bonds = []
    for i, j in bonds:
        i, j = int(i), int(j)
        if i in heavy_set and j in heavy_set:
            neighbors[i].add(j)
            neighbors[j].add(i)
            heavy_bonds.append((i, j))

    labels: List[str] = []
    seen = set()
    for i, j in heavy_bonds:
        for ni in neighbors[i]:
            if ni == j:
                continue
            for nj in neighbors[j]:
                if nj == i or nj == ni:
                    continue
                quad = (ni, i, j, nj)
                if quad in seen or quad[::-1] in seen:
                    continue
                seen.add(quad)
                labels.append(
                    "-".join(f"@{names[a]}_{resids[a]}" for a in quad)
                )
    return labels


def find_dihedrals(topology: Topology, selection: str, search_mode: str) -> List[str]:
    """Dispatch by search mode (cf. reference md.py:131-177)."""
    if search_mode == "virtual":
        return find_virtual_dihedrals(topology, selection)
    if search_mode == "protein_backbone":
        return find_protein_backbone_dihedrals(topology, selection)
    if search_mode == "real":
        return find_real_dihedrals(topology, selection)
    raise ValueError(
        f"search_mode {search_mode} not supported. Options: (virtual, protein_backbone, real)"
    )


# ---------------------------------------------------------------------------
# Group wrappers (cf. reference md.py:479-576)
# ---------------------------------------------------------------------------

def get_dihedral_labels(topology: Topology, definition: Dict) -> List[str]:
    selection = definition.get("selection", "all")
    search_mode = definition.get("search_mode", "real")
    atom_labels = find_dihedrals(topology, selection, search_mode)
    labels = []
    for label in atom_labels:
        if definition.get("periodic_encoding", True):
            labels.append(f"sin-{label}")
            labels.append(f"cos-{label}")
        else:
            labels.append(f"tor-{label}")
    return labels


def get_distance_labels(topology: Topology, definition: Dict) -> List[str]:
    atom_labels = find_distances(
        topology,
        definition.get("first_selection", "all"),
        definition.get("second_selection", "all"),
        definition.get("first_stride", 1),
        definition.get("second_stride", 1),
        definition.get("skip_neigh_residues", False),
        definition.get("skip_bonded_atoms", False),
    )
    return [f"dist-{label}" for label in atom_labels]


def get_coordinate_labels(topology: Topology, definition: Dict) -> List[str]:
    atom_labels = find_coordinates(
        topology,
        definition.get("selection", "all"),
        definition.get("stride", 1),
    )
    return [f"coord-{label}.{ax}" for label in atom_labels for ax in ("x", "y", "z")]


def get_features_list(features_configuration: Dict, topology_path: str) -> List[str]:
    """Full feature list from a features config dict against one topology
    (cf. reference md.py:580-717). Label order matches the reference:
    coordinates, distances, dihedrals, distance-to-center groups."""
    topology = Topology.from_file(topology_path)
    features_labels: List[str] = []

    for group in (features_configuration.get("coordinate_groups") or {}).values():
        features_labels.extend(get_coordinate_labels(topology, group))

    for group in (features_configuration.get("distance_groups") or {}).values():
        features_labels.extend(get_distance_labels(topology, group))

    for group in (features_configuration.get("dihedral_groups") or {}).values():
        features_labels.extend(get_dihedral_labels(topology, group))

    for group in (
        features_configuration.get("distance_to_center_groups") or {}
    ).values():
        center_label = f"center_{to_entity_name(group['center_selection'])}"
        atoms = topology.indices_one_based(group["selection"])
        features_labels.extend(f"dist-{a}-{center_label}" for a in atoms)

    if len(features_labels) == 0:
        raise ValueError(
            "No features found, please check the features section of the "
            "configuration file and the topology."
        )
    return features_labels
