"""Feature-label grammar: the bijective mapping between feature names and
their geometric definition.

Label forms (cf. reference assembler.py:115-233 get_feature_command and
md.py:26-475 discovery):

    dist-@CA_584-@CA_549          pairwise distance (nm)
    dist-12-center_name_CA       distance from 1-based atom index to a center
    coord-@CA_5.x                 atom coordinate (nm), axis in {x,y,z}
    sin-@A_1-@B_2-@C_3-@D_4       sin of dihedral over 4 atoms
    cos-@A_1-@B_2-@C_3-@D_4       cos of dihedral
    tor-@A_1-@B_2-@C_3-@D_4       dihedral angle (radians)
    sin-@phi_7 / tor-@psi_7       protein-backbone dihedral shortcuts

Entity forms:
    @NAME_RESID    atom addressed by name+resid
    @phi_RESID / @psi_RESID   backbone dihedral shortcut
    center_<sel>   geometric center of an MDAnalysis selection (encoded)
    <int>          1-based atom index (PLUMED convention)

A copy of the JAX package's features/grammar.py (the parts compile_plan
uses), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

AXES = {"x": 0, "y": 1, "z": 2}

# Entity-name <-> MDAnalysis-selection encoding for center_ entities
# (cf. reference md.py:1658-1712 to_entity_name / to_mda_selection).
MDA_TO_ENTITY_MAP = {
    " ": "_",
    ":": "to",
    "-": "minus",
    "<": "lt",
    ">": "gt",
    "==": "eq",
    "<=": "leq",
    ">=": "geq",
    "!=": "neq",
}


def to_mda_selection(entity_name: str) -> str:
    # Decode longest token first: the reference iterates dict order
    # (md.py:1696-1699), where "eq"->"==" fires INSIDE "neq"/"leq"/"geq"
    # ("..._neq_12" -> "n== 12", an invalid selection). The ENCODING is
    # kept byte-identical to the reference's (feature labels must compare
    # equal across implementations); only the decode order is fixed.
    for value, key in sorted(
        ((v, k) for k, v in MDA_TO_ENTITY_MAP.items()),
        key=lambda kv: -len(kv[0]),
    ):
        entity_name = entity_name.replace(value, key)
    return entity_name


@dataclass(frozen=True)
class ParsedFeature:
    """A parsed feature label."""

    label: str
    kind: str                    # dist | coord | sin | cos | tor
    entities: Tuple[str, ...]    # raw entity strings (after the kind)
    axis: Optional[int] = None   # for coord features


def parse_feature(label: str) -> ParsedFeature:
    parts = label.split("-")
    kind = parts[0]
    if kind == "dist":
        if len(parts) != 3:
            raise ValueError(f"Malformed distance feature label: {label}")
        return ParsedFeature(label, "dist", tuple(parts[1:]))
    if kind == "coord":
        if len(parts) != 2 or "." not in parts[1]:
            raise ValueError(f"Malformed coord feature label: {label}")
        atom, axis = parts[1].split(".")
        return ParsedFeature(label, "coord", (atom,), AXES[axis])
    if kind in ("sin", "cos", "tor"):
        if len(parts) not in (2, 5):
            raise ValueError(f"Malformed {kind} feature label: {label}")
        return ParsedFeature(label, kind, tuple(parts[1:]))
    raise ValueError(f"Feature {label} not recognized.")


def entity_atom(entity: str) -> Tuple[str, int]:
    """Decompose '@CA_584' -> ('CA', 584)."""
    if not entity.startswith("@"):
        raise ValueError(f"Not an atom entity: {entity}")
    name, resid = entity[1:].rsplit("_", 1)
    return name, int(resid)


def resolve_entity_index(entity: str, topology) -> int:
    """Resolve an atom entity to a 0-based atom index in a Topology."""
    if entity.startswith("@"):
        name, resid = entity_atom(entity)
        return topology.atom_index(name, resid)
    # plain 1-based index (distance-to-center discovery path, md.py:699-702)
    return int(entity) - 1


def resolve_backbone_dihedral(
    kind: str, resid: int, topology
) -> Tuple[int, int, int, int]:
    """Resolve @phi_R / @psi_R shortcuts to their 4 backbone atom indices.

    phi(i) = C(i-1), N(i), CA(i), C(i);  psi(i) = N(i), CA(i), C(i), N(i+1)
    (standard PLUMED MOLINFO semantics).
    """
    if kind == "phi":
        return (
            topology.atom_index("C", resid - 1),
            topology.atom_index("N", resid),
            topology.atom_index("CA", resid),
            topology.atom_index("C", resid),
        )
    if kind == "psi":
        return (
            topology.atom_index("N", resid),
            topology.atom_index("CA", resid),
            topology.atom_index("C", resid),
            topology.atom_index("N", resid + 1),
        )
    raise ValueError(f"Unknown backbone dihedral shortcut: {kind}")


def dihedral_entities_to_indices(
    entities: Tuple[str, ...], topology
) -> Tuple[int, int, int, int]:
    """Resolve dihedral entities: either 4 atom entities or 1 shortcut."""
    if len(entities) == 4:
        return tuple(resolve_entity_index(e, topology) for e in entities)  # type: ignore[return-value]
    (ent,) = entities
    name, resid = entity_atom(ent)
    return resolve_backbone_dihedral(name, resid, topology)


@dataclass
class FeaturePlan:
    """Compiled evaluation plan for a feature list against one topology.

    The plan turns string labels into static index arrays so that one
    device pass evaluates every feature of a frame chunk at once.

    All geometry is computed in nm (PLUMED colvars convention) from Angstrom
    coordinates; angles in radians.
    """

    labels: List[str]
    # distance features: (n_dist, 2) atom indices; -1 marks a center slot
    dist_pairs: np.ndarray
    dist_out: np.ndarray           # (n_dist,) output column
    # which side of each pair is a center (index into centers) or -1
    dist_center_a: np.ndarray
    dist_center_b: np.ndarray
    # dihedral features: (n_dih, 4) atom indices
    dihedral_quads: np.ndarray
    dihedral_out: np.ndarray       # output columns
    dihedral_mode: np.ndarray      # 0=tor, 1=sin, 2=cos
    # coordinates: (n_coord,) atom index + axis + output column
    coord_atoms: np.ndarray
    coord_axes: np.ndarray
    coord_out: np.ndarray
    # centers: ragged -> padded (n_centers, max_atoms) with mask
    center_atoms: np.ndarray
    center_mask: np.ndarray
    n_features: int
    needs_fit: bool


def compile_plan(features_list: List[str], topology) -> FeaturePlan:
    """Compile feature labels into a FeaturePlan for a given topology."""
    parsed = [parse_feature(f) for f in features_list]

    # Collect centers first (cf. assembler.py:235-262 add_center_commands)
    center_names: List[str] = []
    center_atom_lists: List[np.ndarray] = []
    for p in parsed:
        for ent in p.entities:
            if ent.startswith("center_") and ent not in center_names:
                sel = to_mda_selection(ent.replace("center_", ""))
                idx = topology.select(sel)
                center_names.append(ent)
                center_atom_lists.append(np.asarray(idx))
    n_centers = len(center_names)
    max_center = max((len(a) for a in center_atom_lists), default=1)
    center_atoms = np.zeros((max(n_centers, 1), max_center), dtype=np.int32)
    center_mask = np.zeros((max(n_centers, 1), max_center), dtype=np.float32)
    for ci, atoms in enumerate(center_atom_lists):
        center_atoms[ci, : len(atoms)] = atoms
        center_mask[ci, : len(atoms)] = 1.0
    center_index = {name: i for i, name in enumerate(center_names)}

    dist_pairs, dist_out, dist_ca, dist_cb = [], [], [], []
    dih_quads, dih_out, dih_mode = [], [], []
    coord_atoms, coord_axes, coord_out = [], [], []
    # Dihedral angles shared between sin/cos pairs are computed once.
    mode_map = {"tor": 0, "sin": 1, "cos": 2}

    for out_col, p in enumerate(parsed):
        if p.kind == "dist":
            ea, eb = p.entities
            ca = center_index.get(ea, -1) if ea.startswith("center_") else -1
            cb = center_index.get(eb, -1) if eb.startswith("center_") else -1
            ia = 0 if ca >= 0 else resolve_entity_index(ea, topology)
            ib = 0 if cb >= 0 else resolve_entity_index(eb, topology)
            dist_pairs.append((ia, ib))
            dist_ca.append(ca)
            dist_cb.append(cb)
            dist_out.append(out_col)
        elif p.kind == "coord":
            coord_atoms.append(resolve_entity_index(p.entities[0], topology))
            coord_axes.append(p.axis)
            coord_out.append(out_col)
        else:
            quad = dihedral_entities_to_indices(p.entities, topology)
            dih_quads.append(quad)
            dih_out.append(out_col)
            dih_mode.append(mode_map[p.kind])

    needs_fit = any(p.kind == "coord" for p in parsed)

    def arr(x, dtype=np.int32, shape2=None):
        a = np.asarray(x, dtype=dtype)
        if a.size == 0 and shape2 is not None:
            a = a.reshape((0,) + shape2)
        return a

    return FeaturePlan(
        labels=list(features_list),
        dist_pairs=arr(dist_pairs, shape2=(2,)),
        dist_out=arr(dist_out),
        dist_center_a=arr(dist_ca),
        dist_center_b=arr(dist_cb),
        dihedral_quads=arr(dih_quads, shape2=(4,)),
        dihedral_out=arr(dih_out),
        dihedral_mode=arr(dih_mode),
        coord_atoms=arr(coord_atoms),
        coord_axes=arr(coord_axes),
        coord_out=arr(coord_out),
        center_atoms=center_atoms,
        center_mask=center_mask,
        n_features=len(parsed),
        needs_fit=needs_fit,
    )
