"""Host-side topology model: PDB parsing and atom metadata.

The part of the JAX package's io/topology.py that `Topology.from_pdb` and
`features.grammar.compile_plan` use, copied so the port imports nothing of
the JAX package. Parsing is host-side (not hot); coordinates become numpy
arrays ready for device upload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# Standard amino-acid residue names used by the `protein` selection keyword.
PROTEIN_RESNAMES: Set[str] = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    # common variants
    "HSD", "HSE", "HSP", "HID", "HIE", "HIP", "CYX", "CYM", "ASH", "GLH",
    "LYN", "ACE", "NME", "NMA",
}

BACKBONE_NAMES: Set[str] = {"N", "CA", "C", "O"}


@dataclass
class Topology:
    """Flat-array atom table for one structure."""

    names: np.ndarray          # (n,) str
    resids: np.ndarray         # (n,) int
    resnames: np.ndarray       # (n,) str
    chain_ids: np.ndarray      # (n,) str
    segids: np.ndarray         # (n,) str
    elements: np.ndarray       # (n,) str
    positions: np.ndarray      # (n, 3) float32 — Angstroms
    occupancies: np.ndarray    # (n,) float32
    bfactors: np.ndarray       # (n,) float32
    record_types: np.ndarray   # (n,) str ("ATOM"/"HETATM")
    # Optional explicit bonds (pairs of 0-based indices) from CONECT records.
    bonds: Optional[np.ndarray] = None  # (m, 2) int
    source_path: Optional[str] = None

    @property
    def n_atoms(self) -> int:
        return len(self.names)

    def select(self, selection: Optional[str]) -> np.ndarray:
        """Return sorted 0-based atom indices matching an MDAnalysis-style
        selection string (subset grammar — see io/selection.py)."""
        from deep_cartograph_torch.io.selection import evaluate_selection

        if selection is None or selection.strip() == "all":
            return np.arange(self.n_atoms)
        mask = evaluate_selection(selection, self)
        return np.nonzero(mask)[0]

    def atom_index(self, name: str, resid: int) -> int:
        """0-based index of the first atom with given name+resid."""
        hits = np.nonzero((self.names == name) & (self.resids == resid))[0]
        if len(hits) == 0:
            raise ValueError(f"Atom '{name}' with resid {resid} not found in topology.")
        return int(hits[0])

    @classmethod
    def from_pdb(cls, path: str) -> "Topology":
        return parse_pdb(path)


# Atom names that ARE two-letter elements when they stand alone (ions and
# common hetero atoms). Deliberately excludes ambiguous protein names:
# CA (C-alpha vs calcium), HG/HE/HB (hydrogens vs Hg/He), CD/CE/NE/ND
# (sidechain atoms vs Cd/Ce/Ne/Nd) — those stay single-letter guesses,
# matching MDAnalysis's conservative table.
_TWO_LETTER_ELEMENTS = {
    "CL": "CL", "BR": "BR", "MG": "MG", "FE": "FE", "ZN": "ZN",
    "MN": "MN", "CU": "CU", "NI": "NI", "NA": "NA", "LI": "LI",
    "RB": "RB", "CS": "CS", "SR": "SR", "BA": "BA", "IOD": "I",
}


# Residue names for which a standalone 'NA' atom really is sodium. In
# hetero groups like heme/porphyrin, pyrrole nitrogens are conventionally
# named NA/NB/NC/ND, so NA only maps to sodium inside ion residues.
_SODIUM_RESNAMES = {"NA", "NA+", "SOD", "SDM", "SODIUM"}


def _guess_element(name: str, resname: Optional[str] = None) -> str:
    stripped = name.strip()
    if not stripped:
        return ""
    # Strip leading digits (e.g. 1HB) then take the leading alpha char(s).
    i = 0
    while i < len(stripped) and stripped[i].isdigit():
        i += 1
    if i >= len(stripped):
        return ""
    rest = stripped[i:].upper()
    if rest == "NA" and resname is not None and \
            resname.strip().upper() not in _SODIUM_RESNAMES:
        return "N"
    if rest in _TWO_LETTER_ELEMENTS:
        return _TWO_LETTER_ELEMENTS[rest]
    return rest[0]


def parse_pdb(path: str, model: int = 1) -> Topology:
    """Parse one MODEL of a PDB file into a Topology (fixed-column format)."""
    names, resids, resnames, chains, segs, elements = [], [], [], [], [], []
    xyz, occ, bf, rectypes = [], [], [], []
    conect_pairs: List[Tuple[int, int]] = []
    serial_to_index: Dict[int, int] = {}

    current_model = 0
    in_target_model = True
    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec.startswith("MODEL"):
                current_model += 1
                in_target_model = current_model == model
                continue
            if rec.startswith("ENDMDL"):
                if current_model == model:
                    in_target_model = False
                continue
            if not in_target_model:
                continue
            if rec in ("ATOM  ", "HETATM"):
                try:
                    serial = int(line[6:11])
                except ValueError:
                    serial = len(names) + 1
                name = line[12:16].strip()
                resname = line[17:21].strip()
                chain = line[21].strip()
                try:
                    resid = int(line[22:26])
                except ValueError:
                    resid = 0
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                try:
                    o = float(line[54:60])
                except (ValueError, IndexError):
                    o = 1.0
                try:
                    b = float(line[60:66])
                except (ValueError, IndexError):
                    b = 0.0
                seg = line[72:76].strip() if len(line) > 72 else ""
                elem = line[76:78].strip() if len(line) > 76 else ""
                if not elem:
                    elem = _guess_element(name, resname)
                serial_to_index[serial] = len(names)
                names.append(name)
                resids.append(resid)
                resnames.append(resname)
                chains.append(chain)
                segs.append(seg)
                elements.append(elem)
                xyz.append((x, y, z))
                occ.append(o)
                bf.append(b)
                rectypes.append(rec.strip())
            elif rec.startswith("CONECT"):
                fields = line.split()
                if len(fields) >= 3:
                    try:
                        a = int(fields[1])
                        for other in fields[2:]:
                            b_ = int(other)
                            if a in serial_to_index and b_ in serial_to_index:
                                i, j = serial_to_index[a], serial_to_index[b_]
                                if i != j:
                                    conect_pairs.append((min(i, j), max(i, j)))
                    except ValueError:
                        continue

    if not names:
        raise ValueError(f"No atoms parsed from PDB file: {path}")

    bonds = (
        np.unique(np.asarray(conect_pairs, dtype=np.int64), axis=0)
        if conect_pairs
        else None
    )
    return Topology(
        names=np.asarray(names, dtype=object),
        resids=np.asarray(resids, dtype=np.int64),
        resnames=np.asarray(resnames, dtype=object),
        chain_ids=np.asarray(chains, dtype=object),
        segids=np.asarray(segs, dtype=object),
        elements=np.asarray(elements, dtype=object),
        positions=np.asarray(xyz, dtype=np.float32),
        occupancies=np.asarray(occ, dtype=np.float32),
        bfactors=np.asarray(bf, dtype=np.float32),
        record_types=np.asarray(rectypes, dtype=object),
        bonds=bonds,
        source_path=path,
    )
