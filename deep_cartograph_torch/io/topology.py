"""Host-side topology model: PDB and GRO parsing, PDB writing, atom
metadata and bonds.

The port's copy of the JAX package's io/topology.py, so that the port
imports nothing of the JAX package. Parsing is host-side (not hot);
coordinates become numpy arrays ready for device upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# Covalent bond guess threshold (Angstroms), the reference's distance
# criterion (md.py:22 `covalent_bond_threshold = 2.0`).
COVALENT_BOND_THRESHOLD = 2.0

# Standard amino-acid residue names used by the `protein` selection keyword.
PROTEIN_RESNAMES: Set[str] = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    # common variants
    "HSD", "HSE", "HSP", "HID", "HIE", "HIP", "CYX", "CYM", "ASH", "GLH",
    "LYN", "ACE", "NME", "NMA",
}

BACKBONE_NAMES: Set[str] = {"N", "CA", "C", "O"}

# 3-letter -> 1-letter amino acid code (for sequence alignment / topology mapping).
AA_THREE_TO_ONE: Dict[str, str] = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
    "HSD": "H", "HSE": "H", "HSP": "H", "HID": "H", "HIE": "H", "HIP": "H",
    "CYX": "C", "CYM": "C", "ASH": "D", "GLH": "E", "LYN": "K", "MSE": "M",
}


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
    _bond_sets: Optional[List[Set[int]]] = field(default=None, repr=False)

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

    def indices_one_based(self, selection: Optional[str] = None) -> List[int]:
        """1-based indices as PLUMED numbers atoms (cf. reference md.py:855-890)."""
        return [int(i) + 1 for i in self.select(selection)]

    def has_bonds(self) -> bool:
        return self.bonds is not None and len(self.bonds) > 0

    def guess_bonds(
        self,
        indices: Optional[Sequence[int]] = None,
        box: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Guess bonds with the reference's distance criterion (bond length
        < 2 Angstroms). With `box` (orthorhombic lengths, Angstroms),
        distances are minimum-image, so molecules wrapped across a periodic
        boundary keep their bonds."""
        idx = np.asarray(indices) if indices is not None else np.arange(self.n_atoms)
        pos = self.positions[idx]
        # O(n^2) distance check: fine on the host for topology-sized n.
        diff = pos[:, None, :] - pos[None, :, :]
        if box is not None:
            b = np.asarray(box, pos.dtype).reshape(1, 1, 3)
            diff = diff - b * np.round(diff / b)
        dist = np.sqrt((diff * diff).sum(-1))
        ii, jj = np.nonzero((dist < COVALENT_BOND_THRESHOLD) & (dist > 1e-6))
        keep = ii < jj
        return np.stack([idx[ii[keep]], idx[jj[keep]]], axis=1)

    def bond_neighbor_sets(self) -> List[Set[int]]:
        """Adjacency sets from explicit bonds (or guessed if absent)."""
        if self._bond_sets is None:
            bonds = self.bonds if self.has_bonds() else self.guess_bonds()
            sets: List[Set[int]] = [set() for _ in range(self.n_atoms)]
            for i, j in bonds:
                sets[int(i)].add(int(j))
                sets[int(j)].add(int(i))
            self._bond_sets = sets
        return self._bond_sets

    def residue_sequence(self) -> Tuple[str, List[int]]:
        """One-letter sequence and resid list, residues in file order."""
        seq: List[str] = []
        resid_list: List[int] = []
        seen: Set[Tuple[str, int]] = set()
        for i in range(self.n_atoms):
            key = (str(self.chain_ids[i]), int(self.resids[i]))
            if key in seen:
                continue
            seen.add(key)
            seq.append(AA_THREE_TO_ONE.get(str(self.resnames[i]), "X"))
            resid_list.append(int(self.resids[i]))
        return "".join(seq), resid_list

    def atom_index(self, name: str, resid: int) -> int:
        """0-based index of the first atom with given name+resid."""
        hits = np.nonzero((self.names == name) & (self.resids == resid))[0]
        if len(hits) == 0:
            raise ValueError(f"Atom '{name}' with resid {resid} not found in topology.")
        return int(hits[0])

    @classmethod
    def from_pdb(cls, path: str) -> "Topology":
        return parse_pdb(path)

    @classmethod
    def from_file(cls, path: str) -> "Topology":
        lower = path.lower()
        if lower.endswith(".pdb"):
            return parse_pdb(path)
        if lower.endswith(".gro"):
            from deep_cartograph_torch.io.gro import parse_gro

            return parse_gro(path)
        raise ValueError(f"Unsupported topology format: {path}")

    def subset(self, indices: Sequence[int]) -> "Topology":
        idx = np.asarray(indices)
        bonds = None
        if self.has_bonds():
            idx_set = {int(i) for i in idx}
            remap = {int(old): new for new, old in enumerate(idx)}
            kept = [
                (remap[int(a)], remap[int(b)])
                for a, b in self.bonds
                if int(a) in idx_set and int(b) in idx_set
            ]
            bonds = np.asarray(kept, dtype=np.int64) if kept else None
        return Topology(
            names=self.names[idx],
            resids=self.resids[idx],
            resnames=self.resnames[idx],
            chain_ids=self.chain_ids[idx],
            segids=self.segids[idx],
            elements=self.elements[idx],
            positions=self.positions[idx],
            occupancies=self.occupancies[idx],
            bfactors=self.bfactors[idx],
            record_types=self.record_types[idx],
            bonds=bonds,
            source_path=self.source_path,
        )

    def write_pdb(
        self,
        path: str,
        positions: Optional[np.ndarray] = None,
        occupancies: Optional[np.ndarray] = None,
        bfactors: Optional[np.ndarray] = None,
        include_conect: bool = False,
    ) -> None:
        write_pdb(self, path, positions, occupancies, bfactors, include_conect)


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


def _format_atom_name(name: str, element: str) -> str:
    """PDB atom-name column rules: 1-char elements start at column 14."""
    if len(name) >= 4:
        return name[:4]
    if len(element) == 1 and len(name) <= 3:
        return f" {name:<3}"
    return f"{name:<4}"


def write_pdb(
    top: Topology,
    path: str,
    positions: Optional[np.ndarray] = None,
    occupancies: Optional[np.ndarray] = None,
    bfactors: Optional[np.ndarray] = None,
    include_conect: bool = False,
) -> None:
    """Write a PLUMED-friendly PDB: no CRYST1, no CONECT unless asked."""
    pos = np.asarray(positions) if positions is not None else top.positions
    occ = np.asarray(occupancies) if occupancies is not None else top.occupancies
    bf = np.asarray(bfactors) if bfactors is not None else top.bfactors
    lines: List[str] = []
    for i in range(top.n_atoms):
        serial = (i + 1) % 100000
        name_field = _format_atom_name(str(top.names[i]), str(top.elements[i]))
        resname = str(top.resnames[i])[:4]
        chain = (str(top.chain_ids[i]) or " ")[:1]
        resid = int(top.resids[i]) % 10000
        x, y, z = pos[i]
        seg = str(top.segids[i])[:4]
        elem = str(top.elements[i])[:2]
        lines.append(
            f"ATOM  {serial:>5} {name_field}{'':1}{resname:<4}{chain}{resid:>4}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{occ[i]:6.2f}{bf[i]:6.2f}      "
            f"{seg:<4}{elem:>2}\n"
        )
    if include_conect and top.has_bonds():
        for a, b in top.bonds:
            lines.append(f"CONECT{a + 1:>5}{b + 1:>5}\n")
    lines.append("END\n")
    with open(path, "w") as fh:
        fh.writelines(lines)


def create_pdb(structure_path: str, file_name: str) -> None:
    """Round-trip a structure file into a clean PDB."""
    Topology.from_file(structure_path).write_pdb(file_name)
