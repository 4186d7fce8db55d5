"""Feature-label translation between topologies.

A copy of the JAX package's features/translator.py: labels like ``dist-@CA_584-@CA_549``,
``coord-@CA_5.x``, ``sin/cos/tor-@A_1-@B_2-@C_3-@D_4`` are re-addressed to a
target topology via residue remapping; untranslatable features become None.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from deep_cartograph_torch.features.mapper import PDBTopologyMapper

logger = logging.getLogger(__name__)


class Translator:
    def __init__(
        self,
        reference_topology: str,
        target_topology: str,
        reference_features: List[str],
    ):
        self.reference_topology = reference_topology
        self.target_topology = target_topology
        self.reference_features = reference_features

    def run(self) -> List[Optional[str]]:
        self.top_mapper = PDBTopologyMapper(
            self.reference_topology, self.target_topology
        )
        return self.translate_features()

    def translate_features(self) -> List[Optional[str]]:
        translated: List[Optional[str]] = []
        for feature in self.reference_features:
            entities = feature.split("-")
            if len(entities) == 1:
                # No atoms in the label (e.g. a time column): pass through.
                translated.append(feature)
                continue
            feature_name, ref_atoms = entities[0], entities[1:]
            axis = None
            if feature_name == "coord":
                atom, axis = ref_atoms[-1].split(".")
                ref_atoms[-1] = atom
            atoms = [self.translate_atom(a) for a in ref_atoms]
            if None not in atoms:
                label = feature_name + "-" + "-".join(atoms)  # type: ignore[arg-type]
                if axis is not None:
                    label += "." + axis
                translated.append(label)
            else:
                translated.append(None)
        return translated

    def translate_atom(self, atom: str) -> Optional[str]:
        """Translate '@CA_579'-style entities. center_ entities and plain
        1-based atom indices (distance-to-center features) pass through
        unchanged — they are selection-derived, not resid-addressed. (The
        reference's translator crashes on both forms.)"""
        if atom.startswith("center_") or not atom.startswith("@"):
            return atom
        ref_atom_name, ref_resid = atom.split("_")
        target_resid = self.top_mapper.map_residue(int(ref_resid))
        if target_resid is None:
            return None
        return f"{ref_atom_name}_{target_resid}"
