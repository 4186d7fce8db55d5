"""Structure-level outputs: the per-atom sensitivity map.

The part of the JAX package's geom/structure.py that the CV calculators
use. The PLUMED RMSD templates and waypoint references come with the PLUMED
files (ROADMAP Queue 1).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np

from deep_cartograph_torch.io.topology import Topology

logger = logging.getLogger(__name__)


def map_sensitivity_to_structure(
    per_atom_sensitivities: Dict[int, float],
    topology_path: str,
    output_folder: str,
) -> None:
    """Write the sensitivities, scaled to 0-100, into the B-factors of
    sensitivity_structure.pdb."""
    values = np.asarray(list(per_atom_sensitivities.values()), dtype=float)
    if values.size == 0:
        logger.warning("No sensitivities to map.")
        return
    values = np.clip(values, 0.0, None)
    vmin, vmax = values.min(), values.max()
    scale = (vmax - vmin) if vmax > vmin else 1.0

    top = Topology.from_file(topology_path)
    bf = np.zeros(top.n_atoms, np.float32)
    for atom_index, sens in per_atom_sensitivities.items():
        if 0 <= atom_index < top.n_atoms:
            bf[atom_index] = (max(sens, 0.0) - vmin) / scale * 100.0
    top.write_pdb(os.path.join(output_folder, "sensitivity_structure.pdb"), bfactors=bf)
