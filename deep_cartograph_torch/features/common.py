"""Common-feature intersection across topologies.

Parity with the reference find_common_features
(deep_cartograph/modules/features/common.py:14-129): discover features on the
reference topology, translate to every other topology, and keep only features
translatable everywhere (order preserved).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

from deep_cartograph_torch.features.discovery import get_features_list
from deep_cartograph_torch.features.translator import Translator
from deep_cartograph_torch.utils.common import save_list

logger = logging.getLogger(__name__)


def find_common_features(
    features_configuration: Dict,
    topologies: List[str],
    reference_topology: Optional[str] = None,
    output_folder: Optional[str] = None,
) -> List[str]:
    if reference_topology is None:
        reference_topology = topologies[0]

    ref_features = get_features_list(features_configuration, reference_topology)
    keep = [True] * len(ref_features)

    for topology in topologies:
        if os.path.abspath(topology) == os.path.abspath(reference_topology):
            continue
        translated = Translator(reference_topology, topology, ref_features).run()
        for i, t in enumerate(translated):
            if t is None:
                keep[i] = False

    common = [f for f, k in zip(ref_features, keep) if k]
    dropped = len(ref_features) - len(common)
    if dropped:
        logger.warning(
            "%d features are not common to all topologies and were dropped.", dropped
        )
    if len(common) == 0:
        raise ValueError("No common features found across the given topologies.")

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        save_list(common, os.path.join(output_folder, "common_features.txt"))
    return common
