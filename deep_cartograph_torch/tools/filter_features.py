"""filter_features tool: statistical screening of feature time series.

The port of the JAX package's tools/filter_features.py: the Filter's
screens on the tool's device, the kept features written one per line to
`filtered_features.txt` (and the summary CSV).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Union

from deep_cartograph_torch.config.schemas import filter_features_config
from deep_cartograph_torch.features.filter import Filter
from deep_cartograph_torch.io.colvars import check
from deep_cartograph_torch.utils.common import save_list, validate_configuration
from deep_cartograph_torch.utils.device import DeviceLike
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


@traced("filter_features")
def filter_features(
    configuration: Dict,
    colvars_paths: Union[str, List[str]],
    waypoint_colvars_paths: Optional[List[str]] = None,
    csv_summary: bool = True,
    topologies: Optional[List[str]] = None,
    waypoint_topologies: Optional[List[str]] = None,
    reference_topology: Optional[str] = None,
    output_folder: str = "filter_features",
    device: DeviceLike = None,
) -> str:
    """Filter the features; returns the path of the kept-feature list. An
    existing list is returned as it is.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("==================")
    logger.info("Filtering features")
    logger.info("==================")
    start_time = time.time()

    output_features_path = os.path.join(output_folder, "filtered_features.txt")
    if os.path.exists(output_features_path):
        logger.info(
            "Filtered features file already exists: %s. Skipping filtering.",
            output_features_path,
        )
        return output_features_path

    os.makedirs(output_folder, exist_ok=True)
    configuration = validate_configuration(
        configuration, filter_features_config, output_folder
    )

    if isinstance(colvars_paths, str):
        colvars_paths = [colvars_paths]
    for path in colvars_paths:
        check(path)

    if topologies and reference_topology is None:
        reference_topology = topologies[0]

    filtered = Filter(
        settings=configuration["filter_settings"],
        colvars_paths=colvars_paths,
        waypoint_colvars_paths=waypoint_colvars_paths,
        topologies=topologies,
        waypoint_topologies=waypoint_topologies,
        reference_topology=reference_topology,
        output_dir=output_folder,
        device=device,
    ).run(csv_summary)

    save_list(filtered, output_features_path)

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Filter features): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return output_features_path
