"""traj_augmentation tool: interpolate seed trajectories to N frames.

The port of the JAX package's tools/traj_augmentation.py (the
interpolation itself runs on the host, `geom/interpolate.py`).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Tuple, Union

from deep_cartograph_torch.config.schemas import traj_augmentation_config
from deep_cartograph_torch.geom.interpolate import interpolate_trajectory
from deep_cartograph_torch.utils.common import (
    check_data,
    files_exist,
    validate_configuration,
)
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


@traced("traj_augmentation")
def traj_augmentation(
    configuration: Dict,
    trajectory_data: Union[List[str], str],
    topology_data: Union[List[str], str],
    num_replicas: int = 1,
    output_folder: str = "traj_augmentation",
) -> Tuple[List[str], List[str]]:
    """Interpolate each seed trajectory (`num_replicas` times, seeds
    random_seed + replica); returns the new trajectories and topologies."""
    logger.info("=======================")
    logger.info("Trajectory Augmentation")
    logger.info("=======================")
    start_time = time.time()
    os.makedirs(output_folder, exist_ok=True)
    configuration = validate_configuration(
        configuration, traj_augmentation_config, output_folder
    )

    trajectories, topologies = check_data(trajectory_data, topology_data)
    if trajectories and not files_exist(*trajectories):
        raise FileNotFoundError("Trajectory file missing.")
    if topologies and not files_exist(*topologies):
        raise FileNotFoundError("Topology file missing.")

    augmented_trajectories: List[str] = []
    augmented_topologies: List[str] = []
    base_seed = configuration["random_seed"]
    for traj_path, top_path in zip(trajectories, topologies):
        logger.info("Processing trajectory: %s", Path(traj_path).stem)
        for replica in range(num_replicas):
            suffix = f"_rep{replica}" if num_replicas > 1 else ""
            new_traj, new_top = interpolate_trajectory(
                topology_file=top_path,
                trajectory_file=traj_path,
                num_frames=configuration["num_frames"],
                keep_original_frames=configuration["keep_original_frames"],
                interpolation_method=configuration["interpolation_method"],
                noise_std=configuration["noise_std"],
                random_seed=base_seed + replica,
                atom_selection=configuration["atom_selection"],
                traj_format=configuration["traj_format"],
                prepare_trajectory=configuration["prepare_trajectory"],
                output_path=output_folder,
                suffix=suffix,
            )
            augmented_trajectories.append(new_traj)
            augmented_topologies.append(new_top)

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Trajectory Augmentation): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return augmented_trajectories, augmented_topologies
