"""The deep_cartograph 7-step pipeline.

The port of the JAX package's pipeline.py: STEP 0 analyze_geometry ->
STEP 1 traj_augmentation -> STEP 2.0 find_common_features -> STEP 2.1
compute_features (training, validation, supplementary and waypoint data)
-> STEP 3 filter_features -> STEP 4 train_colvars -> STEP 5
traj_projection -> STEP 6 traj_cluster, on one device (CUDA unless the
caller asks for the CPU). A restart skips each step whose outputs exist;
a CV that produced no model or projection is dropped from steps 5 and 6.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Literal, Optional, Union

from deep_cartograph_torch.config.schemas import deep_cartograph_config
from deep_cartograph_torch.features.common import find_common_features
from deep_cartograph_torch.tools.analyze_geometry import analyze_geometry
from deep_cartograph_torch.tools.compute_features import compute_features
from deep_cartograph_torch.tools.filter_features import filter_features
from deep_cartograph_torch.tools.train_colvars import train_colvars
from deep_cartograph_torch.tools.traj_augmentation import traj_augmentation
from deep_cartograph_torch.tools.traj_cluster import traj_cluster
from deep_cartograph_torch.tools.traj_projection import traj_projection
from deep_cartograph_torch.utils.common import (
    check_data,
    find_files,
    get_unique_path,
    read_features_list,
    validate_configuration,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("deep_cartograph_torch")


def deep_cartograph(
    configuration: Dict,
    trajectory_data: Optional[Union[List[str], str]] = None,
    topology_data: Optional[Union[List[str], str]] = None,
    validation_trajectory_data: Optional[Union[List[str], str]] = None,
    validation_topology_data: Optional[Union[List[str], str]] = None,
    seed_trajectory_data: Optional[Union[List[str], str]] = None,
    seed_topology_data: Optional[Union[List[str], str]] = None,
    supplementary_traj_data: Optional[Union[List[str], str]] = None,
    supplementary_top_data: Optional[Union[List[str], str]] = None,
    reference_topology: Optional[str] = None,
    waypoints_data: Optional[Union[List[str], str]] = None,
    dimension: Optional[int] = None,
    cvs: Optional[List[Literal["pca", "ae", "tica", "htica", "deep_tica", "vae", "umap"]]] = None,
    restart: bool = False,
    output_folder: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """Run the whole workflow into `output_folder` (default
    "deep_cartograph", made unique unless `restart`).

    `device`: None means CUDA (raises without a card); "cpu" runs every
    step on the host."""
    start_time = time.time()
    dev = resolve_device(device)

    if not output_folder:
        output_folder = "deep_cartograph"
    if not restart:
        output_folder = get_unique_path(output_folder)
    os.makedirs(output_folder, exist_ok=True)

    configuration = validate_configuration(
        configuration, deep_cartograph_config, output_folder
    )

    trajectories, topologies = check_data(trajectory_data, topology_data)
    trajectory_names = [Path(t).stem for t in trajectories]
    seed_trajectories, seed_topologies = check_data(
        seed_trajectory_data, seed_topology_data
    )
    trajectory_seed_names = [Path(t).stem for t in seed_trajectories]

    supplementary_trajs = supplementary_tops = None
    sup_trajectory_names = None
    if supplementary_traj_data:
        supplementary_trajs, supplementary_tops = check_data(
            supplementary_traj_data, supplementary_top_data
        )
        sup_trajectory_names = [Path(t).stem for t in supplementary_trajs]
    val_trajs = val_tops = None
    if validation_trajectory_data:
        val_trajs, val_tops = check_data(
            validation_trajectory_data, validation_topology_data
        )
    transition_waypoints = None
    if waypoints_data:
        transition_waypoints = find_files(waypoints_data)

    if len(trajectories) + len(seed_trajectories) == 0:
        logger.error("No trajectory files found in the provided paths.")
        sys.exit(1)

    if not reference_topology:
        if topologies:
            reference_topology = topologies[0]
        elif seed_topologies:
            reference_topology = seed_topologies[0]
        else:
            logger.error("No topology files found to set as reference topology.")
            sys.exit(1)
    elif not os.path.exists(reference_topology):
        logger.error("Reference topology file missing: %s", reference_topology)
        sys.exit(1)

    # STEP 0: Analyze geometry
    analyze_geometry(
        configuration=configuration["analyze_geometry"],
        trajectories=trajectories,
        topologies=topologies,
        ref_topologies=supplementary_tops if supplementary_traj_data else None,
        output_folder=os.path.join(output_folder, "analyze_geometry"),
        device=dev,
    )

    # STEP 1: Augment seed trajectories
    augmented_trajs, augmented_tops = traj_augmentation(
        configuration=configuration["traj_augmentation"],
        trajectory_data=seed_trajectories,
        topology_data=seed_topologies,
        output_folder=os.path.join(output_folder, "traj_augmentation"),
    )
    trajectories = trajectories + augmented_trajs
    topologies = topologies + augmented_tops
    trajectory_names = trajectory_names + trajectory_seed_names

    # STEP 2.0: Common features across all topologies
    all_topologies = list(topologies)
    if supplementary_traj_data:
        all_topologies += supplementary_tops
    if validation_trajectory_data:
        all_topologies += val_tops
    if waypoints_data:
        all_topologies += transition_waypoints
    ref_common_features = find_common_features(
        features_configuration=configuration["compute_features"][
            "plumed_settings"
        ]["features"],
        topologies=all_topologies,
        reference_topology=reference_topology,
        output_folder=os.path.join(output_folder, "common_features"),
    )

    # STEP 2.1: Compute features (train / validation / supplementary / waypoints)
    def features_of(trajs, tops, folder, traj_stride=None):
        return compute_features(
            configuration=configuration["compute_features"],
            trajectory_data=trajs,
            topology_data=tops,
            reference_topology=reference_topology,
            reference_features=ref_common_features,
            traj_stride=traj_stride,
            output_folder=os.path.join(output_folder, folder),
            device=dev,
        )

    traj_colvars_paths = features_of(trajectories, topologies, "compute_features")
    validation_colvars_paths = None
    if validation_trajectory_data:
        validation_colvars_paths = features_of(val_trajs, val_tops,
                                               "compute_val_features")
    supplementary_colvars_paths = None
    if supplementary_traj_data:
        supplementary_colvars_paths = features_of(
            supplementary_trajs, supplementary_tops, "compute_ref_features", 1
        )
    waypoint_colvars_paths = None
    if waypoints_data:
        waypoint_colvars_paths = features_of(
            transition_waypoints, transition_waypoints, "compute_waypoint_features", 1
        )

    # STEP 3: Filter features
    output_features_path = filter_features(
        configuration=configuration["filter_features"],
        colvars_paths=traj_colvars_paths,
        waypoint_colvars_paths=waypoint_colvars_paths,
        topologies=topologies,
        waypoint_topologies=transition_waypoints if waypoints_data else None,
        reference_topology=reference_topology,
        output_folder=os.path.join(output_folder, "filter_features"),
        device=dev,
    )
    filtered_features = read_features_list(output_features_path)

    frames_per_sample = configuration["compute_features"]["plumed_settings"][
        "traj_stride"
    ]

    # STEP 4: Train colvars
    trained_cvs_data = train_colvars(
        configuration=configuration["train_colvars"],
        train_colvars_paths=traj_colvars_paths,
        train_topologies=topologies,
        trajectory_names=trajectory_names,
        val_colvars_paths=validation_colvars_paths,
        val_topologies=val_tops,
        sup_topologies=supplementary_tops,
        sup_traj_names=sup_trajectory_names,
        waypoint_structures=transition_waypoints if waypoints_data else None,
        reference_topology=reference_topology,
        features_list=filtered_features,
        dimension=dimension,
        cvs=cvs,
        frames_per_sample=frames_per_sample,
        output_folder=os.path.join(output_folder, "train_colvars"),
        device=dev,
    )

    # A CV family that produced no valid model (e.g. every deep-CV try
    # failed) is dropped with an error, so the remaining CVs still get
    # projected and clustered.
    failed_cvs = [
        cv
        for cv, data in trained_cvs_data.items()
        if not (
            os.path.exists(data["model_path"])
            and all(os.path.exists(p) for p in data["traj_paths"])
        )
    ]
    for cv in failed_cvs:
        logger.error(
            "CV %s produced no valid model/projection — skipping its "
            "downstream projection and clustering steps.",
            cv,
        )
        trained_cvs_data.pop(cv)

    # STEP 5: Supplementary trajectory projection
    sup_cvs_data: Dict = {}
    if supplementary_trajs and trained_cvs_data:
        sup_cvs_data = traj_projection(
            configuration=configuration["traj_projection"],
            colvars_paths=supplementary_colvars_paths,
            topologies=supplementary_tops,
            trajectory_names=sup_trajectory_names,
            model_paths=[
                trained_cvs_data[cv]["model_path"] for cv in trained_cvs_data
            ],
            model_traj_paths=[
                trained_cvs_data[cv]["traj_paths"] for cv in trained_cvs_data
            ],
            output_folder=os.path.join(output_folder, "traj_projection"),
            device=dev,
        )

    # STEP 6: Trajectory clustering per CV
    for cv in trained_cvs_data:
        logger.info("Clustering trajectories in CV space: %s", cv)
        traj_cluster(
            configuration=configuration["traj_cluster"],
            cv_traj_paths=trained_cvs_data[cv]["traj_paths"],
            trajectories=trajectories,
            topologies=topologies,
            sup_cv_traj_paths=sup_cvs_data.get(cv, {}).get("traj_paths", None),
            sup_trajectories=supplementary_trajs,
            sup_topologies=supplementary_tops,
            frames_per_sample=frames_per_sample,
            output_folder=os.path.join(output_folder, "traj_cluster", cv),
            device=dev,
        )

    elapsed = time.time() - start_time
    logger.info(
        "Total elapsed time: %s", time.strftime("%H h %M min %S s", time.gmtime(elapsed))
    )
