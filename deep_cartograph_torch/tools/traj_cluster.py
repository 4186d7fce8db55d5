"""traj_cluster tool and workflow: cluster trajectories in CV space.

The port of the JAX package's tools/traj_cluster.py: the clustering scan
over the search interval on the tool's device, the centroid of each
cluster marked and written as a PDB, the cluster ensembles written as
trajectories, supplementary frames assigned to the cluster of their
nearest clustered frame, and per trajectory a projected_trajectory.csv
with the columns of the JAX tool (the CVs, traj_label, cluster, centroid,
frame; supplementary: the CVs, traj_label, cluster). The CV CSVs are read
and written without pandas.

The size bars and the 2-D scatter plots are drawn only where
`figures.plot` asks for them (the JAX package draws them whatever it says).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from deep_cartograph_torch.cluster import (
    assign_nearest_neighbor,
    find_centroids,
    optimize_clustering,
)
from deep_cartograph_torch.config.schemas import traj_cluster_config
from deep_cartograph_torch.figures.plots import (
    clusters_scatter_plot,
    generate_colors,
    plot_clusters_size,
)
from deep_cartograph_torch.io.traj import extract_frames_to_pdb, extract_frames_to_traj
from deep_cartograph_torch.utils.common import (
    files_exist,
    read_csv,
    validate_configuration,
    write_csv,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


class TrajClusterWorkflow:
    def __init__(
        self,
        configuration: Dict,
        cv_traj_paths: List[str],
        trajectories: Optional[List[str]] = None,
        topologies: Optional[List[str]] = None,
        sup_cv_traj_paths: Optional[List[str]] = None,
        sup_trajectories: Optional[List[str]] = None,
        sup_topologies: Optional[List[str]] = None,
        frames_per_sample: Optional[int] = 1,
        output_folder: str = "traj_cluster",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.output_folder = output_folder
        self.configuration = validate_configuration(
            configuration, traj_cluster_config, output_folder
        )
        self.figures_configuration = self.configuration["figures"]
        self.plot = self.figures_configuration["plot"]
        self.extract_centroids_condition = self.configuration[
            "output_structures"
        ] in ("centroids", "all")
        self.extract_ensembles_condition = (
            self.configuration["output_structures"] == "all"
        )
        self.cv_traj_paths = cv_traj_paths
        self.trajectories = trajectories
        self.topologies = topologies
        self.sup_cv_traj_paths = sup_cv_traj_paths
        self.sup_trajectories = sup_trajectories
        self.sup_topologies = sup_topologies
        self.frames_per_sample = frames_per_sample or 1
        self.cv_dimension: Optional[int] = None
        self.cv_labels: Optional[List[str]] = None
        # with clustering off, missing inputs are no error
        if self.configuration.get("run", True):
            self._validate_files()

    def _validate_files(self) -> None:
        for path in self.cv_traj_paths:
            if not files_exist(path):
                raise FileNotFoundError(f"CV trajectory {path} does not exist.")
        if self.trajectories:
            if not self.topologies:
                raise ValueError("Trajectory files provided but no topology file.")
            if len(self.trajectories) != len(self.topologies):
                raise ValueError(
                    "Different number of trajectory and topology files provided."
                )
            if len(self.trajectories) != len(self.cv_traj_paths):
                raise ValueError(
                    "Different number of trajectory and colvars files provided."
                )
        if self.sup_cv_traj_paths and self.sup_trajectories:
            if not self.sup_topologies:
                raise ValueError(
                    "Supplementary trajectory files provided but no topology file."
                )

    @staticmethod
    def read_cv_traj_data(paths: List[str]) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """The CV CSVs stacked: (CV labels, float64 values, file index of
        each row)."""
        names, blocks = None, []
        for path in paths:
            cols, data = read_csv(path)
            names = names or cols
            blocks.append(data)
        labels = np.repeat(np.arange(len(blocks)), [len(b) for b in blocks])
        return names, np.concatenate(blocks, axis=0), labels

    def extract_centroids(self, traj_label, frame, cluster, centroid) -> None:
        logger.info("Extracting centroids from the trajectories...")
        centroids_folder = os.path.join(self.output_folder, "centroids")
        os.makedirs(centroids_folder, exist_ok=True)
        for row in np.nonzero(centroid)[0]:
            traj_index = int(traj_label[row])
            extract_frames_to_pdb(
                self.trajectories[traj_index],
                self.topologies[traj_index],
                int(frame[row]),
                os.path.join(centroids_folder, f"cluster_{cluster[row]}.pdb"),
            )

    def extract_cluster_ensembles(
        self, cluster: np.ndarray, frame: np.ndarray, output_folder: str,
        traj_index: int,
    ) -> None:
        """Per-cluster sub-trajectories of ONE trajectory (its rows only),
        clusters in order of first appearance."""
        logger.info("Extracting cluster ensembles from the trajectories...")
        _, first = np.unique(cluster, return_index=True)
        for cluster_label in cluster[np.sort(first)]:
            extract_frames_to_traj(
                self.trajectories[traj_index],
                self.topologies[traj_index],
                frame[cluster == cluster_label].tolist(),
                os.path.join(output_folder, f"cluster_{cluster_label}.xtc"),
            )

    def _columns(self, values: np.ndarray, rows: np.ndarray, **extra) -> Dict:
        columns = {label: values[rows, i] for i, label in enumerate(self.cv_labels)}
        columns.update({k: v[rows] for k, v in extra.items()})
        return columns

    def run(self) -> Dict[str, List[str]]:
        if self.configuration["run"] is False:
            logger.info("traj_cluster workflow set to not run. Exiting...")
            return {}

        output_paths: Dict[str, List[str]] = {}
        logger.info("Starting traj_cluster workflow...")

        self.cv_labels, values, traj_label = self.read_cv_traj_data(self.cv_traj_paths)
        self.cv_dimension = len(self.cv_labels)

        cluster, centroids = optimize_clustering(
            values, dict(self.configuration), device=self.device
        )
        cluster = np.asarray(cluster)
        centroid = find_centroids(values, centroids, device=self.device)

        num_clusters = len(np.unique(cluster))
        cluster_colors = (
            generate_colors(num_clusters, self.figures_configuration["cmap"])
            if self.plot else None
        )

        frame = np.concatenate([
            np.arange(np.count_nonzero(traj_label == i)) * self.frames_per_sample
            for i in range(len(self.cv_traj_paths))
        ])

        if self.plot:
            plot_clusters_size(cluster, cluster_colors, self.output_folder)

        if self.extract_centroids_condition:
            if self.trajectories and self.topologies:
                self.extract_centroids(traj_label, frame, cluster, centroid)
            else:
                logger.warning(
                    "Trajectory and/or topology files not provided. Skipping "
                    "extraction of centroids."
                )

        for traj_index in range(len(self.cv_traj_paths)):
            traj_name = (
                Path(self.trajectories[traj_index]).stem
                if self.trajectories
                else f"traj_{traj_index}"
            )
            traj_output_folder = os.path.join(self.output_folder, traj_name)
            os.makedirs(traj_output_folder, exist_ok=True)
            rows = traj_label == traj_index
            traj_columns = self._columns(
                values, rows, traj_label=traj_label, cluster=cluster,
                centroid=centroid, frame=frame,
            )
            projected_path = os.path.join(traj_output_folder, "projected_trajectory.csv")
            write_csv(projected_path, traj_columns)
            output_paths[traj_name] = [projected_path]

            if self.cv_dimension == 2 and self.plot:
                clusters_scatter_plot(
                    data=traj_columns,
                    column_labels=self.cv_labels,
                    cluster_label="cluster",
                    settings=self.figures_configuration,
                    file_path=os.path.join(traj_output_folder, "trajectory_clustered.png"),
                    cluster_colors=cluster_colors,
                )
            if self.extract_ensembles_condition:
                if self.trajectories and self.topologies:
                    self.extract_cluster_ensembles(
                        cluster[rows], frame[rows], traj_output_folder, traj_index
                    )
                else:
                    logger.warning(
                        "Trajectory and/or topology files not provided. "
                        "Skipping extraction of cluster ensembles."
                    )

        if self.sup_cv_traj_paths:
            logger.info("Assigning clusters to supplementary CV trajectories...")
            sup_names, sup_values, sup_label = self.read_cv_traj_data(
                self.sup_cv_traj_paths
            )
            if len(sup_names) != self.cv_dimension:
                raise ValueError(
                    "Dimensionality of supplementary CV data does not match."
                )
            nearest = assign_nearest_neighbor(sup_values, values, device=self.device)
            sup_cluster = cluster[nearest]
            for traj_index in range(len(self.sup_cv_traj_paths)):
                traj_name = (
                    f"sup_{Path(self.sup_trajectories[traj_index]).stem}"
                    if self.sup_trajectories
                    else f"sup_traj_{traj_index}"
                )
                traj_output_folder = os.path.join(self.output_folder, traj_name)
                os.makedirs(traj_output_folder, exist_ok=True)
                traj_columns = self._columns(
                    sup_values, sup_label == traj_index, traj_label=sup_label,
                    cluster=sup_cluster,
                )
                projected_path = os.path.join(
                    traj_output_folder, "projected_trajectory.csv"
                )
                write_csv(projected_path, traj_columns)
                output_paths[traj_name] = [projected_path]
                if self.cv_dimension == 2 and self.plot:
                    clusters_scatter_plot(
                        data=traj_columns,
                        column_labels=self.cv_labels,
                        cluster_label="cluster",
                        settings=self.figures_configuration,
                        file_path=os.path.join(
                            traj_output_folder, "trajectory_clustered.png"
                        ),
                        cluster_colors=cluster_colors,
                    )
        return output_paths


@traced("traj_cluster")
def traj_cluster(
    configuration: Dict,
    cv_traj_paths: List[str],
    trajectories: Optional[List[str]] = None,
    topologies: Optional[List[str]] = None,
    sup_cv_traj_paths: Optional[List[str]] = None,
    sup_trajectories: Optional[List[str]] = None,
    sup_topologies: Optional[List[str]] = None,
    frames_per_sample: Optional[int] = 1,
    output_folder: str = "traj_cluster",
    device: DeviceLike = None,
) -> Dict:
    """Cluster CV-space trajectories; returns the projected CSV paths per
    trajectory.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("=====================")
    logger.info("Trajectory clustering")
    logger.info("=====================")
    start_time = time.time()
    os.makedirs(output_folder, exist_ok=True)
    workflow = TrajClusterWorkflow(
        configuration=configuration,
        cv_traj_paths=cv_traj_paths,
        trajectories=trajectories,
        topologies=topologies,
        sup_cv_traj_paths=sup_cv_traj_paths,
        sup_trajectories=sup_trajectories,
        sup_topologies=sup_topologies,
        frames_per_sample=frames_per_sample,
        output_folder=output_folder,
        device=device,
    )
    result = workflow.run()
    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Trajectory clustering): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return result
