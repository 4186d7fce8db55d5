"""train_colvars tool and workflow: train or compute every requested CV.

The port of the JAX package's tools/train_colvars.py, with the same output
tree per CV (model.zip, training/, sensitivity_analysis/, and per
trajectory traj_data/<name>/{projected_trajectory.csv, plumed_inputs/,
fes/}), the same per-CV restart and the same merge of each CV's block over
`common`. The calculators run on the tool's device.

Figures are drawn only where the configuration asks: the FES where
`figures.fes.compute` is true (the surface is computed first, through K2
for a large 2-D grid), the 2-D scatter where `figures.traj_projection.plot`
is true (the JAX package draws it whatever that flag says).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from deep_cartograph_torch.config.schemas import train_colvars_config
from deep_cartograph_torch.cv import cv_calculators_map
from deep_cartograph_torch.fes.kde import plot_fes
from deep_cartograph_torch.figures.plots import gradient_scatter_plot
from deep_cartograph_torch.utils.common import (
    files_exist,
    merge_configurations,
    validate_configuration,
    write_csv,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


def create_fes_plots(
    data: np.ndarray,
    cv_labels: List[str],
    cv_type: str,
    settings: Dict,
    output_folder: str,
    sup_data: Optional[List[np.ndarray]] = None,
    sup_data_labels: Optional[List[str]] = None,
    device: DeviceLike = None,
) -> None:
    """The FES of each CV component (100 blocks for the error) and of each
    pair of components, in fes_<cv>_<i>[_<j>] folders (made, and left
    empty, when `settings["compute"]` is false)."""
    dimension = data.shape[1]
    for dim in range(dimension):
        folder = os.path.join(output_folder, f"fes_{cv_type}_{dim + 1}")
        os.makedirs(folder, exist_ok=True)
        plot_fes(
            data=data[:, dim],
            cv_labels=[cv_labels[dim]],
            settings=settings,
            output_path=folder,
            num_blocks=100,
            sup_data=[x[:, dim] for x in sup_data] if sup_data else None,
            sup_data_labels=sup_data_labels,
            device=device,
        )
    for i in range(dimension - 1):
        for j in range(i + 1, dimension):
            folder = os.path.join(output_folder, f"fes_{cv_type}_{i + 1}_{j + 1}")
            os.makedirs(folder, exist_ok=True)
            plot_fes(
                data=data[:, [i, j]],
                cv_labels=[cv_labels[i], cv_labels[j]],
                settings=settings,
                output_path=folder,
                num_blocks=1,
                sup_data=[x[:, [i, j]] for x in sup_data] if sup_data else None,
                sup_data_labels=sup_data_labels,
                device=device,
            )


def write_projection(
    projection: np.ndarray,
    cv_labels: List[str],
    traj_output_folder: str,
    frames_per_sample: int,
    plot_settings: Dict,
) -> None:
    """projected_trajectory.csv (values at 4 decimals) and, where
    `plot_settings["plot"]` asks for it, the 2-D scatter colored by frame
    (trajectory.png)."""
    if len(cv_labels) == 2 and plot_settings.get("plot", True):
        data = {label: projection[:, i] for i, label in enumerate(cv_labels)}
        data["frame"] = np.arange(len(projection)) * frames_per_sample
        gradient_scatter_plot(
            data=data,
            column_labels=cv_labels,
            color_label="frame",
            settings=plot_settings,
            file_path=os.path.join(traj_output_folder, "trajectory.png"),
        )
    write_csv(
        os.path.join(traj_output_folder, "projected_trajectory.csv"),
        {label: projection[:, i] for i, label in enumerate(cv_labels)},
        float_format="%.4f",
    )


class TrainColvarsWorkflow:
    """Trains each CV, then writes its projections, PLUMED files and
    figures per trajectory."""

    def __init__(
        self,
        configuration: Dict,
        train_colvars_paths: List[str],
        train_topology_paths: Optional[List[str]] = None,
        trajectory_names: Optional[List[str]] = None,
        val_colvars_paths: Optional[List[str]] = None,
        val_topology_paths: Optional[List[str]] = None,
        sup_topology_paths: Optional[List[str]] = None,
        sup_names: Optional[List[str]] = None,
        waypoint_structures: Optional[List[str]] = None,
        ref_topology_path: Optional[str] = None,
        features_list: Optional[List[str]] = None,
        cv_dimension: Optional[int] = None,
        cvs: Optional[List[str]] = None,
        frames_per_sample: Optional[int] = 1,
        output_folder: str = "train_colvars",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.output_folder = output_folder
        self.configuration = validate_configuration(
            configuration, train_colvars_config, output_folder
        )
        self.figures_configuration = self.configuration["figures"]

        self.train_colvars_paths = train_colvars_paths
        self.train_topology_paths = train_topology_paths
        self.trajectory_names = trajectory_names or [
            Path(f).stem for f in train_colvars_paths
        ]
        self.val_colvars_paths = val_colvars_paths
        self.val_topology_paths = val_topology_paths
        self.sup_topology_paths = sup_topology_paths
        self.sup_names = sup_names
        self.waypoint_structures = waypoint_structures
        self.ref_topology_path = ref_topology_path
        self.features_list = features_list
        if self.train_topology_paths and self.ref_topology_path is None:
            self.ref_topology_path = self.train_topology_paths[0]
        self.frames_per_sample = frames_per_sample or 1

        self._validate_files()

        self.cvs_list = cvs if cvs else self.configuration["cvs"]
        self.cv_dimension = cv_dimension
        self.cv_labels: Optional[List[str]] = None
        self.cv_type: Optional[str] = None

    def _validate_files(self) -> None:
        for path in self.train_colvars_paths:
            if not files_exist(path):
                raise FileNotFoundError(f"Colvars file {path} does not exist.")
        if self.train_topology_paths:
            for path in self.train_topology_paths:
                if not files_exist(path):
                    raise FileNotFoundError(f"Topology file {path} does not exist.")
            if self.ref_topology_path and not files_exist(self.ref_topology_path):
                raise FileNotFoundError(
                    f"Reference topology file {self.ref_topology_path} does not exist."
                )

    # -- restart bookkeeping ----------------------------------------------
    def get_output_cv_model_path(self, cv_name: str) -> str:
        return os.path.join(self.output_folder, cv_name, "model.zip")

    def get_output_cv_trajectories(self, cv_name: str) -> List[str]:
        traj_data = os.path.join(self.output_folder, cv_name, "traj_data")
        return [
            os.path.join(traj_data, name, "projected_trajectory.csv")
            for name in self.trajectory_names
        ]

    def cv_finished(self, cv_name: str) -> bool:
        return files_exist(
            self.get_output_cv_model_path(cv_name), verbose=False
        ) and files_exist(*self.get_output_cv_trajectories(cv_name), verbose=False)

    def workflow_finished(self) -> bool:
        return all(self.cv_finished(cv_name) for cv_name in self.cvs_list)

    def get_output_paths(self) -> Dict:
        return {
            cv_name: {
                "output_folder": os.path.join(self.output_folder, cv_name),
                "model_path": self.get_output_cv_model_path(cv_name),
                "traj_paths": self.get_output_cv_trajectories(cv_name),
            }
            for cv_name in self.cvs_list
        }

    # -- main ---------------------------------------------------------------
    def run(self) -> Dict:
        if self.workflow_finished():
            logger.info(
                "Skipping collective variable computation: all CVs already "
                "computed. Delete the train_colvars folder or drop -restart "
                "to recompute."
            )
            return self.get_output_paths()

        logger.info("Collective variables to compute: %s", self.cvs_list)

        for cv_name in self.cvs_list:
            cv_output_folder = os.path.join(self.output_folder, cv_name)
            if self.cv_finished(cv_name):
                logger.info(
                    "Skipping %s: model and projections already exist.", cv_name
                )
                continue
            merged = merge_configurations(
                self.configuration["common"], self.configuration.get(cv_name, {})
            )
            cv_calculator = cv_calculators_map[cv_name](
                configuration=merged, output_path=self.output_folder,
                device=self.device,
            )
            cv_calculator.load_training_data(
                train_colvars_paths=self.train_colvars_paths,
                train_topology_paths=self.train_topology_paths,
                ref_topology_path=self.ref_topology_path,
                features_list=self.features_list,
            )
            if self.val_colvars_paths:
                cv_calculator.load_validation_data(
                    val_colvars_paths=self.val_colvars_paths,
                    val_topology_paths=self.val_topology_paths,
                    ref_topology_path=self.ref_topology_path,
                    features_list=self.features_list,
                )

            result = cv_calculator.run(self.cv_dimension)
            self.cv_dimension = cv_calculator.get_cv_dimension()
            self.cv_labels = cv_calculator.get_labels()
            self.cv_type = cv_calculator.get_cv_type()

            if result is None:
                logger.warning(
                    "Projected colvars dataframe is empty for %s. Skipping.",
                    cv_name,
                )
                continue

            projection, _ = result
            labels = np.asarray(cv_calculator.training_data_labels)
            for traj_index in range(len(self.train_colvars_paths)):
                topology = (
                    self.train_topology_paths[traj_index]
                    if self.train_topology_paths
                    else None
                )
                traj_name = self.trajectory_names[traj_index]
                logger.info("Processing trajectory: %s", traj_name)
                traj_output_folder = os.path.join(
                    cv_output_folder, "traj_data", traj_name
                )
                os.makedirs(traj_output_folder, exist_ok=True)

                plumed_folder = os.path.join(traj_output_folder, "plumed_inputs")
                os.makedirs(plumed_folder, exist_ok=True)
                cv_calculator.write_plumed_files(
                    topology, plumed_folder, self.waypoint_structures
                )

                projection_i = projection[labels == traj_index]
                create_fes_plots(
                    projection_i, self.cv_labels, self.cv_type,
                    self.figures_configuration["fes"],
                    os.path.join(traj_output_folder, "fes"), device=self.device,
                )
                write_projection(
                    projection_i, self.cv_labels, traj_output_folder,
                    self.frames_per_sample,
                    self.figures_configuration["traj_projection"],
                )

            if self.sup_topology_paths is not None:
                for sup_index, sup_topology in enumerate(self.sup_topology_paths):
                    sup_name = (
                        self.sup_names[sup_index]
                        if self.sup_names
                        else Path(sup_topology).stem
                    )
                    sup_folder = os.path.join(
                        cv_output_folder, "traj_data", sup_name, "plumed_inputs"
                    )
                    os.makedirs(sup_folder, exist_ok=True)
                    cv_calculator.write_plumed_files(
                        sup_topology, sup_folder, self.waypoint_structures
                    )

        return self.get_output_paths()


@traced("train_colvars")
def train_colvars(
    configuration: Dict,
    train_colvars_paths: List[str],
    train_topologies: Optional[List[str]] = None,
    trajectory_names: Optional[List[str]] = None,
    val_colvars_paths: Optional[List[str]] = None,
    val_topologies: Optional[List[str]] = None,
    sup_topologies: Optional[List[str]] = None,
    sup_traj_names: Optional[List[str]] = None,
    waypoint_structures: Optional[List[str]] = None,
    reference_topology: Optional[str] = None,
    features_list: Optional[List[str]] = None,
    dimension: Optional[int] = None,
    cvs: Optional[List[str]] = None,
    frames_per_sample: Optional[int] = 1,
    output_folder: str = "train_colvars",
    device: DeviceLike = None,
) -> Dict:
    """Train or compute every requested CV; returns, per CV, its output
    folder, model path and projected trajectory paths.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("===================")
    logger.info("Training of colvars")
    logger.info("===================")
    start_time = time.time()
    os.makedirs(output_folder, exist_ok=True)

    workflow = TrainColvarsWorkflow(
        configuration=configuration,
        train_colvars_paths=train_colvars_paths,
        train_topology_paths=train_topologies,
        trajectory_names=trajectory_names,
        val_colvars_paths=val_colvars_paths,
        val_topology_paths=val_topologies,
        sup_topology_paths=sup_topologies,
        sup_names=sup_traj_names,
        waypoint_structures=waypoint_structures,
        ref_topology_path=reference_topology,
        features_list=features_list,
        cv_dimension=dimension,
        cvs=cvs,
        frames_per_sample=frames_per_sample,
        output_folder=output_folder,
        device=device,
    )
    result = workflow.run()

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Train colvars): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return result
