"""traj_projection tool and workflow: project colvars onto saved CV models.

The port of the JAX package's tools/traj_projection.py: each model.zip is
loaded on the tool's device, the colvars files are projected, and each
trajectory's projection is written to <cv>/<name>/projected_trajectory.csv
(4 decimals). With the models' own training projections given, the FES of
those is drawn with the new projections on top, where
`figures.fes.compute` asks for it; the 2-D scatter is drawn where
`figures.traj_projection.plot` asks for it (the JAX package draws it
whatever that flag says). A CV whose CSVs all exist is skipped.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from deep_cartograph_torch.config.schemas import traj_projection_config
from deep_cartograph_torch.cv.base import CVCalculator
from deep_cartograph_torch.io.colvars import create_dataframe_from_files
from deep_cartograph_torch.tools.train_colvars import create_fes_plots, write_projection
from deep_cartograph_torch.utils.common import files_exist, validate_configuration
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


class TrajProjectionWorkflow:
    def __init__(
        self,
        configuration: Dict,
        colvars_paths: List[str],
        topologies: List[str],
        trajectory_names: List[str],
        model_paths: List[str],
        model_traj_paths: Optional[List[List[str]]] = None,
        output_folder: str = "traj_projection",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.parent_output_folder = output_folder
        self.configuration = validate_configuration(
            configuration, traj_projection_config, output_folder
        )
        self.figures_configuration = self.configuration["figures"]
        self.colvars_paths = colvars_paths
        self.topologies = topologies
        self.trajectory_names = trajectory_names
        self.model_paths = model_paths
        self.model_traj_paths = model_traj_paths
        self.cv_name: Optional[str] = None
        self.cv_dimension: Optional[int] = None
        self.cv_labels: Optional[List[str]] = None
        self._validate_files()

    def _validate_files(self) -> None:
        for path in self.colvars_paths:
            if not files_exist(path):
                raise FileNotFoundError(f"Colvars file {path} does not exist.")
        if self.topologies:
            for path in self.topologies:
                if not files_exist(path):
                    raise FileNotFoundError(f"Topology file {path} does not exist.")
            if len(self.topologies) != len(self.colvars_paths):
                raise ValueError(
                    "Number of topologies must match number of colvars files."
                )
        for path in self.model_paths or []:
            if not files_exist(path):
                raise FileNotFoundError(f"CV model file {path} does not exist.")

    def run(self) -> Dict[str, Dict]:
        output_cv_data: Dict[str, Dict] = {}
        logger.info("Starting traj_projection workflow...")

        for model_index, model_path in enumerate(self.model_paths):
            cv_calculator = CVCalculator.load(
                model_path=model_path, output_path=self.parent_output_folder,
                device=self.device,
            )
            self.cv_name = cv_calculator.cv_name
            self.cv_dimension = cv_calculator.cv_dimension
            self.cv_labels = cv_calculator.cv_labels
            cv_output_folder = os.path.join(self.parent_output_folder, self.cv_name)
            os.makedirs(cv_output_folder, exist_ok=True)

            traj_paths = [
                os.path.join(cv_output_folder, name, "projected_trajectory.csv")
                for name in self.trajectory_names
            ]
            output_cv_data[self.cv_name] = {"traj_paths": traj_paths}
            if files_exist(*traj_paths, verbose=False):
                logger.info(
                    "Projected trajectory files for CV %s already exist. "
                    "Skipping projection...",
                    self.cv_name,
                )
                continue

            projection, _ = cv_calculator.project_colvars(
                colvars_paths=self.colvars_paths, topology_paths=self.topologies
            )
            labels = np.asarray(cv_calculator.projection_data_labels)
            per_traj = [projection[labels == i] for i in range(len(self.colvars_paths))]

            for index, projection_i in enumerate(per_traj):
                traj_output_folder = os.path.join(
                    cv_output_folder, self.trajectory_names[index]
                )
                os.makedirs(traj_output_folder, exist_ok=True)
                write_projection(
                    projection_i, self.cv_labels, traj_output_folder, 1,
                    self.figures_configuration["traj_projection"],
                )

            if self.model_traj_paths is not None:
                main_data = create_dataframe_from_files(
                    self.model_traj_paths[model_index]
                )[0]
                create_fes_plots(
                    main_data, self.cv_labels, self.cv_name,
                    self.figures_configuration["fes"],
                    os.path.join(cv_output_folder, "fes"),
                    sup_data=per_traj,
                    sup_data_labels=self.trajectory_names,
                    device=self.device,
                )
        return output_cv_data


@traced("traj_projection")
def traj_projection(
    configuration: Dict,
    colvars_paths: List[str],
    topologies: Optional[List[str]] = None,
    trajectory_names: Optional[List[str]] = None,
    model_paths: Optional[List[str]] = None,
    model_traj_paths: Optional[List[List[str]]] = None,
    output_folder: str = "traj_projection",
    device: DeviceLike = None,
) -> Dict:
    """Project colvars onto saved CV models; returns, per CV, the paths of
    the projected trajectories.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("=====================")
    logger.info("Trajectory projection")
    logger.info("=====================")
    start_time = time.time()
    os.makedirs(output_folder, exist_ok=True)
    if trajectory_names is None:
        trajectory_names = [Path(p).stem for p in colvars_paths]

    workflow = TrajProjectionWorkflow(
        configuration=configuration,
        colvars_paths=colvars_paths,
        topologies=topologies,
        trajectory_names=trajectory_names,
        model_paths=model_paths,
        model_traj_paths=model_traj_paths,
        output_folder=output_folder,
        device=device,
    )
    result = workflow.run()
    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Trajectory projection): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return result
