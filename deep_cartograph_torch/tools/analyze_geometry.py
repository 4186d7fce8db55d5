"""analyze_geometry tool: RMSD, RMSF and dRMSD of trajectories, as CSVs and
line plots.

The port of the JAX package's tools/analyze_geometry.py; the geometry runs
on the tool's device (`geom/analysis.py`, dRMSD's pair distances through
K1). The schema has no flag for the line plots: they are drawn where
matplotlib is installed, and otherwise a warning says they were not.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from deep_cartograph_torch.config.schemas import analyze_geometry_config
from deep_cartograph_torch.figures.plots import plot_data
from deep_cartograph_torch.geom.analysis import RMSD, RMSF, dRMSD
from deep_cartograph_torch.utils.common import (
    package_is_installed,
    save_data,
    validate_configuration,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")


@traced("analyze_geometry")
def analyze_geometry(
    configuration: Dict,
    trajectories: List[str],
    topologies: List[str],
    ref_topologies: Optional[List[str]] = None,
    output_folder: str = "analyze_geometry",
    device: DeviceLike = None,
) -> None:
    """Each configured analysis of each trajectory: <name>/<key>.csv and
    <name>_<category>.png in `output_folder`.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    logger.info("================")
    logger.info("Analyze geometry")
    logger.info("================")
    start_time = time.time()
    dev = resolve_device(device)
    os.makedirs(output_folder, exist_ok=True)
    configuration = validate_configuration(
        configuration, analyze_geometry_config, output_folder
    )
    if not configuration["run"]:
        logger.info("Skipping Analyze Geometry step.")
        return
    draw = package_is_installed("matplotlib")

    dt_per_frame = float(configuration["dt_per_frame"]) * 1e-3  # ps -> ns

    for category, analyses in configuration["analysis"].items():
        if not analyses:
            continue
        logger.info("Analyzing %s...", category)
        for name, params in analyses.items():
            logger.info(" - %s", name)
            y_label = f"{category} (A)"
            y_data: Dict[str, np.ndarray] = {}
            x_data: Dict[str, np.ndarray] = {}
            x_label = "Time (ns)"

            for trajectory, topology in zip(trajectories, topologies):
                traj_name = Path(trajectory).stem
                selection = params["selection"]
                fit_selection = params.get("fit_selection")
                selection_stride = params.get("selection_stride", 1)

                if category == "RMSD":
                    for ref_pdb in ref_topologies if ref_topologies else [None]:
                        key = traj_name + (
                            f"_to_{Path(ref_pdb).stem}" if ref_pdb else "_first_frame"
                        )
                        y_data[key] = RMSD(trajectory, topology, selection,
                                           fit_selection, ref_pdb, device=dev)
                        x_data[key] = np.arange(len(y_data[key])) * dt_per_frame
                elif category == "RMSF":
                    y_data[traj_name], x_data[traj_name] = RMSF(
                        trajectory, topology, selection, fit_selection, device=dev
                    )
                    x_label = "Residue"
                elif category == "dRMSD":
                    for ref_pdb in ref_topologies if ref_topologies else [topology]:
                        key = f"{traj_name}_to_{Path(ref_pdb).stem}"
                        y_data[key] = dRMSD(
                            trajectory,
                            topology,
                            selection,
                            selection_stride,
                            ref_pdb,
                            os.path.join(output_folder, f"dRMSD_temp_{key}"),
                            device=dev,
                        )
                        x_data[key] = np.arange(len(y_data[key])) * dt_per_frame
                else:
                    logger.error("Unknown analysis category: %s", category)
                    continue

            figure_path = os.path.join(output_folder, f"{name}_{category}.png")
            if draw:
                plot_data(y_data, x_data, params["title"], y_label, x_label,
                          figure_path)
            else:
                logger.warning("matplotlib is not installed: %s not drawn.",
                               figure_path)
            # one folder per analysis: two analyses of one category share
            # their data keys
            save_data(y_data, x_data, y_label, x_label,
                      os.path.join(output_folder, name))

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Analyze geometry): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
