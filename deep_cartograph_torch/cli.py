"""Command-line interface of the pipeline, with the JAX package's flags
(`deep_carto_torch`, or `python -m deep_cartograph_torch.cli`). It runs on
the CUDA device and raises without one; the configuration file may be
YAML (read with PyYAML) or JSON (read without it)."""

from __future__ import annotations

import argparse
import logging
import os
import sys


def set_logger(verbose: bool, log_path: str) -> None:
    """File and console logging of the `deep_cartograph_torch` loggers from
    the INI pair in log_config/ (%(log_path)s substituted), or set up here
    when the INI files are missing."""
    import logging.config

    package_dir = os.path.dirname(os.path.abspath(__file__))
    ini = os.path.join(
        package_dir,
        "log_config",
        "debug_configuration.ini" if verbose else "info_configuration.ini",
    )
    if os.path.exists(ini):
        logging.config.fileConfig(
            ini, defaults={"log_path": log_path}, disable_existing_loggers=False
        )
        root = logging.getLogger("deep_cartograph_torch")
    else:
        level = logging.DEBUG if verbose else logging.INFO
        root = logging.getLogger("deep_cartograph_torch")
        root.setLevel(level)
        root.handlers.clear()
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        )
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        root.addHandler(console)
        file_handler = logging.FileHandler(log_path)
        file_handler.setFormatter(fmt)
        root.addHandler(file_handler)
    root.info(
        "Deep Cartograph (PyTorch): package for analyzing MD simulations "
        "using collective variables."
    )


def parse_arguments() -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="Deep Cartograph",
        description="Map trajectories onto Collective Variables (PyTorch, CUDA).",
    )
    parser.add_argument(
        "-conf", "-configuration", dest="configuration_path", type=str,
        required=True, help="Path to configuration file (.yml or .json).",
    )
    parser.add_argument(
        "-traj_data", dest="trajectory_data", required=False, nargs="+",
        help="Trajectory paths or folder with trajectories used to train CVs.",
    )
    parser.add_argument(
        "-top_data", dest="topology_data", required=False, nargs="+",
        help="Topology paths or folder with topologies for the trajectories.",
    )
    parser.add_argument(
        "-val_traj_data", dest="validation_trajectory_data", required=False,
        nargs="+", help="Validation trajectory paths or folder.",
    )
    parser.add_argument(
        "-val_top_data", dest="validation_topology_data", required=False,
        nargs="+", help="Validation topology paths or folder.",
    )
    parser.add_argument(
        "-seed_traj_data", dest="seed_trajectory_data", required=False,
        nargs="+", help="Seed trajectory paths to augment by interpolation.",
    )
    parser.add_argument(
        "-seed_top_data", dest="seed_topology_data", required=False, nargs="+",
        help="Seed topology paths or folder.",
    )
    parser.add_argument(
        "-sup_traj_data", dest="supplementary_traj_data", required=False,
        nargs="+", help="Supplementary trajectory paths (projected only).",
    )
    parser.add_argument(
        "-sup_top_data", dest="supplementary_top_data", required=False,
        nargs="+", help="Supplementary topology paths or folder.",
    )
    parser.add_argument(
        "-ref_top", dest="reference_topology", required=False,
        help="Reference topology used to find features from user selections.",
    )
    parser.add_argument(
        "-waypoints_data", dest="waypoints_data", type=str, required=False,
        nargs="+", help="Folder with intermediate transition conformations.",
    )
    parser.add_argument(
        "-restart", dest="restart", action="store_true", default=False,
        help="Restart workflow from the last finished step.",
    )
    parser.add_argument(
        "-dim", "-dimension", dest="dimension", type=int, required=False,
        help="CV dimension; overrides the configuration.",
    )
    parser.add_argument(
        "-cvs", nargs="+", required=False,
        help="CVs to train (pca, ae, tica, htica, vae, deep_tica, umap).",
    )
    parser.add_argument(
        "-out", "-output", dest="output_folder", required=False,
        help="Path to the output folder.",
    )
    parser.add_argument(
        "-v", "-verbose", dest="verbose", action="store_true", default=False,
        help="Set logging level to DEBUG.",
    )
    return parser.parse_args()


def main() -> None:
    from deep_cartograph_torch.pipeline import deep_cartograph
    from deep_cartograph_torch.utils.common import (
        get_unique_path,
        read_configuration,
    )

    args = parse_arguments()
    output_folder = args.output_folder if args.output_folder else "deep_cartograph"
    if not args.restart:
        output_folder = get_unique_path(output_folder)
    os.makedirs(output_folder, exist_ok=True)
    set_logger(
        verbose=args.verbose,
        log_path=os.path.join(output_folder, "deep_cartograph.log"),
    )
    configuration = read_configuration(args.configuration_path)
    deep_cartograph(
        configuration=configuration,
        trajectory_data=args.trajectory_data,
        topology_data=args.topology_data,
        validation_trajectory_data=args.validation_trajectory_data,
        validation_topology_data=args.validation_topology_data,
        seed_trajectory_data=args.seed_trajectory_data,
        seed_topology_data=args.seed_topology_data,
        supplementary_traj_data=args.supplementary_traj_data,
        supplementary_top_data=args.supplementary_top_data,
        reference_topology=args.reference_topology,
        waypoints_data=args.waypoints_data,
        dimension=args.dimension,
        cvs=args.cvs,
        restart=args.restart,
        output_folder=output_folder,
    )


if __name__ == "__main__":
    main()
