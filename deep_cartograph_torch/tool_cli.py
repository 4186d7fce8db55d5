"""Per-tool command lines, with the JAX package's flags. Each is a
function of this module (`compute_features_main`, ...), and

    python -m deep_cartograph_torch.tool_cli <tool> [flags]

runs the one named, e.g. `compute_features -conf conf.json -traj_data ...`.
The tools run on the CUDA device; the configuration file may be YAML or
JSON.
"""

from __future__ import annotations

import argparse
import os
import sys

from deep_cartograph_torch.cli import set_logger
from deep_cartograph_torch.utils.common import read_configuration


def _setup(output_folder: str, default: str, verbose: bool):
    out = output_folder if output_folder else default
    os.makedirs(out, exist_ok=True)
    set_logger(verbose=verbose, log_path=os.path.join(out, "deep_cartograph.log"))
    return out


def compute_features_main() -> None:
    parser = argparse.ArgumentParser(prog="compute_features")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-traj_data", dest="trajectory_data", required=True, nargs="+")
    parser.add_argument("-top_data", dest="topology_data", required=True, nargs="+")
    parser.add_argument("-traj_stride", dest="traj_stride", type=int, required=False)
    parser.add_argument("-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "compute_features", args.verbose)
    from deep_cartograph_torch.tools.compute_features import compute_features

    compute_features(
        configuration=read_configuration(args.configuration_path),
        trajectory_data=args.trajectory_data,
        topology_data=args.topology_data,
        traj_stride=args.traj_stride,
        output_folder=out,
    )


def filter_features_main() -> None:
    parser = argparse.ArgumentParser(prog="filter_features")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-colvars", dest="colvars_paths", required=True, nargs="+")
    parser.add_argument("-waypoint_colvars", dest="waypoint_colvars", nargs="+", required=False)
    parser.add_argument("-topologies", dest="topologies", nargs="+", required=False)
    parser.add_argument("-waypoint_topologies", dest="waypoint_topologies", nargs="+", required=False)
    parser.add_argument("-ref_topology", dest="reference_topology", required=False)
    parser.add_argument("-output", dest="output_folder", required=False)
    parser.add_argument("-csv_summary", action="store_true", default=True)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "filter_features", args.verbose)
    from deep_cartograph_torch.tools.filter_features import filter_features

    filter_features(
        configuration=read_configuration(args.configuration_path),
        colvars_paths=args.colvars_paths,
        waypoint_colvars_paths=args.waypoint_colvars,
        csv_summary=args.csv_summary,
        topologies=args.topologies,
        waypoint_topologies=args.waypoint_topologies,
        reference_topology=args.reference_topology,
        output_folder=out,
    )


def train_colvars_main() -> None:
    parser = argparse.ArgumentParser(prog="train_colvars")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-colvars", dest="train_colvars_path", required=True)
    parser.add_argument("-trajectory", dest="trajectory_name", required=False)
    parser.add_argument("-topology", dest="topology", required=False)
    parser.add_argument("-reference_topology", dest="reference_topology", required=False)
    parser.add_argument("-frames_per_sample", dest="frames_per_sample", type=int, required=False, default=1)
    parser.add_argument("-features", dest="features_path", required=False)
    parser.add_argument("-dim", "-dimension", dest="dimension", type=int, required=False)
    parser.add_argument("-cvs", nargs="+", required=False)
    parser.add_argument("-out", "-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "train_colvars", args.verbose)
    from deep_cartograph_torch.tools.train_colvars import train_colvars
    from deep_cartograph_torch.utils.common import read_features_list

    train_colvars(
        configuration=read_configuration(args.configuration_path),
        train_colvars_paths=[args.train_colvars_path],
        train_topologies=[args.topology] if args.topology else None,
        trajectory_names=[args.trajectory_name] if args.trajectory_name else None,
        reference_topology=args.reference_topology,
        features_list=read_features_list(args.features_path),
        dimension=args.dimension,
        cvs=args.cvs,
        frames_per_sample=args.frames_per_sample,
        output_folder=out,
    )


def traj_projection_main() -> None:
    parser = argparse.ArgumentParser(prog="traj_projection")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-colvars", "-colvars_files", dest="colvars_path", nargs="*", required=True)
    parser.add_argument("-top", "-topology", dest="topologies", nargs="*", required=False)
    parser.add_argument("-names", "-trajectory_names", dest="trajectory_names", nargs="*", required=False)
    parser.add_argument("-models", "-cvs_models", dest="model_paths", nargs="*", required=True)
    parser.add_argument("-models_traj", "-cvs_models_traj", dest="model_traj_paths", nargs="*", required=False)
    parser.add_argument("-out", "-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "traj_projection", args.verbose)
    from deep_cartograph_torch.tools.traj_projection import traj_projection

    model_traj_paths = (
        [[p] for p in args.model_traj_paths] if args.model_traj_paths else None
    )
    traj_projection(
        configuration=read_configuration(args.configuration_path),
        colvars_paths=args.colvars_path,
        topologies=args.topologies,
        trajectory_names=args.trajectory_names,
        model_paths=args.model_paths,
        model_traj_paths=model_traj_paths,
        output_folder=out,
    )


def traj_cluster_main() -> None:
    parser = argparse.ArgumentParser(prog="traj_cluster")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-cv_traj", "-cv_trajectory", dest="cv_traj_path", required=True)
    parser.add_argument("-trajectory", dest="trajectory", required=False)
    parser.add_argument("-topology", dest="topology", required=False)
    parser.add_argument("-sup_cv_traj", "-sup_cv_trajectory", dest="sup_cv_traj_path", required=False)
    parser.add_argument("-sup_trajectory", dest="sup_trajectory_path", required=False)
    parser.add_argument("-sup_topology", dest="sup_topology_path", required=False)
    parser.add_argument("-frames_per_sample", dest="frames_per_sample", type=int, required=False, default=1)
    parser.add_argument("-out", "-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "traj_cluster", args.verbose)
    from deep_cartograph_torch.tools.traj_cluster import traj_cluster

    traj_cluster(
        configuration=read_configuration(args.configuration_path),
        cv_traj_paths=[args.cv_traj_path],
        trajectories=[args.trajectory] if args.trajectory else None,
        topologies=[args.topology] if args.topology else None,
        sup_cv_traj_paths=[args.sup_cv_traj_path] if args.sup_cv_traj_path else None,
        sup_trajectories=[args.sup_trajectory_path] if args.sup_trajectory_path else None,
        sup_topologies=[args.sup_topology_path] if args.sup_topology_path else None,
        frames_per_sample=args.frames_per_sample,
        output_folder=out,
    )


def traj_augmentation_main() -> None:
    parser = argparse.ArgumentParser(prog="traj_augmentation")
    parser.add_argument("-conf", "-configuration", dest="configuration_path", required=True)
    parser.add_argument("-traj_data", dest="trajectory_data", required=True, nargs="+")
    parser.add_argument("-top_data", dest="topology_data", required=True, nargs="+")
    parser.add_argument("-n", "-num_replicas", dest="num_replicas", type=int, default=1)
    parser.add_argument("-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "traj_augmentation", args.verbose)
    from deep_cartograph_torch.tools.traj_augmentation import traj_augmentation

    traj_augmentation(
        configuration=read_configuration(args.configuration_path),
        trajectory_data=args.trajectory_data,
        topology_data=args.topology_data,
        num_replicas=args.num_replicas,
        output_folder=out,
    )


def analyze_geometry_main() -> None:
    parser = argparse.ArgumentParser(prog="analyze_geometry")
    parser.add_argument("-conf", dest="configuration_path", required=True)
    parser.add_argument("-traj_data", dest="trajectory_data", required=True)
    parser.add_argument("-top_data", dest="topology_data", required=True)
    parser.add_argument("-ref_top_data", dest="ref_topology_data", required=False, default=None)
    parser.add_argument("-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "analyze_geometry", args.verbose)
    from deep_cartograph_torch.tools.analyze_geometry import analyze_geometry
    from deep_cartograph_torch.utils.common import check_data, find_files

    trajectories, topologies = check_data(args.trajectory_data, args.topology_data)
    ref_tops = find_files(args.ref_topology_data) if args.ref_topology_data else None
    analyze_geometry(
        configuration=read_configuration(args.configuration_path),
        trajectories=trajectories,
        topologies=topologies,
        ref_topologies=ref_tops,
        output_folder=out,
    )


def align_trajectories_main() -> None:
    parser = argparse.ArgumentParser(prog="align_trajectories")
    parser.add_argument("-traj_data", dest="trajectory_data", required=True, nargs="+")
    parser.add_argument("-top_data", dest="topology_data", required=True, nargs="+")
    parser.add_argument("-ref_top", dest="reference_topology", required=False)
    parser.add_argument("-output", dest="output_folder", required=False)
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true", default=False)
    args = parser.parse_args()
    out = _setup(args.output_folder, "align_trajectories", args.verbose)
    from deep_cartograph_torch.tools.align_trajectories import align_trajectories

    align_trajectories(
        trajectory_data=args.trajectory_data,
        topology_data=args.topology_data,
        ref_topology=args.reference_topology,
        output_folder=out,
    )


TOOLS = {
    name[: -len("_main")]: fn
    for name, fn in list(globals().items())
    if name.endswith("_main") and callable(fn)
}


def main() -> None:
    """Run the tool named by the first argument with the rest."""
    if len(sys.argv) < 2 or sys.argv[1] not in TOOLS:
        print("usage: python -m deep_cartograph_torch.tool_cli {%s} [flags]"
              % ",".join(TOOLS), file=sys.stderr)
        sys.exit(2)
    tool = sys.argv.pop(1)
    sys.argv[0] = tool
    TOOLS[tool]()


if __name__ == "__main__":
    main()
