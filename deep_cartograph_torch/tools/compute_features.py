"""compute_features tool: trajectories -> colvars feature time series.

The port of the JAX package's tools/compute_features.py. Per trajectory it
writes the same folder (keyed by the trajectory's stem, with the parent
folder's name added when two stems collide), `plumed_topology.pdb`, the
PLUMED input that would compute the same features, and `colvars.dat`;
`ref_topology.pdb` and `configuration.yml` go to the output folder. The
features of the trajectories that share a topology are computed in shared
chunks by one Featurizer (the pair distances through K1), on the tool's
device, or, on CUDA with several cards visible, sharded by frames over all
of them.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from deep_cartograph_torch.config.schemas import compute_features_config
from deep_cartograph_torch.features.common import find_common_features
from deep_cartograph_torch.features.translator import Translator
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.geom.structure import create_plumed_rmsd_template
from deep_cartograph_torch.io.colvars import check, write_colvars
from deep_cartograph_torch.io.topology import Topology, create_pdb
from deep_cartograph_torch.plumed.builder import ComputeFeaturesBuilder
from deep_cartograph_torch.utils.common import (
    check_data,
    files_exist,
    validate_configuration,
)
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device
from deep_cartograph_torch.utils.profiling import traced

logger = logging.getLogger("deep_cartograph_torch")

# One Featurizer per (topology, features, device), reused across the
# trajectories of a call and across the pipeline's calls (training,
# validation, supplementary and waypoint data share a feature list).
_featurizer_cache: Dict = {}


def engine_device(engine: Dict, device: DeviceLike = None) -> torch.device:
    """The featurization device from the `engine` block: "auto" and
    "default" mean the tool's device (CUDA unless `device="cpu"`), "cpu"
    the host. A setting the port cannot honour raises. The Featurizer's
    sharding follows `parallel.mesh.mesh_for(device)` (the caller's mesh,
    else the device alone);
    `shard_frames` is read nowhere, as in the JAX package."""
    if engine["dtype"] != "float32":
        raise ValueError(
            f"engine.dtype {engine['dtype']!r} is not supported: the port "
            "featurizes in float32 only."
        )
    return resolve_device("cpu" if engine["device"] == "cpu" else device)


def output_names(trajectories: List[str]) -> List[str]:
    """Each trajectory's output folder name: its stem, with the parent
    folder's name when stems collide, then a counter if still equal."""
    stems = [Path(t).stem for t in trajectories]
    out_names: List[str] = []
    seen: Dict[str, int] = {}
    for t, s in zip(trajectories, stems):
        name = s
        if stems.count(s) > 1:
            parent = Path(t).resolve().parent.name
            if parent:
                name = f"{parent}_{s}"
        n_prev = seen.get(name, 0)
        seen[name] = n_prev + 1
        if n_prev:
            name = f"{name}_{n_prev}"
        out_names.append(name)
    return out_names


@traced("compute_features")
def compute_features(
    configuration: Dict,
    trajectory_data: Union[List[str], str],
    topology_data: Union[List[str], str],
    reference_topology: Optional[str] = None,
    reference_features: Optional[List[str]] = None,
    traj_stride: Optional[int] = None,
    output_folder: str = "compute_features",
    device: DeviceLike = None,
) -> List[str]:
    """Compute the features of each trajectory; returns the colvars file
    paths (one per trajectory: PLUMED text, time in ps). A call whose
    colvars files all exist returns them and computes nothing.

    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host, as does `engine.device: cpu`."""
    logger.info("================")
    logger.info("Compute features")
    logger.info("================")
    start_time = time.time()

    trajectories, topologies = check_data(trajectory_data, topology_data)
    out_names = output_names(trajectories)
    colvars_paths = [
        os.path.join(output_folder, name, "colvars.dat") for name in out_names
    ]
    if colvars_paths and all(os.path.exists(p) for p in colvars_paths):
        logger.info(
            "Colvars files already exist in %s. Skipping feature computation.",
            output_folder,
        )
        return colvars_paths

    os.makedirs(output_folder, exist_ok=True)
    configuration = validate_configuration(
        configuration, compute_features_config, output_folder
    )
    dev = engine_device(configuration["engine"], device)

    if len(trajectories) != len(topologies):
        raise ValueError(
            f"Number of trajectories ({len(trajectories)}) and topologies "
            f"({len(topologies)}) do not match."
        )
    if not files_exist(*trajectories) or not files_exist(*topologies):
        raise FileNotFoundError("Trajectory or topology file missing.")

    if reference_topology is None:
        reference_topology = topologies[0]
        logger.info(
            "No reference topology provided. Using the first topology as "
            "reference: %s",
            reference_topology,
        )
    if not os.path.exists(reference_topology):
        raise FileNotFoundError(
            f"Reference topology file missing: {reference_topology}"
        )

    if reference_features is None:
        reference_features = find_common_features(
            features_configuration=configuration["plumed_settings"]["features"],
            topologies=topologies,
            reference_topology=reference_topology,
            output_folder=os.path.join(output_folder, "common_features"),
        )

    if traj_stride:
        configuration["plumed_settings"]["traj_stride"] = traj_stride
    stride = configuration["plumed_settings"]["traj_stride"]
    frame_chunk = configuration["engine"]["frame_chunk"]

    ref_plumed_topology = os.path.join(output_folder, "ref_topology.pdb")
    create_pdb(reference_topology, ref_plumed_topology)

    # Host: per-trajectory topology PDBs, feature translation and PLUMED
    # inputs; trajectories grouped by (topology, features).
    jobs: Dict = {}
    for topology_path, trajectory_path, colvars_path, traj_name in zip(
        topologies, trajectories, colvars_paths, out_names
    ):
        traj_output_folder = os.path.join(output_folder, traj_name)
        os.makedirs(traj_output_folder, exist_ok=True)
        if os.path.exists(colvars_path):
            logger.info("Skipping %s. Colvars file already exists.", traj_name)
            continue

        plumed_topology_path = os.path.abspath(
            os.path.join(traj_output_folder, "plumed_topology.pdb")
        )
        create_pdb(topology_path, plumed_topology_path)

        features_list = Translator(
            ref_plumed_topology, plumed_topology_path, reference_features
        ).run()
        if None in features_list:
            raise ValueError(
                f"Some common reference features could not be translated to "
                f"topology {Path(topology_path).stem}."
            )

        fit_template_path = None
        fit_template = None
        if any(f.startswith("coord") for f in features_list):
            fit_template_path = os.path.join(traj_output_folder, "fit_template.pdb")
            create_plumed_rmsd_template(topology_path, fit_template_path)
            template = Topology.from_file(fit_template_path)
            fit_template = (template.positions, template.occupancies)

        plumed_input_path = os.path.join(traj_output_folder, "plumed_input.dat")
        ComputeFeaturesBuilder(
            plumed_input_path=plumed_input_path,
            topology_path=plumed_topology_path,
            features_list=features_list,
            traj_stride=stride,
            fit_template_path=fit_template_path,
        ).build(colvars_path)

        cache_key = (Path(topology_path).resolve(), tuple(features_list), str(dev))
        entry = jobs.setdefault(
            cache_key, ((plumed_topology_path, features_list, fit_template), [])
        )
        entry[1].append((trajectory_path, colvars_path))

    # Device: each group through one Featurizer in shared chunks; each
    # colvars file is written as soon as its trajectory is done, so a
    # failure keeps the finished ones for a restart.
    for cache_key, ((plumed_topology_path, features_list, fit_template),
                    group) in jobs.items():
        featurizer = _featurizer_cache.get(cache_key)
        if featurizer is None:
            featurizer = Featurizer(
                Topology.from_file(plumed_topology_path),
                features_list,
                fit_template,
                device=dev,
            )
            _featurizer_cache[cache_key] = featurizer

        colvars_by_traj = dict(group)
        logger.info(
            "Computing features for %d trajectories sharing topology %s...",
            len(group),
            Path(cache_key[0]).stem,
        )
        for trajectory_path, features in featurizer.iter_featurize_trajectories(
            [traj for traj, _ in group],
            traj_stride=stride,
            frame_chunk=frame_chunk,
            timeout=configuration["plumed_settings"]["timeout"],
        ):
            # the PLUMED driver's time: the frame index in ps, strided
            # frames keeping their original index
            times = (np.arange(features.shape[0]) * stride).astype(np.float32)
            colvars_path = colvars_by_traj[trajectory_path]
            write_colvars(
                colvars_path, np.column_stack([times, features]),
                ["time", *features_list], fmt="%.4f",
            )
            check(colvars_path)

    elapsed = time.time() - start_time
    logger.info(
        "Elapsed time (Compute features): %s",
        time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
    )
    return colvars_paths
