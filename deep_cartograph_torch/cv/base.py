"""CVCalculator base class: data loading, the normalization contract, the
run template, model persistence, the PLUMED deployment files and
sensitivity output (PyTorch).

The port of the JAX package's cv/base.py: the same four feature
normalization modes, the same run() template (compute -> normalize the CV
-> project -> save -> sensitivity), the same self-describing model.zip
(metadata.json, features_labels.txt, ref_topology.pdb, then each family's
weights and normalization arrays), the same polymorphic `load`, the same
PLUMED zips (`write_plumed_files`).

Differences, on purpose:

- The training data live on the calculator's device (CUDA unless the
  caller asks for the CPU); nothing is routed to the host because it is
  small (the JAX side's `maybe_cpu` / `maybe_cpu_for_host_data`).
- `run()` and `project_colvars` return (projection float32, CV labels)
  where the JAX package returns a DataFrame.
- The sensitivity bar plot is drawn only where the CV's
  `training.plot_loss` asks for its training figures; the JAX package
  draws it whatever that flag says.
- The PLUMED inputs' first line names the port (`plumed/assembler.py`).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deep_cartograph_torch.cv.tica_math import create_timelagged_dataset_multi
from deep_cartograph_torch.io.colvars import (
    create_dataframe_from_files,
    iter_features_chunks,
    should_stream_colvars,
    translation_is_identity,
)
from deep_cartograph_torch.io.topology import create_pdb
from deep_cartograph_torch.stats.descriptors import feature_statistics
from deep_cartograph_torch.utils.common import remove_files, unzip_files, zip_files
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

cv_names_map = {
    "pca": "PCA",
    "ae": "AE",
    "tica": "TICA",
    "htica": "HTICA",
    "deep_tica": "DeepTICA",
    "vae": "VAE",
    "umap": "UMAP",
}

cv_components_map = {
    "pca": "PC",
    "ae": "AE",
    "tica": "TIC",
    "htica": "HTIC",
    "deep_tica": "DeepTIC",
    "vae": "VAE",
    "umap": "UMAP",
}

Projection = Tuple[np.ndarray, List[str]]


class CVCalculator:
    """Base class for collective-variable calculators."""

    def __init__(
        self,
        configuration: Optional[Dict] = None,
        output_path: Optional[str] = None,
        device: DeviceLike = None,
    ):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host."""
        self.device = resolve_device(device)
        self.configuration: Dict = (
            copy.deepcopy(configuration) if configuration is not None else {}
        )
        self.architecture_config: Dict = self.configuration.get("architecture", {})
        self.training_reading_settings: Dict = self.configuration.get(
            "input_colvars", {}
        )
        self.feats_norm_mode: Optional[str] = self.configuration.get(
            "features_normalization", None
        )
        self.bias: Dict = self.configuration.get("bias", {})

        self.ref_topology_path: Optional[str] = None
        self.training_data: Optional[torch.Tensor] = None
        self.training_data_labels: Optional[np.ndarray] = None
        self.validation_data: Optional[torch.Tensor] = None
        self.validation_data_labels: Optional[np.ndarray] = None
        self.projection_data_labels: Optional[np.ndarray] = None

        self.features_ref_labels: List[str] = []
        self.features_stats: Dict[str, np.ndarray] = {}
        self.features_norm_mean: Optional[np.ndarray] = None
        self.features_norm_range: Optional[np.ndarray] = None
        self.num_features: int = 0

        self.cv = None
        self.cv_dimension: Optional[int] = self.configuration.get("dimension")
        self.cv_labels: List[str] = []
        self.cv_name: Optional[str] = None
        self.cv_range: List[Tuple[float, float]] = []

        self.parent_output_path: Optional[str] = output_path
        self.temp_model_path: Optional[str] = None

    def __del__(self):
        try:
            if self.temp_model_path and os.path.exists(self.temp_model_path):
                shutil.rmtree(self.temp_model_path, ignore_errors=True)
        except Exception:
            # os/shutil may already be torn down at interpreter exit
            pass

    # ------------------------------------------------------------------
    # Persistence: polymorphic factory + zip format
    # ------------------------------------------------------------------
    @classmethod
    def load(cls, model_path: str, output_path: str,
             device: DeviceLike = None) -> "CVCalculator":
        """Any calculator from a self-describing model.zip (written by the
        port or by the JAX package)."""
        from deep_cartograph_torch.cv import cv_calculators_map

        if not os.path.exists(model_path):
            raise FileNotFoundError(f"Model file not found: {model_path}")
        # Each load unzips into a folder of its own, which only its
        # calculator's __del__ removes: loads into one `output_path` never
        # share or delete each other's files.
        os.makedirs(output_path, exist_ok=True)
        unzip_folder = tempfile.mkdtemp(prefix="model_zip_", dir=output_path)
        unzip_files(model_path, unzip_folder)
        temp_model_path = os.path.join(unzip_folder, "model")

        try:
            metadata_path = os.path.join(temp_model_path, "metadata.json")
            cv_name = None
            if os.path.exists(metadata_path):
                with open(metadata_path) as fh:
                    cv_name = json.load(fh).get("cv_name")
            if not cv_name:
                raise ValueError("Could not determine the CV name from the model file.")
            calculator_class = cv_calculators_map.get(cv_name)
            if not calculator_class:
                raise TypeError(f"Unknown CV calculator name: {cv_name}")
            instance = calculator_class(output_path=output_path, device=device)
        except BaseException:
            shutil.rmtree(unzip_folder, ignore_errors=True)
            raise
        instance.temp_model_path = unzip_folder
        instance._load_from_folder(temp_model_path)
        return instance

    def _load_from_folder(self, folder_path: str) -> None:
        metadata_path = os.path.join(folder_path, "metadata.json")
        if os.path.exists(metadata_path):
            with open(metadata_path) as fh:
                metadata = json.load(fh)
            self.cv_dimension = metadata.get("cv_dimension")
            self.cv_name = metadata.get("cv_name")
            self.set_labels()
        else:
            logger.error("Metadata file not found in the model: %s", metadata_path)

        self.model_output_folder = os.path.join(
            self.parent_output_path, self.cv_name, "model"
        )
        if os.path.exists(self.model_output_folder):
            shutil.rmtree(self.model_output_folder)
        shutil.copytree(folder_path, self.model_output_folder)

        with open(os.path.join(self.model_output_folder, "features_labels.txt")) as fh:
            self.features_ref_labels = fh.read().strip().split("\n")
            self.num_features = len(self.features_ref_labels)

        ref_top = os.path.join(self.model_output_folder, "ref_topology.pdb")
        if os.path.exists(ref_top):
            self.ref_topology_path = ref_top
        else:
            self.ref_topology_path = None
            logger.warning("Reference topology file not found in the model.")

    def create_output_folders(self) -> None:
        self.output_path = Path(self.parent_output_path) / self.cv_name
        self.output_path.mkdir(parents=True, exist_ok=True)
        self.sensitivity_output_folder = self.output_path / "sensitivity_analysis"
        self.sensitivity_output_folder.mkdir(parents=True, exist_ok=True)
        self.training_output_folder = self.output_path / "training"
        self.training_output_folder.mkdir(parents=True, exist_ok=True)
        self.model_output_folder = self.output_path / "model"
        self.model_output_folder.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    # Data loading
    # ------------------------------------------------------------------
    def load_training_data(
        self,
        train_colvars_paths: List[str],
        train_topology_paths: Optional[List[str]] = None,
        ref_topology_path: Optional[str] = None,
        features_list: Optional[List[str]] = None,
    ) -> None:
        """Read the training colvars files (translated onto the reference
        topology, by default the first training topology), then
        `_set_training_data`."""
        self.ref_topology_path = ref_topology_path
        if train_topology_paths is not None and self.ref_topology_path is None:
            self.ref_topology_path = train_topology_paths[0]
        logger.info("Reading training data from colvars files...")
        matrix, names, labels = create_dataframe_from_files(
            colvars_paths=train_colvars_paths,
            topology_paths=train_topology_paths,
            reference_topology=self.ref_topology_path,
            features_list=features_list,
            **self.training_reading_settings,
        )
        self._set_training_data(matrix, labels, names)

    def load_validation_data(
        self,
        val_colvars_paths: List[str],
        val_topology_paths: Optional[List[str]] = None,
        ref_topology_path: Optional[str] = None,
        features_list: Optional[List[str]] = None,
    ) -> None:
        if val_topology_paths is not None and ref_topology_path is None:
            ref_topology_path = val_topology_paths[0]
        logger.info("Reading validation data from colvars files...")
        matrix, _, labels = create_dataframe_from_files(
            colvars_paths=val_colvars_paths,
            topology_paths=val_topology_paths,
            reference_topology=ref_topology_path,
            features_list=features_list,
            **self.training_reading_settings,
        )
        self._set_validation_data(matrix, labels)

    def _as_device_matrix(self, features) -> torch.Tensor:
        if isinstance(features, torch.Tensor):
            return features.to(self.device, torch.float32)
        # a copy: the calculator never shares memory with the caller's array
        return torch.tensor(np.asarray(features, np.float32), device=self.device)

    def _set_training_data(
        self,
        features,
        traj_labels: Optional[Sequence],
        feature_names: Sequence[str],
    ) -> None:
        """What `load_training_data` does after the file read: the
        (frames, features) matrix goes to the device, with its per-frame
        trajectory labels and its feature names; then the feature
        statistics and the normalization arrays. Subclasses add their own
        steps (linear CVs normalize the matrix, time-lagged CVs pair it)."""
        self.training_data = self._as_device_matrix(features)
        self.training_data_labels = (
            None if traj_labels is None else np.asarray(traj_labels)
        )
        self.features_ref_labels = list(feature_names)
        self.num_features = len(self.features_ref_labels)
        if self.training_data.shape[1] != self.num_features:
            raise ValueError(
                f"{self.training_data.shape[1]} feature columns but "
                f"{self.num_features} feature names"
            )
        logger.info("Number of features: %d", self.num_features)
        self.features_stats = feature_statistics(self.training_data, self.device)
        self.features_norm_mean, self.features_norm_range = (
            self.prepare_normalization()
        )

    def _set_validation_data(self, features, traj_labels: Optional[Sequence]) -> None:
        """What `load_validation_data` does after the file read."""
        self.validation_data = self._as_device_matrix(features)
        self.validation_data_labels = (
            None if traj_labels is None else np.asarray(traj_labels)
        )

    def _lag_pairs(self, data: torch.Tensor, labels: Optional[np.ndarray]):
        """Time-lagged pairs per trajectory (label), never across two."""
        lag = self.configuration.get("lag_time", 1)
        if labels is None:
            blocks = [data]
        else:
            blocks = [
                data[torch.as_tensor(np.nonzero(labels == lab)[0], device=data.device)]
                for lab in np.unique(labels)
            ]
        return create_timelagged_dataset_multi(blocks, lag)

    # ------------------------------------------------------------------
    # Normalization contract (cf. reference cv_calculator.py:308-363)
    # ------------------------------------------------------------------
    def prepare_normalization(self) -> Tuple[np.ndarray, np.ndarray]:
        """normalized = (feature - mean) / range, with four modes:
        None / mean_std / min_max_range1 ([0,1]) / min_max_range2 ([-1,1])."""
        stats = self.features_stats
        if self.feats_norm_mode is None:
            means = np.zeros(len(stats["mean"]))
            ranges = np.ones(len(stats["mean"]))
        elif self.feats_norm_mode == "mean_std":
            means = stats["mean"].copy()
            ranges = stats["std"].copy()
        elif self.feats_norm_mode == "min_max_range1":
            means = stats["min"].copy()
            ranges = stats["max"] - stats["min"]
        elif self.feats_norm_mode == "min_max_range2":
            means = (stats["min"] + stats["max"]) / 2
            ranges = (stats["max"] - stats["min"]) / 2
        else:
            raise ValueError(
                f"Normalization mode {self.feats_norm_mode} not recognized."
            )
        # Guard degenerate ranges (cf. sanitize_ranges, cv_calculator.py:329-337)
        small = np.abs(ranges) < 1e-8
        if small.any():
            logger.warning(
                "%d feature ranges are close to zero; set to 1.0.", small.sum()
            )
            ranges = np.where(small, 1.0, ranges)
        return means, ranges

    # ------------------------------------------------------------------
    # Run template
    # ------------------------------------------------------------------
    def run(self, cv_dimension: Optional[int] = None) -> Optional[Projection]:
        """Compute the CV, normalize it, project the training data, save the
        model and the sensitivities. Returns (projection float32, CV
        labels), or None when no CV came out."""
        if self.training_data is None:
            logger.error("Training data not loaded. Cannot compute CV.")
            return None
        self.create_output_folders()
        if cv_dimension:
            self.cv_dimension = cv_dimension
        self.compute_cv()
        self.set_labels()
        if self.cv is None:
            return None
        self.normalize_cv()
        projection = self.project_data(self.training_data, normalize_data=False)
        self.save_model()
        self.sensitivity_analysis()
        return np.asarray(projection, np.float32), list(self.cv_labels)

    # Subclass surface -----------------------------------------------------
    def compute_cv(self) -> None:
        raise NotImplementedError

    def save_weights(self, weights_path: str) -> None:
        raise NotImplementedError

    def get_cv_parameters(self) -> Dict:
        raise NotImplementedError

    def get_cv_type(self) -> str:
        raise NotImplementedError

    def project_data(self, data, normalize_data: bool = True) -> np.ndarray:
        raise NotImplementedError

    def normalize_cv(self) -> None:
        raise NotImplementedError

    def sensitivity_analysis(self) -> None:
        raise NotImplementedError

    def cv_ready(self) -> bool:
        return self.cv is not None

    def projection(self):
        """The trained CV as a serving module (`deploy.FramesToCV`); the
        linear and the deep families have one, the others do not."""
        raise TypeError(
            f"FramesToCV has no fused device path for {type(self).__name__}; "
            "use calculator.project_data instead."
        )

    # ------------------------------------------------------------------
    def save_model(self) -> None:
        """The model.zip content every family shares."""
        metadata = {"cv_name": self.cv_name, "cv_dimension": self.cv_dimension}
        with open(os.path.join(self.model_output_folder, "metadata.json"), "w") as fh:
            json.dump(metadata, fh)
        with open(os.path.join(self.model_output_folder, "features_labels.txt"),
                  "w") as fh:
            fh.write("\n".join(self.features_ref_labels) + "\n")
        if self.ref_topology_path is not None:
            create_pdb(self.ref_topology_path,
                       os.path.join(self.model_output_folder, "ref_topology.pdb"))

    def _zip_and_clean_model(self) -> str:
        model_path = os.path.join(self.output_path, "model.zip")
        zip_files(model_path, str(self.model_output_folder))
        shutil.rmtree(self.model_output_folder)
        logger.info("Model saved to %s", model_path)
        return model_path

    # ------------------------------------------------------------------
    def project_colvars(
        self,
        colvars_paths: Union[List[str], str],
        topology_paths: Union[List[str], str, None] = None,
    ) -> Optional[Projection]:
        """Project colvars files onto the CV: (projection float32, CV
        labels). The features are translated from each file's topology onto
        the model's reference topology; without a reference topology the
        files are read by feature name."""
        if self.ref_topology_path is None:
            if topology_paths:
                logger.warning(
                    "Reference topology not set. Make sure the colvars file "
                    "matches the training data."
                )
                return None
            logger.info("No reference topology: projecting by feature name "
                        "(no cross-topology translation).")
        if isinstance(topology_paths, str):
            topology_paths = [topology_paths]
        if translation_is_identity(topology_paths, self.ref_topology_path) and \
                should_stream_colvars(colvars_paths,
                                      self.configuration.get("streaming", "auto")):
            return self._project_colvars_streaming(colvars_paths)
        data, _, labels = create_dataframe_from_files(
            colvars_paths=colvars_paths,
            topology_paths=topology_paths,
            reference_topology=self.ref_topology_path,
            features_list=self.features_ref_labels,
        )
        self.projection_data_labels = labels
        return np.asarray(self.project_data(data), np.float32), list(self.cv_labels)

    def _project_colvars_streaming(self, colvars_paths) -> Optional[Projection]:
        """Project block by block, never holding the (frames, features)
        matrix: every CV family here projects row by row."""
        if isinstance(colvars_paths, str):
            colvars_paths = [colvars_paths]
        logger.info("Streaming projection: %d features over %d file(s).",
                    self.num_features, len(colvars_paths))
        parts: List[np.ndarray] = []
        file_rows: List[int] = []
        for path in colvars_paths:
            rows_here = 0
            for blk in iter_features_chunks(path, feature_names=self.features_ref_labels,
                                            nan_check=True):
                rows_here += blk.shape[0]
                parts.append(np.asarray(self.project_data(blk), np.float32))
            file_rows.append(rows_here)
        if not parts:
            logger.error("The resulting dataframe is empty.")
            sys.exit(1)
        self.projection_data_labels = np.repeat(np.arange(len(file_rows)), file_rows)
        return np.concatenate(parts, axis=0), list(self.cv_labels)

    def set_labels(self) -> None:
        self.cv_labels = [
            f"{cv_components_map[self.cv_name]} {i + 1}"
            for i in range(self.cv_dimension)
        ]

    # ------------------------------------------------------------------
    def compute_atom_sensitivities(
        self, feature_labels: List[str], feature_sensitivities: np.ndarray
    ) -> Dict[int, float]:
        """Per-atom sensitivity: the largest sensitivity of the features
        that touch the atom."""
        from deep_cartograph_torch.features.grammar import resolve_entity_index
        from deep_cartograph_torch.io.topology import Topology

        topology = Topology.from_file(self.ref_topology_path)
        per_atom: Dict[int, float] = {}
        for feature, sensitivity in zip(feature_labels, feature_sensitivities):
            entities = feature.split("-")[1:]
            if entities:
                entities[-1] = entities[-1].split(".")[0]
            for entity in entities:
                if entity.startswith("center_"):
                    continue
                if entity.startswith("@") and entity[1:].split("_")[0] in ("phi", "psi"):
                    continue
                try:
                    idx = resolve_entity_index(entity, topology)
                except (ValueError, KeyError):
                    continue
                per_atom[idx] = max(per_atom.get(idx, -np.inf), float(sensitivity))
        return per_atom

    def _save_sensitivity(
        self, feature_labels: List[str], sensitivities: np.ndarray, folder: str
    ) -> None:
        """sensitivity_analysis.csv (pandas' layout: an unnamed index column
        of feature names, a `sensitivity` column), the bar plot
        sensitivity_barh.png where `training.plot_loss` asks for the
        training figures and, with a reference topology, the per-atom map
        sensitivity_structure.pdb."""
        from deep_cartograph_torch.figures.plots import plot_sensitivity_results
        from deep_cartograph_torch.geom.structure import map_sensitivity_to_structure

        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "sensitivity_analysis.csv"), "w") as fh:
            fh.write(",sensitivity\n")
            for label, value in zip(feature_labels, np.asarray(sensitivities)):
                fh.write(f"{label},{value}\n")
        if self.configuration.get("training", {}).get("plot_loss", True):
            results = {"feature_names": list(feature_labels),
                       "sensitivity": {"Dataset": np.asarray(sensitivities)}}
            plot_sensitivity_results(results, modes=["barh"], output_folder=folder)
        if self.ref_topology_path is None:
            return
        per_atom = self.compute_atom_sensitivities(list(feature_labels),
                                                   np.asarray(sensitivities))
        if per_atom:
            map_sensitivity_to_structure(per_atom, self.ref_topology_path, folder)

    # ------------------------------------------------------------------
    # PLUMED deployment files (cf. reference cv_calculator.py:545-681)
    # ------------------------------------------------------------------
    def write_plumed_files(
        self,
        topology: Optional[str],
        output_folder: str,
        waypoint_structures: Optional[List[str]] = None,
    ) -> None:
        """plumed_{cv}_unbiased.zip (an input that computes the CV along a
        run) and, with a bias configuration, plumed_{cv}_biased.zip (one
        that biases the run along it) in `output_folder`, for `topology`:
        the model's features translated onto it, the topology, the fit
        template for coordinate features, a deep CV's TorchScript weights
        (traced on the calculator's device) and, with `add_rmsd_restraint`
        and waypoint structures, the RMSD restraint's reference (waypoints
        aligned on the calculator's device)."""
        from deep_cartograph_torch.features.translator import Translator
        from deep_cartograph_torch.geom.structure import (
            create_plumed_rmsd_template,
            create_rmsd_waypoint_reference,
        )
        from deep_cartograph_torch.plumed.builder import (
            ComputeCVBuilder,
            ComputeEnhancedSamplingBuilder,
        )

        if topology is None:
            logger.warning("Topology not provided. Skipping PLUMED files creation.")
            return
        topology_name = Path(topology).name
        plumed_files: List[str] = []

        plumed_topology_path = os.path.join(output_folder, "plumed_topology.pdb")
        create_pdb(topology, plumed_topology_path)
        plumed_files.append(plumed_topology_path)

        ref_plumed_topology_path = os.path.join(output_folder, "ref_plumed_topology.pdb")
        create_pdb(self.ref_topology_path, ref_plumed_topology_path)
        features_list = Translator(ref_plumed_topology_path, plumed_topology_path,
                                   self.features_ref_labels).run()
        if None in features_list:
            failed = [self.features_ref_labels[i]
                      for i, f in enumerate(features_list) if f is None]
            logger.error("Failed to translate features to topology %s: %s. Skipping "
                         "PLUMED files creation.", topology_name, failed)
            return

        fit_template_path = None
        if any(f.startswith("coord") for f in features_list):
            fit_template_path = os.path.join(output_folder, "fit_template.pdb")
            create_plumed_rmsd_template(topology, fit_template_path)
            plumed_files.append(fit_template_path)

        if self.get_cv_type() == "non-linear":
            self.weights_path = os.path.join(output_folder, f"{self.cv_name}_weights.pt")
            self.save_weights(self.weights_path)
            plumed_files.append(self.weights_path)

        plumed_input_path = os.path.join(output_folder, f"plumed_input_{self.cv_name}.dat")
        builder_args = {
            "plumed_input_path": plumed_input_path,
            "topology_path": plumed_topology_path,
            "features_list": features_list,
            "traj_stride": 1,
            "cv_type": self.get_cv_type(),
            "cv_params": self.get_cv_parameters(),
            "fit_template_path": fit_template_path,
        }
        ComputeCVBuilder(**builder_args).build(f"{self.cv_name}_out.dat")
        zip_files(os.path.join(output_folder, f"plumed_{self.cv_name}_unbiased.zip"),
                  *plumed_files, plumed_input_path)
        os.remove(plumed_input_path)

        if self.bias:
            rmsd_reference_path = None
            if self.bias.get("add_rmsd_restraint"):
                if waypoint_structures:
                    rmsd_reference_path = os.path.join(output_folder,
                                                       "rmsd_restraint_reference.pdb")
                    create_rmsd_waypoint_reference(
                        waypoint_structures, plumed_topology_path, rmsd_reference_path,
                        self.bias.get("align_waypoint_structures", True), device=self.device)
                    plumed_files.append(rmsd_reference_path)
                else:
                    logger.warning("No waypoint structures provided for RMSD restraint "
                                   "guide. Skipping RMSD restraint.")
            method = self.bias["method"]
            plumed_input_path = os.path.join(
                output_folder, f"plumed_input_{self.cv_name}_{method}.dat")
            plumed_files.append(plumed_input_path)
            builder_args.update({
                "sampling_method": method,
                "sampling_params": self.bias["args"],
                "plumed_input_path": plumed_input_path,
                "rmsd_restraint_reference_path": rmsd_reference_path,
                "rmsd_restraint_k": self.bias.get("rmsd_restraint_k"),
                "rmsd_restraint_eq": self.bias.get("rmsd_restraint_eq"),
            })
            ComputeEnhancedSamplingBuilder(**builder_args).build(
                f"{self.cv_name}_{method}_out.dat")
            zip_files(os.path.join(output_folder, f"plumed_{self.cv_name}_biased.zip"),
                      *plumed_files)
        else:
            # a model loaded from a zip carries no bias configuration; the
            # unbiased input is still written (the reference errors out)
            logger.warning("No bias configuration on this calculator; skipping the "
                           "biased PLUMED input.")
        remove_files(*plumed_files)
        os.remove(ref_plumed_topology_path)

    # Getters ------------------------------------------------------------
    def get_labels(self) -> List[str]:
        return self.cv_labels

    def get_cv_dimension(self) -> int:
        return self.cv_dimension

    def get_range(self) -> List[Tuple[float, float]]:
        return self.cv_range
