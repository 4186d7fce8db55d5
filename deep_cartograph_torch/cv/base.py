"""CVCalculator base class: configuration, training data and the feature
normalization contract (PyTorch).

The port of the part of the JAX package's cv/base.py that the deep-TICA
training path runs: the constructor, `prepare_normalization` (the four
feature-normalization modes) and what `load_training_data` /
`load_validation_data` do after reading the colvars files (labels, feature
statistics, normalization). The colvars reader, the output folders, the
model.zip format, the run template and PLUMED export come with ROADMAP
Queue 1 item 2; until then the feature matrix is handed over with
`_set_training_data`.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_cartograph_torch.stats.descriptors import feature_statistics
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

_COLVARS_LATER = (
    "Reading colvars files is not ported yet (ROADMAP Queue 1 item 2: CV "
    "base + model.zip, io/colvars.py); pass the feature matrix to "
    "_set_training_data / _set_validation_data."
)


class CVCalculator:
    """Base class for collective-variable calculators."""

    def __init__(
        self,
        configuration: Optional[Dict] = None,
        device: DeviceLike = None,
    ):
        """`device`: None means CUDA (raises without a card); "cpu" runs on
        the host."""
        self.device = resolve_device(device)
        self.configuration: Dict = (
            copy.deepcopy(configuration) if configuration is not None else {}
        )
        self.architecture_config: Dict = self.configuration.get("architecture", {})
        self.feats_norm_mode: Optional[str] = self.configuration.get(
            "features_normalization", None
        )

        self.training_data: Optional[torch.Tensor] = None
        self.training_data_labels: Optional[np.ndarray] = None
        self.validation_data: Optional[torch.Tensor] = None
        self.validation_data_labels: Optional[np.ndarray] = None

        self.features_ref_labels: List[str] = []
        self.features_stats: Dict[str, np.ndarray] = {}
        self.features_norm_mean: Optional[np.ndarray] = None
        self.features_norm_range: Optional[np.ndarray] = None
        self.num_features: int = 0

        self.cv = None
        self.cv_dimension: Optional[int] = self.configuration.get("dimension")
        self.cv_name: Optional[str] = None

    # ------------------------------------------------------------------
    # Data loading
    # ------------------------------------------------------------------
    def load_training_data(self, train_colvars_paths, *args, **kwargs) -> None:
        raise NotImplementedError(_COLVARS_LATER)

    def load_validation_data(self, val_colvars_paths, *args, **kwargs) -> None:
        raise NotImplementedError(_COLVARS_LATER)

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
        statistics and the normalization arrays."""
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
