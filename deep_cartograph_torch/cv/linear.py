"""Linear CV calculators: PCA, TICA, HTICA (PyTorch).

The port of the JAX package's cv/linear.py: the training data are
normalized in place, the CV is a weights matrix, the projection is
min-max normalized to [-1, 1] (a zero range clamped to 1 below 1e-12), the
sensitivity of a feature is |weight|, and the model is saved as .npy files.
The covariances, products and eigensolves run on the calculator's device,
except PCA's eigensolve above 256 features, which goes to LAPACK's subset
routine on the host as on the JAX side. In-memory TICA and HTICA pair
frames per trajectory (`_lag_pairs`).

Streaming (training sets past DEEP_CARTO_STREAM_BYTES, or `streaming:
true`): the colvars files are read in blocks, and PCA accumulates its
covariance block by block while TICA and HTICA go through
`htica_stream.StreamingHTICA` (TICA as one subspace spanning every
feature).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from deep_cartograph_torch.cv.base import CVCalculator, cv_names_map
from deep_cartograph_torch.cv.htica_stream import (
    _EIGH_HOST_DIM_THRESHOLD,
    StreamingHTICA,
    host_topk_eigh,
)
from deep_cartograph_torch.cv.tica_math import split_subspaces, tica
from deep_cartograph_torch.deploy import LinearProjection
from deep_cartograph_torch.io.colvars import (
    iter_features_chunks,
    read_column_names,
    should_stream_colvars,
    translation_is_identity,
)
from deep_cartograph_torch.parallel.mesh import Mesh, mesh_for

logger = logging.getLogger(__name__)


class LinearCalculator(CVCalculator):
    """Base class of the linear CV calculators (the weights matrix is the
    CV)."""

    def __init__(self, configuration=None, output_path=None, device=None):
        super().__init__(configuration, output_path, device)
        self.cv: Optional[np.ndarray] = None
        self.cv_stats: Dict[str, np.ndarray] = {}
        self.cv_norm_mean: Optional[np.ndarray] = None
        self.cv_norm_range: Optional[np.ndarray] = None
        self.eigenvalues_: Optional[np.ndarray] = None
        self._streaming = False
        self._stream_paths: Optional[List[str]] = None
        self._stream_projection: Optional[np.ndarray] = None

    # -- persistence ----------------------------------------------------
    _ARRAYS = ("cv_norm_mean", "cv_norm_range", "features_norm_mean",
               "features_norm_range")

    def _load_from_folder(self, folder_path: str) -> None:
        super()._load_from_folder(folder_path)
        m = self.model_output_folder
        self.cv = np.load(os.path.join(m, "cv_weights.npy"))
        for name in self._ARRAYS:
            setattr(self, name, np.load(os.path.join(m, f"{name}.npy")))
        # mean = (max + min) / 2 and range = (max - min) / 2
        self.cv_stats = {
            "min": (self.cv_norm_mean - self.cv_norm_range).astype(np.float64),
            "max": (self.cv_norm_mean + self.cv_norm_range).astype(np.float64),
        }

    def save_weights(self, weights_path: str) -> None:
        np.save(weights_path, self.cv)

    def save_model(self) -> None:
        super().save_model()
        if self.cv is None:
            raise ValueError("No Linear CV weights to save.")
        if self.cv_norm_mean is None or self.cv_norm_range is None:
            raise ValueError("CV normalization parameters have not been computed.")
        if self.features_norm_mean is None or self.features_norm_range is None:
            raise ValueError("Features normalization parameters have not been computed.")
        m = self.model_output_folder
        self.save_weights(os.path.join(m, "cv_weights.npy"))
        for name in self._ARRAYS:
            np.save(os.path.join(m, f"{name}.npy"), getattr(self, name))
        self._zip_and_clean_model()

    # -- data -----------------------------------------------------------
    def load_training_data(self, train_colvars_paths, train_topology_paths=None,
                           ref_topology_path=None, features_list=None) -> None:
        if self._should_stream(train_colvars_paths, train_topology_paths,
                               ref_topology_path):
            if train_topology_paths and ref_topology_path is None:
                ref_topology_path = train_topology_paths[0]
            self._setup_streaming(train_colvars_paths, ref_topology_path, features_list)
            return
        super().load_training_data(train_colvars_paths, train_topology_paths,
                                   ref_topology_path, features_list)

    def _set_training_data(self, features, traj_labels, feature_names) -> None:
        """Linear CVs take normalized data: the calculator's matrix is
        replaced by its normalized copy (the caller's is left alone)."""
        super()._set_training_data(features, traj_labels, feature_names)
        self.training_data = self._normalize(self.training_data)

    def _normalize(self, data: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.features_norm_mean, dtype=torch.float32,
                               device=data.device)
        rng = torch.as_tensor(self.features_norm_range, dtype=torch.float32,
                              device=data.device)
        return (data - mean) / rng

    # -- streaming -------------------------------------------------------
    def _should_stream(self, paths, topology_paths, ref_topology_path=None) -> bool:
        mode = self.configuration.get("streaming", "auto")
        if not translation_is_identity(topology_paths, ref_topology_path):
            # the streaming reader selects columns by untranslated name
            if mode in (True, "on"):
                logger.warning("streaming=true requested but the inputs need "
                               "cross-topology translation; loading in memory.")
            return False
        result = should_stream_colvars(paths, mode)
        if mode in (True, "on") and not result:
            logger.warning("streaming=true requested but the inputs are not PLUMED "
                           "files; loading in memory.")
        return result

    def _setup_streaming(self, train_colvars_paths, ref_topology_path,
                         features_list) -> None:
        """One pass over the files: the normalization statistics (float64),
        the per-file row counts (training_data_labels) and the NaN screen."""
        if isinstance(train_colvars_paths, str):
            train_colvars_paths = [train_colvars_paths]
        self._streaming = True
        self._stream_paths = list(train_colvars_paths)
        self.ref_topology_path = ref_topology_path
        self.features_ref_labels = list(
            features_list or read_column_names(self._stream_paths[0], features_only=True)
        )
        self.num_features = len(self.features_ref_labels)
        if self.num_features == 0:
            raise ValueError(f"No feature columns found in {self._stream_paths[0]}.")
        logger.info("%s streaming mode: %d features over %d file(s).",
                    self.cv_name, self.num_features, len(self._stream_paths))
        s1 = np.zeros(self.num_features, np.float64)
        s2 = np.zeros(self.num_features, np.float64)
        mn = np.full(self.num_features, np.inf, np.float64)
        mx = np.full(self.num_features, -np.inf, np.float64)
        file_rows: List[int] = []
        for path in self._stream_paths:
            rows_here = 0
            for blk in self._file_chunks(path):
                b64 = blk.astype(np.float64)
                rows_here += b64.shape[0]
                s1 += b64.sum(axis=0)
                s2 += (b64 * b64).sum(axis=0)
                np.minimum(mn, b64.min(axis=0), out=mn)
                np.maximum(mx, b64.max(axis=0), out=mx)
            file_rows.append(rows_here)
        cnt = sum(file_rows)
        if cnt == 0:
            raise ValueError(f"No rows read from colvars files {self._stream_paths} "
                             "with the configured reading window.")
        self.training_data_labels = np.repeat(np.arange(len(file_rows)), file_rows)
        mean = s1 / cnt
        var = np.maximum(s2 / cnt - mean * mean, 0.0)
        self.features_stats = {"mean": mean, "std": np.sqrt(var), "min": mn, "max": mx}
        self.features_norm_mean, self.features_norm_range = self.prepare_normalization()

    def _file_chunks(self, path: str):
        """Chunks of one colvars file in the configured reading window."""
        read = self.training_reading_settings
        yield from iter_features_chunks(
            path, feature_names=self.features_ref_labels,
            start=read.get("start", 0), stop=read.get("stop", None),
            stride=max(read.get("stride", 1), 1), nan_check=True,
        )

    def _normalized_stream(self, with_breaks: bool = False, pad_to: int = 0):
        """Normalized device blocks of every training file in order; with
        `with_breaks`, None between files so that lag pairs never cross
        them; zero columns up to `pad_to`."""
        for i, path in enumerate(self._stream_paths):
            if i and with_breaks:
                yield None
            for blk in self._file_chunks(path):
                nb = self._normalize(torch.as_tensor(blk).to(self.device))
                if pad_to > nb.shape[1]:
                    nb = torch.nn.functional.pad(nb, (0, pad_to - nb.shape[1]))
                yield nb

    # -- projection / normalization --------------------------------------
    def get_cv_parameters(self) -> Dict:
        return {
            "cv_name": self.cv_name,
            "cv_dimension": self.cv_dimension,
            "features_norm_mode": self.feats_norm_mode,
            "features_norm_mean": self.features_norm_mean,
            "features_norm_range": self.features_norm_range,
            "cv_stats": self.cv_stats,
            "weights": self.cv,
        }

    def get_cv_type(self) -> str:
        return "linear"

    def _weights(self) -> torch.Tensor:
        return torch.as_tensor(self.cv, dtype=torch.float32, device=self.device)

    def project_data(self, data, normalize_data: bool = True) -> np.ndarray:
        if self.cv is None:
            raise ValueError("CV has not been computed. Cannot project data.")
        if self.cv_norm_mean is None or self.cv_norm_range is None:
            raise ValueError("CV normalization parameters missing.")
        x = self._as_device_matrix(data)
        if normalize_data:
            if self.features_norm_mean is None:
                raise ValueError("Feature normalization parameters missing.")
            x = self._normalize(x)
        projected = (x @ self._weights()).cpu().numpy()
        return ((projected - self.cv_norm_mean) / self.cv_norm_range).astype(np.float32)

    def projection(self) -> LinearProjection:
        """The trained CV as a serving module (`deploy.FramesToCV`)."""
        return LinearProjection(self.features_norm_mean, self.features_norm_range,
                                self.cv, self.cv_norm_mean, self.cv_norm_range)

    def normalize_cv(self) -> None:
        """Min-max normalization of the projected training data to [-1, 1]."""
        w = self._weights()
        if self._streaming:
            # keep the (frames, dim) projection for run()'s output
            projected = np.concatenate(
                [(blk @ w).cpu().numpy() for blk in self._normalized_stream()])
            self._stream_projection = projected
        else:
            if self.training_data is None:
                raise ValueError("Training data not loaded.")
            projected = (self.training_data @ w).cpu().numpy()
        self._set_cv_stats_from_projection(projected)

    def _set_cv_stats_from_projection(self, projected: np.ndarray) -> None:
        self.cv_stats = {"min": projected.min(axis=0).astype(np.float64),
                         "max": projected.max(axis=0).astype(np.float64)}
        self.cv_norm_mean = (self.cv_stats["max"] + self.cv_stats["min"]) / 2
        self.cv_norm_range = (self.cv_stats["max"] - self.cv_stats["min"]) / 2
        # a constant component would give inf/NaN CVs
        self.cv_norm_range = np.where(np.abs(self.cv_norm_range) < 1e-12, 1.0,
                                      self.cv_norm_range)

    def run(self, cv_dimension=None):
        if not self._streaming:
            return super().run(cv_dimension)
        # The run template without the matrix: the projection comes from
        # normalize_cv's pass over the files.
        self.create_output_folders()
        if cv_dimension:
            self.cv_dimension = cv_dimension
        self.compute_cv()
        self.set_labels()
        if self.cv is None:
            return None
        self.normalize_cv()
        projection = (self._stream_projection - self.cv_norm_mean) / self.cv_norm_range
        self._stream_projection = None
        self.save_model()
        self.sensitivity_analysis()
        return np.asarray(projection, np.float32), list(self.cv_labels)

    def sensitivity_analysis(self) -> None:
        """|weight| of each feature, per CV component."""
        sens = np.abs(np.asarray(self.cv))
        for ci in range(sens.shape[1]):
            folder = os.path.join(str(self.sensitivity_output_folder),
                                  f"sensitivity_analysis_{ci + 1}")
            order = np.argsort(sens[:, ci])
            labels = [self.features_ref_labels[i] for i in order]
            self._save_sensitivity(labels, sens[order, ci], folder)

    def _lagged_config(self):
        return (self.configuration.get("lag_time", 1),
                self.configuration.get("tica_regularization", 1e-6))


class PCACalculator(LinearCalculator):
    """Principal component analysis: covariance eigendecomposition, the
    first weight of each component positive."""

    def __init__(self, configuration=None, output_path=None, device=None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "pca"
        logger.info("Creating %s Calculator ...", cv_names_map[self.cv_name])

    def compute_cv(self) -> None:
        if self._streaming:
            self._compute_cv_streaming()
            return
        if self.training_data is None:
            logger.error("No training data available to compute PCA.")
            return
        x = self.training_data
        xc = x - x.mean(0)
        self._finish_pca(xc.T @ xc / (x.shape[0] - 1))

    def _compute_cv_streaming(self) -> None:
        """Covariance from block products on the device, summed in float64
        on the host, every block shifted by the first block's mean."""
        n = 0
        shift = None
        s1 = np.zeros(self.num_features, np.float64)
        s2 = np.zeros((self.num_features, self.num_features), np.float64)
        for blk in self._normalized_stream():
            if shift is None:
                shift = blk.mean(0)
            xs = blk - shift
            n += blk.shape[0]
            s1 += xs.sum(0).cpu().double().numpy()
            s2 += (xs.T @ xs).cpu().double().numpy()
        if n < 2:
            logger.error("No training data available to compute PCA.")
            return
        mu = s1 / n
        cov = (s2 - n * np.outer(mu, mu)) / (n - 1)
        self._finish_pca(torch.as_tensor(cov, dtype=torch.float32, device=self.device))

    def _finish_pca(self, cov: torch.Tensor) -> None:
        # Above 256 features, LAPACK's subset routine on the host takes the
        # top cv_dimension pairs only.
        if cov.shape[-1] > _EIGH_HOST_DIM_THRESHOLD:
            evals, evecs = host_topk_eigh(cov.cpu().numpy(), self.cv_dimension)
        else:
            evals, evecs = (t.cpu().numpy() for t in torch.linalg.eigh(cov))
        components = np.array(evecs[:, ::-1][:, : self.cv_dimension], np.float32)
        components *= np.where(components[0] < 0, -1.0, 1.0).astype(np.float32)
        self.cv = components
        self.explained_variance_ = np.asarray(evals[::-1][: self.cv_dimension])


class TICACalculator(LinearCalculator):
    """Time-lagged independent component analysis."""

    def __init__(self, configuration=None, output_path=None, device=None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "tica"
        self.x_t: Optional[torch.Tensor] = None
        self.x_lag: Optional[torch.Tensor] = None
        logger.info("Creating %s Calculator ...", cv_names_map[self.cv_name])

    def _set_training_data(self, features, traj_labels, feature_names) -> None:
        super()._set_training_data(features, traj_labels, feature_names)
        self.x_t, self.x_lag = self._lag_pairs(self.training_data,
                                               self.training_data_labels)

    def _compute_cv_streaming(self) -> None:
        """StreamingHTICA with one subspace spanning every feature: level 1
        is the full TICA problem on streamed covariances, and level 2 only
        rotates its independent components, so the eigenvalues and the
        spanned subspace are TICA's."""
        lag, reg = self._lagged_config()
        sh = StreamingHTICA(self.num_features, 1, self.cv_dimension, self.cv_dimension,
                            lag, reg, device=self.device)
        try:
            sh.fit(lambda: self._normalized_stream(with_breaks=True))
        except Exception as exc:
            logger.error("TICA could not be computed. Error message: %s", exc)
            return
        self.eigenvalues_ = sh.eigenvalues_
        self.cv = np.asarray(sh.weights, np.float32)

    def compute_cv(self) -> None:
        if self._streaming:
            self._compute_cv_streaming()
            return
        _, reg = self._lagged_config()
        # frame-sharded covariance accumulation over the mesh, given 4
        # pairs a device
        mesh = mesh_for(self.device)
        if self.x_t.shape[0] < 4 * len(mesh):
            mesh = Mesh((self.device,))
        try:
            self.eigenvalues_, self.cv = tica(self.x_t, self.x_lag, self.cv_dimension,
                                              reg=reg, device=self.device, mesh=mesh)
        except Exception as exc:
            logger.error("TICA could not be computed. Error message: %s", exc)


class HTICACalculator(LinearCalculator):
    """Hierarchical TICA (Perez-Hernandez & Noe 2016): TICA per feature
    subspace, the block-diagonal transform, then TICA on the concatenated
    projections."""

    def __init__(self, configuration=None, output_path=None, device=None):
        super().__init__(configuration, output_path, device)
        self.cv_name = "htica"
        self.num_subspaces = self.configuration.get("num_subspaces")
        self.subspaces_dimension = self.configuration.get("subspaces_dimension")
        self.x_t: Optional[torch.Tensor] = None
        self.x_lag: Optional[torch.Tensor] = None
        logger.info("Creating %s Calculator ...", cv_names_map[self.cv_name])

    def _set_training_data(self, features, traj_labels, feature_names) -> None:
        super()._set_training_data(features, traj_labels, feature_names)
        self.x_t, self.x_lag = self._lag_pairs(self.training_data,
                                               self.training_data_labels)

    def _compute_cv_streaming(self) -> None:
        lag, reg = self._lagged_config()
        n_sub = self.num_subspaces
        if not isinstance(n_sub, int) or n_sub < 1:
            logger.error("num_subspaces must be a positive integer for HTICA; got %r.",
                         n_sub)
            return
        # Equal contiguous subspaces: the feature axis is padded with zero
        # columns (their weights are dropped below), so an uneven width
        # blocks differently from the in-memory split_subspaces.
        padded = -(-self.num_features // n_sub) * n_sub
        # With a mesh that divides the subspaces, each device accumulates
        # its own subspaces' moments with no communication; only the
        # level-2 projected covariance crosses devices.
        mesh = mesh_for(self.device)
        if n_sub % len(mesh):
            mesh = Mesh((self.device,))
        if len(mesh) > 1:
            logger.info("Streaming HTICA sharded over %d devices (%d subspaces / device).",
                        len(mesh), n_sub // len(mesh))
        sh = StreamingHTICA(padded, n_sub, self.subspaces_dimension, self.cv_dimension,
                            lag, reg, device=self.device, mesh=mesh)
        try:
            sh.fit(lambda: self._normalized_stream(with_breaks=True, pad_to=padded))
        except Exception as exc:
            logger.error("TICA could not be computed. Error message: %s", exc)
            return
        self.eigenvalues_ = sh.eigenvalues_
        self.cv = np.asarray(sh.weights[: self.num_features], np.float32)

    def compute_cv(self) -> None:
        if self._streaming:
            self._compute_cv_streaming()
            return
        _, reg = self._lagged_config()
        try:
            blocks = split_subspaces(self.num_features, self.num_subspaces)
        except ValueError as exc:
            logger.error("%s", exc)
            return
        level1: List[np.ndarray] = []
        proj_t: List[torch.Tensor] = []
        proj_lag: List[torch.Tensor] = []
        try:
            for cols in blocks:
                lo, hi = int(cols[0]), int(cols[-1]) + 1
                x_t, x_lag = self.x_t[:, lo:hi], self.x_lag[:, lo:hi]
                _, evecs = tica(x_t, x_lag, min(self.subspaces_dimension, hi - lo),
                                reg=reg, device=self.device)
                level1.append(evecs)
                w = torch.as_tensor(evecs, device=self.device)
                proj_t.append(x_t @ w)
                proj_lag.append(x_lag @ w)
            self.eigenvalues_, level2 = tica(torch.cat(proj_t, 1), torch.cat(proj_lag, 1),
                                             self.cv_dimension, reg=reg,
                                             device=self.device)
        except Exception as exc:
            logger.error("TICA could not be computed. Error message: %s", exc)
            return
        # The block-diagonal level-1 transform (features -> level-1 space).
        transform = np.zeros((self.num_features, sum(b.shape[1] for b in level1)),
                             np.float32)
        r = c = 0
        for b in level1:
            transform[r : r + b.shape[0], c : c + b.shape[1]] = b
            r += b.shape[0]
            c += b.shape[1]
        self.cv = transform @ level2
