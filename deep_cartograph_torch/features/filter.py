"""Feature filtering: entropy / std / dip-test / waypoint screens (PyTorch).

The port of the JAX package's features/filter.py: the colvars files are
read once into one (frames, features) matrix, and every statistic is
computed for all features in one pass. Entropy and std run on the device
(`stats/descriptors.py`); the dip test runs on the host. Past
DEEP_CARTO_STREAM_BYTES the statistics stream from the files instead, as
on the JAX side. The per-feature table is a dict of numpy columns, and
`filter_summary.csv` is written without pandas.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from deep_cartograph_torch.features.translator import Translator
from deep_cartograph_torch.io.colvars import (
    iter_features_chunks,
    read_column_names,
    read_features,
    should_stream_colvars,
    translation_is_identity,
)
from deep_cartograph_torch.stats.descriptors import (
    difference_filter,
    dip_pvalues,
    min_value_filter,
    shannon_entropy,
    standard_deviation,
)
from deep_cartograph_torch.utils.common import save_list
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


class Filter:
    def __init__(
        self,
        settings: Dict,
        colvars_paths: List[str],
        waypoint_colvars_paths: Optional[List[str]] = None,
        topologies: Optional[List[str]] = None,
        waypoint_topologies: Optional[List[str]] = None,
        reference_topology: Optional[str] = None,
        output_dir: str = "filter_features",
        device: DeviceLike = None,
    ) -> None:
        """`device`: None means CUDA (raises without a card); "cpu" runs the
        statistics on the host."""
        self.device = resolve_device(device)
        self.colvars_paths = colvars_paths
        self.waypoint_colvars_paths = waypoint_colvars_paths
        self.output_dir = output_dir
        if topologies and reference_topology is None:
            reference_topology = topologies[0]
        self.topology_paths = topologies
        self.waypoint_topologies = waypoint_topologies
        self.ref_topology_path = reference_topology

        if self.topology_paths and len(self.colvars_paths) != len(self.topology_paths):
            logger.error(
                "The number of colvars files must equal the number of topology files."
            )
            sys.exit(1)

        self.common_ref_features = self.find_common_features()
        logger.info("Initial size of features set (only common features): %d.",
                    len(self.common_ref_features))
        os.makedirs(self.output_dir, exist_ok=True)
        save_list(self.common_ref_features,
                  os.path.join(self.output_dir, "all_features.txt"))

        # The distance threshold is given in Angstrom; features are in nm.
        dist_threshold_angstrom = settings.get("local_distance_threshold", None)
        self.local_distance_threshold: Optional[float] = (
            dist_threshold_angstrom / 10 if dist_threshold_angstrom is not None else None
        )
        self.diptest_significance_level = settings.get("diptest_significance_level")
        self.entropy_quantile = settings.get("entropy_quantile")
        self.std_quantile = settings.get("std_quantile")

        self.diptest_filter = self.diptest_significance_level is not None
        self.entropy_filter = self.entropy_quantile is not None
        self.std_filter = self.std_quantile is not None
        self.local_contact_filter = self.local_distance_threshold is not None
        self.filter_features = (
            self.diptest_filter or self.entropy_filter or self.std_filter
            or self.waypoint_colvars_paths is not None
        )
        # One column per screen, in the order they are added (the summary's).
        self.features_data: Dict[str, np.ndarray] = {
            "name": np.asarray(self.common_ref_features, dtype=object),
            "pass": np.ones(len(self.common_ref_features), bool),
        }

    def find_common_features(self) -> List[str]:
        """The (translated) colvars headers' features common to every file."""
        common: Optional[List[str]] = None
        for ci, colvars_path in enumerate(self.colvars_paths):
            names = read_column_names(colvars_path, features_only=True)
            if self.topology_paths:
                translated = Translator(
                    self.topology_paths[ci], self.ref_topology_path, names
                ).run()
                for fi, t in enumerate(translated):
                    if t is None:
                        logger.warning(
                            "Feature %s from %s not found in the reference topology.",
                            names[fi], Path(colvars_path).name,
                        )
                ref_names = [t for t in translated if t is not None]
            else:
                ref_names = names
            # an empty intersection stays empty
            common = ref_names if common is None else [f for f in common if f in ref_names]
        if not common:
            logger.error("No common features found in the colvars files.")
            sys.exit(1)
        return list(common)

    def _read_all(self, colvars_paths, topologies) -> np.ndarray:
        arr = read_features(colvars_paths, ref_feature_names=self.common_ref_features,
                            topology_paths=topologies,
                            reference_topology=self.ref_topology_path)
        if np.isnan(arr).any():
            raise ValueError("Clean your data! NaNs found in the colvars files.")
        return arr

    # -- inputs past DEEP_CARTO_STREAM_BYTES: stream the statistics --------
    def _should_stream_stats(self) -> bool:
        if not translation_is_identity(self.topology_paths, self.ref_topology_path):
            return False
        return should_stream_colvars(self.colvars_paths, "auto")

    def _stream_chunks(self, feature_names: List[str]):
        for path in self.colvars_paths:
            yield from iter_features_chunks(path, feature_names=feature_names,
                                            nan_check=True)

    def _compute_stats_streaming(self) -> None:
        """std from float64 moments, entropy from exact histogram counts over
        the global min/max (the binning of stats.descriptors), the dip test
        from feature-block column passes."""
        names = self.common_ref_features
        F = len(names)
        num_bins = 100
        logger.info("Streaming filter statistics: %d features over %d file(s).",
                    F, len(self.colvars_paths))
        n = 0
        s1 = np.zeros(F, np.float64)
        s2 = np.zeros(F, np.float64)
        mn = np.full(F, np.inf, np.float32)
        mx = np.full(F, -np.inf, np.float32)
        for blk in self._stream_chunks(names):
            b64 = blk.astype(np.float64)
            n += blk.shape[0]
            s1 += b64.sum(axis=0)
            s2 += (b64 * b64).sum(axis=0)
            np.minimum(mn, blk.min(axis=0), out=mn)
            np.maximum(mx, blk.max(axis=0), out=mx)
        if n == 0:
            logger.error("The resulting dataframe is empty.")
            sys.exit(1)
        if self.std_filter:
            mean = s1 / n
            var = np.maximum(s2 / n - mean * mean, 0.0)
            self.features_data["std"] = np.round(np.sqrt(var), 3)

        if self.entropy_filter:
            span = np.where(mx > mn, mx - mn, np.float32(1.0)).astype(np.float32)
            counts = np.zeros(F * num_bins, np.int64)
            col_base = (np.arange(F, dtype=np.int64) * num_bins)[None, :]
            for blk in self._stream_chunks(names):
                idx = np.clip(((blk - mn) / span * num_bins).astype(np.int32),
                              0, num_bins - 1).astype(np.int64)
                counts += np.bincount((idx + col_base).ravel(), minlength=F * num_bins)
            p = counts.reshape(F, num_bins) / n
            with np.errstate(divide="ignore", invalid="ignore"):
                plogp = np.where(p > 0, p * np.log2(np.where(p > 0, p, 1.0)), 0.0)
            self.features_data["entropy"] = np.round(-plogp.sum(axis=1), 3)

        if self.diptest_filter:
            block_budget = 256 * 2**20
            K = max(int(block_budget // max(4 * n, 1)), 1)
            hdtp = np.empty(F, np.float64)
            for s in range(0, F, K):
                sub = names[s : s + K]
                cols = np.concatenate(list(self._stream_chunks(sub)), axis=0)
                hdtp[s : s + len(sub)] = dip_pvalues(cols)
            self.features_data["hdtp"] = hdtp

    def _fail(self, mask) -> None:
        self.features_data["pass"] &= ~np.asarray(mask, bool)

    def run(self, csv_summary: bool = False) -> List[str]:
        """Apply every requested screen; returns the surviving names."""
        names = self.common_ref_features
        data = self.features_data
        if self.filter_features:
            if self.waypoint_colvars_paths is not None:
                waypoints = self._read_all(self.waypoint_colvars_paths,
                                           self.waypoint_topologies)
                data["waypoint_difference"] = np.asarray(
                    difference_filter(waypoints, names), bool)
                self._fail(~data["waypoint_difference"])
                if self.local_contact_filter:
                    data["is_local_contact"] = np.asarray(min_value_filter(
                        waypoints, self.local_distance_threshold, self.device), bool)
                    self._fail(~data["is_local_contact"])

            if self.entropy_filter or self.std_filter or self.diptest_filter:
                if self._should_stream_stats():
                    self._compute_stats_streaming()
                else:
                    matrix = self._read_all(self.colvars_paths, self.topology_paths)
                    if self.entropy_filter:
                        data["entropy"] = shannon_entropy(matrix, device=self.device)
                    if self.std_filter:
                        data["std"] = standard_deviation(matrix, device=self.device)
                    if self.diptest_filter:
                        data["hdtp"] = dip_pvalues(matrix)

        # Quantile thresholds: numpy's quantile is pandas' default (linear).
        if self.entropy_filter and self.entropy_quantile > 0:
            thr = np.quantile(data["entropy"], self.entropy_quantile)
            logger.info("    Entropy threshold: %.2f bits (quantile: %.2f)",
                        thr, self.entropy_quantile)
            self._fail(data["entropy"] < thr)
        if self.std_filter and self.std_quantile > 0:
            thr = np.quantile(data["std"], self.std_quantile)
            logger.info("    Standard deviation threshold: %.2f a.u. (quantile: %.2f)",
                        thr, self.std_quantile)
            self._fail(data["std"] < thr)
        if self.diptest_filter and self.diptest_significance_level > 0:
            self._fail(data["hdtp"] > self.diptest_significance_level)

        if csv_summary:
            write_summary_csv(data, os.path.join(self.output_dir, "filter_summary.csv"))

        keep = data["pass"]
        self.features_data = {k: v[keep] for k, v in data.items()}
        final = [str(n) for n in self.features_data["name"]]
        logger.info("Filtered %d features.", len(names) - len(final))
        return final


def write_summary_csv(columns: Dict[str, np.ndarray], path: str) -> None:
    """A comma-separated table with a header row, values as pandas writes
    them (True/False, shortest float repr)."""
    def cell(v) -> str:
        if isinstance(v, (bool, np.bool_)):
            return str(bool(v))
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return str(v)

    keys = list(columns)
    with open(path, "w") as fh:
        fh.write(",".join(keys) + "\n")
        for i in range(len(columns[keys[0]])):
            fh.write(",".join(cell(columns[k][i]) for k in keys) + "\n")
