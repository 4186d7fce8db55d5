"""Feature statistics for the filter and the CV normalization (PyTorch).

The port of the JAX package's stats/descriptors.py: every descriptor is
computed for all features in one pass over a (frames, features) matrix on
the device, feature block by feature block. The entropy histogram is one
`bincount` over the flattened (feature, bin) index, the JAX package's CPU
form (its bin-scan variant is a TPU workaround). Binning matches the JAX
package exactly: float32 `(x - min) / span * num_bins`, truncated, clipped
to the last bin, with span 1 for a constant feature.

Statistics the filter reads are rounded to 3 decimals on the host, as in
the reference. The dip test (`dip_pvalues`) runs on the host: the dip
statistics of all features at once through the OpenMP batch routine of
`stats/csrc/diptest.cpp` (compiled by g++ at first use; a failed build
raises), their p-values from the null table of `stats/dip.py`.

With a mesh of several devices (`parallel.mesh.mesh_for`, set by the
caller's `use_mesh`), entropy and std of a host matrix of at least
`utils.device.SMALL_WORK_ELEMENTS` elements shard the feature axis: each
device's worker copies up and reduces its contiguous slice of every
feature block, and brings the result back, with no collective, as in the
JAX package (which leaves a matrix already on a device where it is).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from deep_cartograph_torch.ops.build import load_host_library
from deep_cartograph_torch.parallel.mesh import Mesh, mesh_for, run_per_device, split
from deep_cartograph_torch.utils import device as device_policy
from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

_DIP_SOURCE = Path(__file__).resolve().parent / "csrc" / "diptest.cpp"

Matrix = Union[np.ndarray, torch.Tensor]

# Feature-block budget: at most this many elements per block, so that a
# 100k-frame x 50k-feature matrix streams through device memory in blocks
# instead of landing whole.
BLOCK_ELEMENT_BUDGET = 200_000_000


def _bin_indices(features: torch.Tensor, num_bins: int) -> torch.Tensor:
    fmin = features.amin(0)
    fmax = features.amax(0)
    span = torch.where(fmax > fmin, fmax - fmin, torch.ones_like(fmax))
    scaled = (features - fmin) / span * num_bins
    return scaled.to(torch.int32).clamp_(0, num_bins - 1)


def _entropy_from_counts(counts: torch.Tensor, n: int) -> torch.Tensor:
    p = counts.to(torch.float32) / n
    logp = torch.where(p > 0, torch.log2(torch.where(p > 0, p, 1.0)), 0.0)
    return -torch.sum(p * logp, dim=1)


def _entropy_all(features: torch.Tensor, num_bins: int = 100) -> torch.Tensor:
    """Shannon entropy (base 2) of each feature's `num_bins`-bin histogram
    (the reference's recipe: p = counts / n, H = -sum p log2 p)."""
    n, n_feat = features.shape
    idx = _bin_indices(features, num_bins).to(torch.int64)
    idx += torch.arange(n_feat, device=features.device) * num_bins
    counts = torch.bincount(idx.reshape(-1), minlength=n_feat * num_bins)
    return _entropy_from_counts(counts.reshape(n_feat, num_bins), n)


def _std_all(features: torch.Tensor) -> torch.Tensor:
    """Population std (two passes, as jnp.std): not torch.std's unbiased
    default."""
    centered = features - features.mean(0, keepdim=True)
    return torch.sqrt(torch.mean(centered * centered, dim=0))


def _minmax_all(features: torch.Tensor):
    return features.amin(0), features.amax(0)


def _feature_mesh(features: Matrix, device: torch.device) -> Mesh:
    """What entropy and std shard the features of a matrix over:
    `mesh_for(device)` for a host matrix of at least
    `SMALL_WORK_ELEMENTS` elements, else `device` alone."""
    on_host = not isinstance(features, torch.Tensor) or features.device.type == "cpu"
    if on_host and features.shape[0] * features.shape[1] >= device_policy.SMALL_WORK_ELEMENTS:
        return mesh_for(device)
    return Mesh((device,))


def _block_starts(features: Matrix) -> range:
    """The first column of each feature block of at most
    BLOCK_ELEMENT_BUDGET elements."""
    n, f = features.shape
    return range(0, f, max(1, min(f, BLOCK_ELEMENT_BUDGET // max(n, 1))))


def _device_blocks(features: Matrix, device: torch.device):
    """float32 feature blocks of at most BLOCK_ELEMENT_BUDGET elements, on
    `device`."""
    starts = _block_starts(features)
    for start in starts:
        yield torch.as_tensor(features[:, start : start + starts.step]).to(device).float()


def _per_feature(features: Matrix, device: torch.device, reduce) -> np.ndarray:
    """reduce(block) of every float32 feature block, on the host, in
    feature order. Over `_feature_mesh`, each entry's worker copies up,
    reduces and brings back its contiguous slice of every block (None for
    an empty slice)."""
    mesh = _feature_mesh(features, device)
    starts = _block_starts(features)

    def run(dev, column):
        out = []
        for start in starts:
            part = split(features[:, start : start + starts.step], mesh, axis=1)[column]
            out.append(reduce(part.to(dev).float()).cpu().numpy() if part.shape[1] else None)
        return out

    per_device = run_per_device(run, mesh, range(len(mesh)))
    # block by block, each block's slices in mesh order
    return np.concatenate([parts[b] for b in range(len(starts)) for parts in per_device
                           if parts[b] is not None])


def shannon_entropy(
    features: Matrix, num_bins: int = 100, device: DeviceLike = None
) -> np.ndarray:
    """Per-feature entropy, rounded to 3 decimals like the reference.
    `device`: None means CUDA (raises without a card); "cpu" runs on the
    host."""
    dev = resolve_device(device)
    return np.round(_per_feature(features, dev, lambda b: _entropy_all(b, num_bins)), 3)


def standard_deviation(features: Matrix, device: DeviceLike = None) -> np.ndarray:
    """Per-feature population std, rounded to 3 decimals like the
    reference."""
    return np.round(_per_feature(features, resolve_device(device), _std_all), 3)


def feature_statistics(
    features: Matrix, device: DeviceLike = None
) -> Dict[str, np.ndarray]:
    """mean/std/min/max of every feature, computed in float32 on the device
    and returned as float64 (the CV normalization's input)."""
    dev = resolve_device(device)
    parts: Dict[str, List[np.ndarray]] = {"mean": [], "std": [], "min": [], "max": []}
    for block in _device_blocks(features, dev):
        fmin, fmax = _minmax_all(block)
        for key, value in (("mean", block.mean(0)), ("std", _std_all(block)),
                           ("min", fmin), ("max", fmax)):
            parts[key].append(value.cpu().numpy())
    return {k: np.concatenate(v).astype(np.float64) for k, v in parts.items()}


def min_value_filter(
    features: Matrix, threshold: float, device: DeviceLike = None
) -> List[bool]:
    """True where a feature's minimum is <= threshold
    (cf. reference statistics.py:487-511)."""
    dev = resolve_device(device)
    mins = torch.as_tensor(features).to(dev).amin(0).cpu().numpy()
    return [bool(v <= threshold) for v in mins]


def _host_matrix(features: Matrix) -> np.ndarray:
    x = features.cpu().numpy() if isinstance(features, torch.Tensor) else features
    return np.asarray(x)


def dip_statistics_batch(features: Matrix) -> np.ndarray:
    """Hartigan's dip statistic of every column of a (samples, features)
    matrix, in float64, by the native batch routine (OpenMP over features)."""
    lib = load_host_library(_DIP_SOURCE)
    lib.dip_statistics_batch.restype = None
    lib.dip_statistics_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    x = _host_matrix(features)
    if x.ndim != 2:
        raise ValueError(f"features must be (samples, features), got {x.shape}")
    n_samples, n_features = x.shape
    # the routine reads (features, samples) rows
    cols = np.ascontiguousarray(x.T, dtype=np.float64)
    out = np.empty(n_features, np.float64)
    lib.dip_statistics_batch(cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             n_features, n_samples,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def dip_pvalues(features: Matrix) -> np.ndarray:
    """Hartigan dip-test p-value of every feature (host): the batch dip
    statistics, each turned into a p-value by the null table."""
    from deep_cartograph_torch.stats.dip import pvalue_from_dip

    x = _host_matrix(features)
    return np.asarray([pvalue_from_dip(d, x.shape[0]) for d in dip_statistics_batch(x)])


def dip_pvalues_plain(features: Matrix) -> np.ndarray:
    """The plain version of `dip_pvalues`: the Python dip, one feature at a
    time."""
    from deep_cartograph_torch.stats.dip import dip_pvalue

    x = _host_matrix(features)
    return np.asarray([dip_pvalue(x[:, j])[1] for j in range(x.shape[1])])


def quantile_mask(values: np.ndarray, quantile: float) -> np.ndarray:
    """The filter's quantile screen (the JAX package's `Filter.run`): keep
    the features whose statistic is not below its `quantile` (pandas'
    default linear interpolation)."""
    values = np.asarray(values)
    return values >= np.quantile(values, quantile)


def difference_filter(
    features: np.ndarray, feature_names: List[str]
) -> List[bool]:
    """Per-feature-type variation screen across waypoint samples
    (cf. reference statistics.py:382-485).

    sin/cos pairs: max angular spread >= pi/8; tor: range >= pi/8;
    coord triplets: max pairwise 3-D displacement >= 0.2 nm; other: range
    >= 0.2 nm.
    """
    angle_threshold = np.pi / 8
    distance_threshold = 0.2

    features = np.asarray(features)
    if features.size == 0:
        return []

    name_to_col = {n: j for j, n in enumerate(feature_names)}
    result: Dict[str, bool] = {}
    atoms_touched = set()

    for name in feature_names:
        parts = name.split("-")
        if len(parts) <= 1:
            continue
        ftype = parts[0]
        col = features[:, name_to_col[name]]

        if ftype == "sin":
            cos_name = name.replace("sin", "cos", 1)
            if cos_name in name_to_col:
                angles = np.arctan2(col, features[:, name_to_col[cos_name]]) + np.pi
                delta = np.abs(np.max(angles) - np.min(angles))
            else:
                delta = 10.0  # orphan sine: keep (cf. statistics.py:429-431)
            passed = bool(delta >= angle_threshold)
            result[name] = passed
            result[cos_name] = passed
        elif ftype == "cos":
            continue  # handled with its sine twin
        elif ftype == "tor":
            delta = np.max(col) - np.min(col)
            result[name] = bool(delta >= angle_threshold)
        elif ftype == "coord":
            atom = parts[1].split(".")[0]
            if atom in atoms_touched:
                continue
            atoms_touched.add(atom)
            xyz = []
            axis_names = [f"coord-{atom}.{ax}" for ax in ("x", "y", "z")]
            for an in axis_names:
                xyz.append(
                    features[:, name_to_col[an]]
                    if an in name_to_col
                    else np.zeros(features.shape[0])
                )
            pts = np.stack(xyz, axis=1)
            diffs = pts[:, None, :] - pts[None, :, :]
            delta = float(np.sqrt((diffs**2).sum(-1)).max())
            passed = bool(delta >= distance_threshold)
            for an in axis_names:
                if an in name_to_col:
                    result[an] = passed
        else:
            delta = np.abs(np.max(col) - np.min(col))
            result[name] = bool(delta >= distance_threshold)

    return [result.get(n, True) for n in feature_names]
