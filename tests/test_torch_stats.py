"""Port filter statistics (stats/descriptors.py) against the JAX package's,
on the same numpy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.stats import descriptors as jax_stats
from deep_cartograph_torch.stats import descriptors as torch_stats

torch.set_num_threads(2)


def _features(seed=0, n=2000, f=37):
    """Mixed-scale features with a constant column and values placed exactly
    on bin edges (min + k * span / 100)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, f)).astype(np.float32) * rng.uniform(0.01, 5, f).astype(np.float32)
    x[:, 3] = 1.25                              # constant: span 1, all in bin 0
    x[:, 5] = np.round(rng.uniform(0, 1, n), 2)  # 0.00, 0.01, ...: on bin edges
    lo, hi = x[:, 7].min(), x[:, 7].max()
    edges = lo + (hi - lo) * np.arange(101, dtype=np.float32) / 100
    x[: len(edges), 7] = edges.astype(np.float32)  # every edge, min and max kept
    return x


def test_bin_counts_and_entropy_match_jax():
    x = _features()
    num_bins = 100
    want_idx = np.asarray(jax_stats._bin_indices(jnp.asarray(x), num_bins))
    got_idx = torch_stats._bin_indices(torch.from_numpy(x), num_bins).numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    want_counts = np.stack(
        [np.bincount(want_idx[:, j], minlength=num_bins) for j in range(x.shape[1])]
    )
    got_counts = np.stack(
        [np.bincount(got_idx[:, j], minlength=num_bins) for j in range(x.shape[1])]
    )
    np.testing.assert_array_equal(got_counts, want_counts)
    want = np.asarray(jax_stats._entropy_scatter(jnp.asarray(x), num_bins))
    got = torch_stats._entropy_all(torch.from_numpy(x), num_bins).numpy()
    assert got[3] == 0.0
    # float32 sums of p log2 p in another order
    np.testing.assert_allclose(got, want, atol=1e-6)


def _assert_equal_after_rounding(got_rounded, want_unrounded, atol=2e-6):
    """Rounded to 3 decimals, the port equals the JAX package, except where
    the JAX value lies within `atol` (the float32 differences of the two
    packages' log2 and sums) of a rounding boundary: there the two may land
    one unit (0.001) apart."""
    want_unrounded = np.asarray(want_unrounded, np.float64)
    want = np.round(want_unrounded, 3)
    differ = got_rounded != np.round(want_unrounded.astype(np.float32), 3)
    to_boundary = np.abs(np.abs(want_unrounded * 1e3 % 1.0) - 0.5) * 1e-3
    assert np.all(to_boundary[differ] < atol), np.nonzero(differ)
    np.testing.assert_allclose(got_rounded, want, atol=1.0001e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounded_entropy_and_std_equal(seed):
    x = _features(seed)
    _assert_equal_after_rounding(
        torch_stats.shannon_entropy(x, device="cpu"),
        np.asarray(jax_stats._entropy_scatter(jnp.asarray(x), 100)),
    )
    _assert_equal_after_rounding(
        torch_stats.standard_deviation(x, device="cpu"),
        np.asarray(jax_stats._std_all(jnp.asarray(x))),
    )
    # where no value is that close to a boundary, the rounded arrays of the
    # two packages' public functions are equal
    np.testing.assert_array_equal(
        torch_stats.standard_deviation(x[:, 3:5], device="cpu"),
        jax_stats.standard_deviation(x[:, 3:5]),
    )


def test_feature_blocks_give_the_same_statistics(monkeypatch):
    x = _features(3)
    whole = torch_stats.shannon_entropy(x, device="cpu")
    whole_std = torch_stats.standard_deviation(x, device="cpu")
    monkeypatch.setattr(torch_stats, "BLOCK_ELEMENT_BUDGET", 5 * x.shape[0])
    np.testing.assert_array_equal(torch_stats.shannon_entropy(x, device="cpu"), whole)
    np.testing.assert_array_equal(
        torch_stats.standard_deviation(x, device="cpu"), whole_std
    )


def test_std_is_the_population_std():
    x = np.array([[1.0], [3.0]], np.float32)
    np.testing.assert_array_equal(torch_stats.standard_deviation(x, device="cpu"), [1.0])


def test_feature_statistics_match_jax():
    x = _features(4)
    want = jax_stats.feature_statistics(x)
    got = torch_stats.feature_statistics(torch.from_numpy(x), device="cpu")
    for key in ("mean", "std", "min", "max"):
        assert got[key].dtype == np.float64
        # float32 reductions in another order
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=1e-6)


def test_min_value_and_difference_filters_equal():
    rng = np.random.default_rng(5)
    names = [
        "dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9",
        "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_1-@CA_2-@CA_3-@CA_4",
        "sin-@CA_2-@CA_3-@CA_4-@CA_5",
        "tor-@CA_3-@CA_4-@CA_5-@CA_6",
        "coord-@CA_1.x", "coord-@CA_1.y", "coord-@CA_1.z", "coord-@CA_2.x",
    ]
    waypoints = rng.uniform(0, 1, (6, len(names))).astype(np.float32)
    waypoints[:, 1] = 0.4 + 0.01 * rng.uniform(0, 1, 6)   # small range: fails
    waypoints[:, 5] = 0.1 * rng.uniform(0, 1, 6)          # small torsion range
    angles = np.linspace(0, 0.2, 6)                        # tiny angular spread
    waypoints[:, 2], waypoints[:, 3] = np.sin(angles), np.cos(angles)
    assert torch_stats.difference_filter(waypoints, names) == \
        jax_stats.difference_filter(waypoints, names)
    assert torch_stats.difference_filter(np.zeros((0, 2)), names[:2]) == []
    for threshold in (0.05, 0.3, 0.5):
        assert torch_stats.min_value_filter(waypoints, threshold, device="cpu") == \
            jax_stats.min_value_filter(waypoints, threshold)


def test_quantile_mask_follows_the_filter_rule():
    import pandas as pd

    rng = np.random.default_rng(6)
    std = np.round(rng.uniform(0, 1, 41), 3)
    std[:5] = std[5]  # ties at the threshold are kept
    for q in (0.25, 0.5, 0.9):
        keep = torch_stats.quantile_mask(std, q)
        thr = pd.Series(std).quantile(q=q)
        np.testing.assert_array_equal(keep, std >= thr)
