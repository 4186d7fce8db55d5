"""Port FES (fes/kde.py) against the JAX package's compute_fes and its
streaming branch."""

import numpy as np
import pytest
import torch

from deep_cartograph_tpu.fes import kde as jax_fes
from deep_cartograph_torch.fes import kde as torch_fes
from deep_cartograph_torch.ops import kde as torch_kde

torch.set_num_threads(2)


def _cv_data(n, d, seed=0):
    """Two-basin CV samples."""
    rng = np.random.default_rng(seed)
    centers = np.array([[-0.5, 0.3], [0.4, -0.2]])[:, :d]
    labels = rng.integers(0, 2, n)
    return (centers[labels] + rng.normal(0, 0.15, (n, d))).astype(np.float32)


@pytest.mark.parametrize(
    "d,num_bins,num_blocks", [(1, 100, 1), (1, 60, 7), (2, 30, 1), (2, 25, 4)]
)
def test_compute_fes_dense_matches_jax(d, num_bins, num_blocks):
    data = _cv_data(2003, d)
    axes_w, fes_w, err_w = jax_fes.compute_fes(
        data, bandwidth=0.05, num_bins=num_bins, num_blocks=num_blocks
    )
    axes, fes, err = torch_fes.compute_fes(
        data, bandwidth=0.05, num_bins=num_bins, num_blocks=num_blocks, device="cpu"
    )
    for a, b in zip(axes, axes_w):
        np.testing.assert_array_equal(a, b)
    assert fes.shape == fes_w.shape
    assert fes.min() == 0.0
    np.testing.assert_allclose(fes, fes_w, atol=1e-3)
    if num_blocks == 1:
        assert err is None and err_w is None
    else:
        np.testing.assert_allclose(err, err_w, atol=1e-3)


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_kde_fes_streaming_matches_jax(num_blocks):
    data = _cv_data(3000, 2, seed=1)
    axis = np.linspace(-1, 1, 20, dtype=np.float32)
    gx, gy = np.meshgrid(axis, axis, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], 1)
    kt = torch_fes.KB_KJ_MOL * 300.0
    fes_w, err_w = jax_fes._kde_fes_streaming(data, grid, 0.05, kt, num_blocks)
    fes, err = torch_fes._kde_fes_streaming(data, grid, 0.05, kt, num_blocks, "cpu")
    np.testing.assert_allclose(fes, fes_w, atol=1e-3)
    if num_blocks == 1:
        assert err is None and err_w is None
    else:
        np.testing.assert_allclose(err, err_w, atol=1e-3)


def test_compute_fes_takes_streaming_branch_above_threshold():
    data = _cv_data(8000, 2, seed=2)
    assert 80 * 80 * 8000 > torch_fes.STREAMING_THRESHOLD
    before = torch_kde.STATS.plain_calls
    _, fes, err = torch_fes.compute_fes(data, num_bins=80, num_blocks=2, device="cpu")
    assert torch_kde.STATS.plain_calls == before + 2  # one call per block
    assert fes.shape == err.shape == (80, 80)
    assert np.isfinite(fes).all() and fes.min() == 0.0

    # below the threshold the dense branch runs and K2 is not called
    _, small, _ = torch_fes.compute_fes(data[:1000], num_bins=80, device="cpu")
    assert torch_kde.STATS.plain_calls == before + 2
    assert small.shape == (80, 80)
