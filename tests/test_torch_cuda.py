"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them they skip. They
import no JAX, so on a machine without it they run past the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deep_cartograph_torch.cv.deep import DeepTICACalculator
from deep_cartograph_torch.ops import kde as torch_kde
from deep_cartograph_torch.ops import pair_distances as torch_pd
from deep_cartograph_torch.ops import pairwise_distance_matrix as torch_pdm
from deep_cartograph_torch.stats import descriptors

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "C,N,P",
    [(1, 4, 1), (37, 48, 1081), (1000, 48, 1081), (9, 5000, 3000), (300, 700, 513)],
)
def test_pair_distances_kernel_matches_plain(cuda, C, N, P):
    rng = np.random.default_rng(C + N + P)
    points = torch.tensor(
        rng.normal(30, 10, (C, N, 3)).astype(np.float32), device=cuda
    )
    pairs = torch.tensor(
        rng.integers(0, N, (P, 2)).astype(np.int32), device=cuda
    )
    before = torch_pd.STATS.launches
    got = torch_pd.pair_distances(points, pairs)
    torch.cuda.synchronize()
    assert torch_pd.STATS.launches == before + 1
    want = torch_pd.pair_distances_plain(points, pairs)
    assert got.shape == (C, P)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_pair_distances_kernel_gives_nan_outside_range(cuda):
    rng = np.random.default_rng(11)
    points = torch.tensor(rng.normal(30, 10, (19, 48, 3)).astype(np.float32), device=cuda)
    pairs = torch.tensor(
        [[0, 48], [3, 7], [-1, 2], [47, 0], [2**30, 1]], dtype=torch.int32, device=cuda
    )
    got = torch_pd.pair_distances(points, pairs)
    want = torch_pd.pair_distances_plain(points, pairs)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0, equal_nan=True)
    assert torch.isnan(got[:, [0, 2, 4]]).all()
    assert torch.isfinite(got[:, [1, 3]]).all()


@pytest.mark.parametrize("D", range(1, 9))
@pytest.mark.parametrize("G,N", [(1, 1), (150, 100_000), (22_500, 5_000), (1000, 513)])
def test_kde_logsumexp_kernel_matches_plain(cuda, D, G, N):
    rng = np.random.default_rng(D * 7 + G + N)
    grid = torch.tensor(rng.uniform(-1, 1, (G, D)).astype(np.float32), device=cuda)
    samples = torch.tensor(rng.normal(0, 0.4, (N, D)).astype(np.float32), device=cuda)
    inv_two_bw2 = 1.0 / (2 * 0.05**2)
    got = torch_kde.kde_logsumexp(grid, samples, inv_two_bw2)
    torch.cuda.synchronize()
    scale = float(np.sqrt(np.float32(inv_two_bw2)))
    want = torch_kde.kde_logsumexp_plain(grid * scale, samples * scale)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_kde_ragged_samples_contribute_nothing(cuda):
    """Samples past N are never visited: a call on the first n samples of
    a longer buffer equals the plain version on exactly those n."""
    rng = np.random.default_rng(5)
    grid = torch.tensor(rng.uniform(-1, 1, (300, 2)).astype(np.float32), device=cuda)
    buf = torch.tensor(rng.normal(0, 0.4, (4096, 2)).astype(np.float32), device=cuda)
    n = 1537  # not a multiple of the 512-sample tile
    got = torch_kde.kde_logsumexp(grid, buf[:n], 200.0)
    want = torch_kde.kde_logsumexp_plain(grid * 200.0**0.5, buf[:n] * 200.0**0.5)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("F,A", [(3, 1), (5, 31), (256, 1000), (2, 129)])
def test_pairwise_distance_matrix_kernel_matches_plain(cuda, F, A):
    rng = np.random.default_rng(F + A)
    coords = torch.tensor((rng.standard_normal((F, A, 3)) * 10).astype(np.float32),
                          device=cuda)
    before = torch_pdm.STATS.launches
    got = torch_pdm.pairwise_distance_matrix(coords)
    torch.cuda.synchronize()
    assert torch_pdm.STATS.launches == before + 1
    want = torch_pdm.pairwise_distance_matrix_plain(coords)
    assert got.shape == (F, A, A)
    # float32 sums of three squares, contracted to FMAs by nvcc: 1e-5
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)
    assert bool((torch.diagonal(got, dim1=1, dim2=2) == 0).all())


def _toy_features(n=3000, d=20, seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, d)), 0) * 0.05
    return (np.sin(x) + 0.1 * rng.standard_normal((n, d))).astype(np.float32)


def test_statistics_on_the_card_match_the_cpu(cuda):
    x = _toy_features()
    for fn in (descriptors.shannon_entropy, descriptors.standard_deviation):
        # rounded to 3 decimals: equal, or one unit apart at a boundary
        np.testing.assert_allclose(fn(x), fn(x, device="cpu"), atol=1.0001e-3)
    got = descriptors.feature_statistics(x)
    want = descriptors.feature_statistics(x, device="cpu")
    for key in got:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)


def test_deep_tica_training_on_the_card_matches_the_cpu(cuda):
    """The same seeded training (3 tries, 4 epochs) by the port on the card
    and on the CPU: the same initial parameters and batches, float32 sums in
    another order."""
    config = {
        "dimension": 2, "lag_time": 5, "features_normalization": "mean_std",
        "architecture": {"encoder": {"layers": [32, 32],
                                     "activation": ["tanh", "tanh"]}},
        "training": {"general": {"num_tries": 3, "batch_size": 256,
                                 "max_epochs": 4},
                     "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}}},
    }
    x = _toy_features()
    runs = []
    for device in ("cuda", "cpu"):
        calc = DeepTICACalculator(config, device=device)
        calc._set_training_data(x, None, [f"f{i}" for i in range(x.shape[1])])
        assert calc.train()
        calc.normalize_cv()
        runs.append(calc)
    card, host = runs
    for (_, a), (_, b) in zip(card.try_results, host.try_results):
        np.testing.assert_allclose(a.metrics["train_loss"], b.metrics["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a.metrics["valid_loss"], b.metrics["valid_loss"],
                                   rtol=1e-4)
    np.testing.assert_allclose(card.project_data(x), host.project_data(x), atol=1e-4)
