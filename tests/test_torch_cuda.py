"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them they skip. They
import no JAX, so on a machine without it they run past the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deep_cartograph_torch.ops import kde as torch_kde
from deep_cartograph_torch.ops import pair_distances as torch_pd

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
