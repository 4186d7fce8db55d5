"""Port kernels K1, K2 and K3 against the JAX package's Pallas kernels (interpret
mode on the CPU). On the CPU the port's wrappers run their plain PyTorch
versions; the CUDA kernels themselves are held to those versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.ops import pallas_kernels as jax_ops
from deep_cartograph_torch.ops import kde as torch_kde
from deep_cartograph_torch.ops import pair_distances as torch_pd
from deep_cartograph_torch.ops import pairwise_distance_matrix as torch_pdm

torch.set_num_threads(2)


def _selector_setup(rng):
    """The setup of tests/test_pallas_ops.py::test_selector_pair_distances_kernel,
    padded zero columns included."""
    F, A = 512, 16
    ii, jj = np.triu_indices(A, k=2)
    P = len(ii)
    Ppad = 128 * ((P + 127) // 128)
    sel = np.zeros((A, Ppad), np.float32)
    sel[ii, np.arange(P)] += 1
    sel[jj, np.arange(P)] -= 1
    coords = (rng.standard_normal((F, A, 3)) * 10 + 30).astype(np.float32)
    return coords, sel, P


def test_selector_pair_distances_matches_jax_kernel():
    coords, sel, P = _selector_setup(np.random.default_rng(42))
    want = np.asarray(
        jax_ops.selector_pair_distances(
            jnp.asarray(coords), jnp.asarray(sel), tile_f=256, tile_p=128
        )
    )
    before = torch_pd.STATS.plain_calls
    got = torch_pd.selector_pair_distances(
        torch.from_numpy(coords), torch.from_numpy(sel)
    ).numpy()
    assert torch_pd.STATS.plain_calls == before + 1
    assert got.shape == want.shape == (coords.shape[0], sel.shape[1])
    np.testing.assert_allclose(got, want, atol=1e-5)
    # padded all-zero columns give exactly 0, as in the JAX kernel
    assert np.all(got[:, P:] == 0.0)


@pytest.mark.parametrize(
    "column",
    [[1, 1, 0, 0], [1, 0, 0, 0], [1, -1, -1, 0], [2, -2, 0, 0], [0.5, -1, 0, 0]],
)
def test_selector_with_bad_column_raises(column):
    sel = np.zeros((4, 3), np.float32)
    sel[0, 0], sel[1, 0] = 1, -1
    sel[:, 1] = column
    coords = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="selector columns \\[1\\]"):
        torch_pd.selector_pair_distances(coords, torch.from_numpy(sel))


def test_pair_distances_rejects_bad_inputs():
    coords = torch.ones((2, 4, 3))
    coords[:, 1] = 0.0
    # indices are not checked per call: a pair outside [0, N) gives NaN
    pairs = torch.tensor([[0, 4], [0, 1], [-1, 2]], dtype=torch.int32)
    got = torch_pd.pair_distances(coords, pairs)
    assert torch.isnan(got[:, [0, 2]]).all()
    torch.testing.assert_close(got[:, 1], torch.full((2,), 0.1 * 3**0.5))
    with pytest.raises(IndexError):
        torch_pd.selector_pair_distances(coords, torch.zeros((5, 2)))
    with pytest.raises(TypeError):
        torch_pd.pair_distances(coords, torch.tensor([[0, 1]]))
    with pytest.raises(TypeError):
        torch_pd.pair_distances(coords.double(), torch.tensor([[0, 1]], dtype=torch.int32))


@pytest.mark.parametrize("n,d", [(700, 2), (3001, 1)])
def test_kde_logsumexp_matches_jax_kernel(n, d):
    rng = np.random.default_rng(n)
    samples = rng.standard_normal((n, d)).astype(np.float32)
    grid = rng.standard_normal((120, d)).astype(np.float32)
    inv_two_bw2 = 1.0 / (2 * 0.3 * 0.3)
    # ragged N: n is not a multiple of the JAX sample block (padding rows)
    want = np.asarray(
        jax_ops.kde_logsumexp(grid, samples, inv_two_bw2, tile=128, sample_block=256)
    )
    got = torch_kde.kde_logsumexp(
        torch.from_numpy(grid), torch.from_numpy(samples), inv_two_bw2
    ).numpy()
    # summation order differs (blocks of 2048 vs 256)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kde_logsumexp_rejects_bad_inputs():
    grid = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        torch_kde.kde_logsumexp(grid, torch.zeros((3, 1)), 1.0)
    with pytest.raises(ValueError):
        torch_kde.kde_logsumexp(torch.zeros((4, 9)), torch.zeros((3, 9)), 1.0)
    with pytest.raises(ValueError):
        torch_kde.kde_logsumexp(grid, torch.zeros((0, 2)), 1.0)


@pytest.mark.parametrize("A", [1, 50, 300])
def test_pairwise_distance_matrix_matches_jax_kernel(A):
    """K3's plain version against the Pallas kernel in interpret mode, A
    ragged against the 128-atom tile."""
    rng = np.random.default_rng(A)
    coords = (rng.standard_normal((3, A, 3)) * 5).astype(np.float32)
    want = np.asarray(jax_ops.pairwise_distance_matrix(jnp.asarray(coords), tile=128))
    before = torch_pdm.STATS.plain_calls
    got = torch_pdm.pairwise_distance_matrix(torch.from_numpy(coords)).numpy()
    assert torch_pdm.STATS.plain_calls == before + 1
    assert got.shape == want.shape == (3, A, A)
    # both sum exact per-channel differences in float32: 1e-5 Angstrom
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(np.diagonal(got, axis1=1, axis2=2) == 0.0)
    np.testing.assert_array_equal(got, got.transpose(0, 2, 1))


def test_pairwise_distance_matrix_plain_chunks_frames(monkeypatch):
    rng = np.random.default_rng(1)
    coords = torch.from_numpy((rng.standard_normal((7, 20, 3)) * 5).astype(np.float32))
    whole = torch_pdm.pairwise_distance_matrix_plain(coords)
    # 3 * 20 * 20 * 2 elements: two frames per chunk, a ragged last chunk
    monkeypatch.setattr(torch_pdm, "PLAIN_ELEMENT_BUDGET", 3 * 20 * 20 * 2)
    torch.testing.assert_close(torch_pdm.pairwise_distance_matrix_plain(coords),
                               whole, rtol=0, atol=0)
    want = torch.cdist(coords.double(), coords.double(),
                       compute_mode="donot_use_mm_for_euclid_dist").float()
    torch.testing.assert_close(whole, want, atol=1e-5, rtol=0)


def test_pairwise_distance_matrix_rejects_bad_inputs():
    with pytest.raises(ValueError):
        torch_pdm.pairwise_distance_matrix(torch.zeros((2, 4, 2)))
    with pytest.raises(TypeError):
        torch_pdm.pairwise_distance_matrix(torch.zeros((2, 4, 3), dtype=torch.float64))
