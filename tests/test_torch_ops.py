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


# A model of K2's algorithm (ops/csrc/kde_logsumexp.cu) in plain PyTorch,
# float32 throughout, so that its overflow and underflow handling is tested
# where the kernel cannot run: base-2 terms ex2(v - m) with v = -d2 * log2(e)
# (ex2 flushing results below 2^-126 to 0, as ex2.approx.ftz does), per
# split (a whole number of `tile`s) an integer m from the max of its first
# `probe` terms, per chunk of samples a lazy sum, the redo of a chunk whose
# sum overflowed, the power-of-two rescale of a sum past 2^32, and the merge
# of the splits' partials.
_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)


def _ex2_ftz(t):
    y = torch.exp2(t)
    return torch.where(y < 2.0**-126, torch.zeros_like(y), y)


def _k2_model(grid_s, samples_s, splits, tile=512, chunk=128, probe=32,
              rescale_above=2.0**32):
    """(out, counts) for pre-scaled (G, D), (N, D) float32 tensors; counts
    has the number of chunk redos and rescales over all grid points."""
    N = samples_s.shape[0]
    tiles = -(-N // tile)
    per = -(-tiles // splits) * tile
    counts = {"redo": 0, "rescale": 0}
    parts = []
    for n0 in range(0, N, per):
        split = samples_s[n0:n0 + per]
        d2 = ((grid_s[:, None, :] - split[None, :probe, :]) ** 2).sum(-1)
        m = torch.round((-d2).amax(1) * _LOG2E)
        s = torch.zeros_like(m)
        for c0 in range(0, split.shape[0], chunk):
            d2 = ((grid_s[:, None, :] - split[None, c0:c0 + chunk, :]) ** 2).sum(-1)
            st = _ex2_ftz(d2 * -_LOG2E - m[:, None]).sum(1)
            over = torch.isinf(s + st)
            m_new = torch.maximum(m, torch.round((d2 * -_LOG2E).amax(1)))
            redo = s * torch.exp2(m - m_new) + _ex2_ftz(
                d2 * -_LOG2E - m_new[:, None]).sum(1)
            m = torch.where(over, m_new, m)
            s = torch.where(over, redo, s + st)
            big = s > rescale_above
            k = (torch.frexp(s).exponent - 1).to(torch.float32)
            s = torch.where(big, torch.ldexp(s, -k), s)
            m = torch.where(big, m + k, m)
            counts["redo"] += int(over.sum())
            counts["rescale"] += int(big.sum())
        parts.append((m, s))
    pm = torch.stack([p[0] for p in parts])
    ps = torch.stack([p[1] for p in parts])
    mm = pm.amax(0)
    ss = torch.where(ps > 0, ps * torch.exp2(pm - mm), torch.zeros_like(ps)).sum(0)
    return _LN2 * (mm + torch.log2(torch.clamp_min(ss, 1e-38))), counts


def _far_sorted_case(rng):
    """Grid points far from every sample (scaled squared distance > 200 at the
    corners), samples sorted by distance from a corner, farthest first."""
    samples = np.clip(rng.normal(0, 0.3, (3000, 2)), -1, 1).astype(np.float32)
    axis = np.linspace(-2.5, 2.5, 12, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    order = np.argsort(-((samples - grid[0]) ** 2).sum(1), kind="stable")
    return grid, samples[order], 1.0 / (2 * 0.1**2)


def _first_far_case(rng):
    """The split's first samples far away, the rest near: the first chunk's
    lazy sum overflows and is redone."""
    samples = rng.normal(0, 0.3, (2000, 3)).astype(np.float32)
    samples[0] = [4.0, -4.0, 4.0]
    grid = rng.uniform(-0.6, 0.6, (100, 3)).astype(np.float32)
    samples[1:128] += 4.0  # the probe sees only far samples
    return grid, samples, 1.0 / (2 * 0.1**2)


def _max_last_case(rng):
    """Every sample far but the last, which is the max for every grid point."""
    samples = rng.normal(3.0, 0.2, (1500, 2)).astype(np.float32)
    samples[-1] = [0.0, 0.0]
    grid = rng.uniform(-0.3, 0.3, (90, 2)).astype(np.float32)
    return grid, samples, 1.0 / (2 * 0.1**2)


@pytest.mark.parametrize("case,splits", [
    ("far_sorted", 1), ("far_sorted", 3), ("first_far", 1), ("first_far", 2),
    ("max_last", 1), ("max_last", 3),
])
def test_k2_algorithm_matches_jax_kernel(case, splits):
    make = {"far_sorted": _far_sorted_case, "first_far": _first_far_case,
            "max_last": _max_last_case}[case]
    grid, samples, inv_two_bw2 = make(np.random.default_rng(len(case)))
    want = np.asarray(jax_ops.kde_logsumexp(grid, samples, inv_two_bw2,
                                            tile=128, sample_block=256))
    scale = torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32))
    got, counts = _k2_model(torch.from_numpy(grid) * scale,
                            torch.from_numpy(samples) * scale, splits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if case == "far_sorted":
        # the corners' terms all underflow exp in float32: only a running max
        # keeps them
        assert want.min() < -200
        assert counts["redo"] > 0 and counts["rescale"] > 0
    if case in ("first_far", "max_last"):
        assert counts["redo"] > 0


def test_k2_model_small_tiles_match_plain():
    """Many small tiles, chunks and splits, ragged at both ends: the model
    equals the plain version; the lazy max never changes the answer."""
    rng = np.random.default_rng(8)
    grid, samples, inv_two_bw2 = _far_sorted_case(rng)
    scale = torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32))
    g, x = torch.from_numpy(grid) * scale, torch.from_numpy(samples[:2999]) * scale
    want = torch_kde.kde_logsumexp_plain(g, x)
    for splits, tile, chunk, probe in [(1, 64, 64, 16), (7, 64, 32, 8), (47, 64, 16, 1)]:
        got, counts = _k2_model(g, x, splits, tile=tile, chunk=chunk, probe=probe)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
        assert counts["redo"] > 0


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
