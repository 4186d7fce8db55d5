"""Port TICA linear algebra (cv/tica_math.py) against the JAX package's, on
the same numpy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv import tica_math as jax_tica
from deep_cartograph_torch.cv import tica_math as torch_tica

torch.set_num_threads(2)

TOL = 1e-5  # float32 products and reductions in another order


def _trajectory(seed=0, n=600, d=6):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, d)), 0) * 0.05
    return (np.sin(x) + 0.2 * rng.standard_normal((n, d))).astype(np.float32)


def test_timelagged_covariances_match_jax():
    x = _trajectory()
    xt, xl = x[:-5], x[5:]
    want = [np.asarray(a) for a in jax_tica.timelagged_covariances(
        jnp.asarray(xt), jnp.asarray(xl))]
    got = torch_tica.timelagged_covariances(torch.from_numpy(xt), torch.from_numpy(xl))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL)
    c0, ctau, _ = got
    np.testing.assert_array_equal(ctau.numpy(), ctau.numpy().T)


def test_weighted_covariances_ignore_zero_weight_rows():
    """A batch of two tries with padded rows at weight 0 gives each try's
    unweighted estimate on its real rows, as the JAX package's loss
    computes it."""
    x = _trajectory(seed=2, n=90)
    xt = np.stack([x[:-5], x[5:][::-1]])
    xl = np.stack([x[5:], x[:-5][::-1]])
    weights = np.ones(xt.shape[:2], np.float32)
    weights[0, 70:] = 0.0
    xt[0, 70:] = 1e3  # padding, whatever it holds
    got = torch_tica.timelagged_covariances(
        torch.from_numpy(xt), torch.from_numpy(xl), torch.from_numpy(weights))
    for t, n in ((0, 70), (1, xt.shape[1])):
        want = [np.asarray(a) for a in jax_tica.timelagged_covariances(
            jnp.asarray(xt[t, :n]), jnp.asarray(xl[t, :n]))]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[t].numpy(), w, atol=TOL)


def test_generalized_eigh_matches_jax_batched():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((3, 4, 4)).astype(np.float32)
    b = (m @ m.transpose(0, 2, 1) + 4 * np.eye(4)).astype(np.float32)
    a = rng.standard_normal((3, 4, 4)).astype(np.float32)
    a = (a + a.transpose(0, 2, 1)).astype(np.float32)
    w, v = torch_tica.generalized_eigh(torch.from_numpy(a), torch.from_numpy(b), 1e-6)
    assert w.shape == (3, 4) and v.shape == (3, 4, 4)
    for k in range(3):
        ww, vw = (np.asarray(t) for t in jax_tica.generalized_eigh(
            jnp.asarray(a[k]), jnp.asarray(b[k]), 1e-6))
        np.testing.assert_allclose(w[k].numpy(), ww, atol=TOL)
        assert np.all(np.diff(w[k].numpy()) <= 0)  # descending
        # eigenvectors up to sign, normalized in the b metric
        vk = v[k].numpy()
        np.testing.assert_allclose(np.abs(vk), np.abs(vw), atol=TOL)
        np.testing.assert_allclose(vk.T @ b[k] @ vk, np.eye(4), atol=1e-4)


@pytest.mark.parametrize("remove_average", [True, False])
def test_tica_matches_jax_with_sign_convention(remove_average):
    x = _trajectory(2)
    xt, xl = x[:-3], x[3:]
    evals_w, evecs_w = jax_tica.tica(xt, xl, 3, remove_average=remove_average)
    evals, evecs = torch_tica.tica(xt, xl, 3, remove_average=remove_average,
                                   device="cpu")
    assert evals.dtype == evecs.dtype == np.float32
    np.testing.assert_allclose(evals, evals_w, atol=TOL)
    np.testing.assert_allclose(evecs, evecs_w, atol=1e-4)
    # the largest-magnitude component of each eigenvector is positive
    top = evecs[np.argmax(np.abs(evecs), axis=0), np.arange(3)]
    assert np.all(top > 0)


def test_no_lag_pair_crosses_a_trajectory():
    x = np.arange(30, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    blocks = [x[:10], x[10:12], x[12:]]  # the middle block is shorter than lag
    want = jax_tica.create_timelagged_dataset_multi(blocks, 3)
    got_np = torch_tica.create_timelagged_dataset_multi(blocks, 3)
    got_t = torch_tica.create_timelagged_dataset_multi(
        [torch.from_numpy(b) for b in blocks], 3
    )
    for g, w in zip(got_np, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_t, want):
        np.testing.assert_array_equal(g.numpy(), w)
    xt, xl = got_np
    assert xt.shape == (7 + 15, 2)
    assert np.all(xl[:, 0] - xt[:, 0] == 3)  # every pair inside one block
    with pytest.raises(ValueError):
        torch_tica.create_timelagged_dataset_multi([x[:2]], 3)
    with pytest.raises(ValueError):
        torch_tica.create_timelagged_dataset(x, 0)
