"""The port's Müller-Brown sampler (deep_cartograph_torch/data/muller_brown.py)
against the JAX package's, on the CPU.

The noise comes from a torch generator in the port and from jax.random in
the JAX package, so the trajectories are held with the JAX package's noise
passed in: the sequence its scan draws (`split(key)`, then `normal` of the
subkey, once a step; muller_brown.py:52-56)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_cartograph_torch.data.muller_brown as tm
import deep_cartograph_tpu.data.muller_brown as jm

torch.set_num_threads(2)

TOL = 1e-5


def jax_noise(seed: int, n_steps: int) -> np.ndarray:
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (2,))))
    return np.stack(out)


def test_potential_and_gradient_match_jax():
    pts = np.random.default_rng(61).uniform([-1.5, -0.5], [1.2, 2.0], (500, 2)).astype(
        np.float32)
    want = np.asarray(jm.potential(jnp.asarray(pts)))
    got = tm.potential(pts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    want_grad = np.asarray(jax.vmap(jax.grad(lambda p: jm.potential(p)))(jnp.asarray(pts)))
    got_grad = tm.grad_potential(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(tm.MINIMA, jm.MINIMA)
    # the minima are stationary points
    g = tm.grad_potential(torch.as_tensor(tm.MINIMA)).numpy()
    assert np.abs(g).max() < 2.0


@pytest.mark.parametrize("n_frames,stride,kt,seed,x_init", [
    (20, 10, 15.0, 0, (-0.5, 1.4)),
    (200, 1, 15.0, 3, (-0.5, 1.4)),
    (25, 8, 40.0, 5, (0.6, 0.0)),
])
def test_trajectory_with_jax_noise_matches_jax(n_frames, stride, kt, seed, x_init):
    """200 Langevin steps with the JAX package's noise."""
    want = jm.sample_trajectory(n_frames=n_frames, stride=stride, kt=kt, seed=seed,
                                x_init=x_init)
    got = tm.sample_trajectory(n_frames=n_frames, stride=stride, kt=kt, seed=seed,
                               x_init=x_init, device="cpu",
                               noise=jax_noise(seed, n_frames * stride))
    assert got.shape == want.shape == (n_frames, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_seeded_sampler_stays_bounded_and_visits_basins():
    """The seeded torch noise: same seed, same path; a long walk at kT=20
    stays in a physical range and crosses between basins, as the JAX
    package's does (tests/test_muller_brown.py)."""
    a = tm.sample_trajectory(n_frames=2000, stride=20, kt=20.0, seed=3, device="cpu")
    b = tm.sample_trajectory(n_frames=20, stride=20, kt=20.0, seed=3, device="cpu")
    np.testing.assert_array_equal(a[:20], b)
    assert np.isfinite(a).all() and np.abs(a).max() < 3.0
    assert len(set(np.unique(tm.basin_labels(a)))) >= 2
    energies = tm.potential(a).numpy()
    assert energies.min() > -160 and np.median(energies) < 0
    c = tm.sample_trajectory(n_frames=20, stride=20, kt=20.0, seed=4, device="cpu")
    assert not np.array_equal(a[:20], c)


def test_labels_and_ca_embedding_match_jax():
    xy = np.random.default_rng(62).uniform(-1.5, 2.0, (300, 2)).astype(np.float32)
    np.testing.assert_array_equal(tm.basin_labels(xy), jm.basin_labels(xy))
    np.testing.assert_array_equal(tm.as_ca_trajectory(xy), jm.as_ca_trajectory(xy))


def test_noise_of_the_wrong_shape_raises():
    with pytest.raises(ValueError, match="noise of shape"):
        tm.sample_trajectory(n_frames=5, stride=2, device="cpu", noise=np.zeros((9, 2)))
