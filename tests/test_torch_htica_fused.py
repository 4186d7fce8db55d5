"""StreamingHTICA.fit_fused and fit_chunked of the port
(deep_cartograph_torch/cv/htica_stream.py) against the JAX package's, on
the CPU, on the same numpy blocks, and against the port's own fit().

Tolerances: eigenvalues 1e-4 against the JAX methods; projections
max(1e-4, 3 x the one-ulp spread), the spread being how far the port's fit
moves on inputs one float32 ulp apart (ROADMAP Queue 3, HTICA's float32
conditioning); against the port's fit(), which sums the same float64
moments in another order, 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_torch.cv.htica_stream import StreamingHTICA
from deep_cartograph_tpu.cv.htica_stream import StreamingHTICA as JaxStreamingHTICA

torch.set_num_threads(2)

N_FRAMES, N_FEAT, BLOCK, LAG = 600, 24, 100, 5
SHAPE = dict(n_features=N_FEAT, num_subspaces=4, subspaces_dimension=3, cv_dimension=2,
             lag_time=LAG, reg=1e-6)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_FRAMES, N_FEAT)).astype(np.float32)
    return (np.cumsum(x, axis=0) / 10 + x).astype(np.float32)


def _port(**kw):
    return StreamingHTICA(**SHAPE, device="cpu", **kw)


def _device_slice(x, start, size=BLOCK):
    """Rows [start, start + size) of x, start a 0-dim tensor: no host sync."""
    return x.index_select(0, start + torch.arange(size, device=x.device))


def _fit(x):
    est = _port()
    est.fit(lambda: (x[s:s + BLOCK] for s in range(0, N_FRAMES, BLOCK)))
    return est


def _align_signs(a, b):
    signs = np.sign(np.sum(a * b, axis=0))
    return a * np.where(signs == 0, 1.0, signs)


def _ulp_spread(x):
    """How far the port's projection moves on inputs one ulp apart."""
    up = (np.arange(x.size).reshape(x.shape) % 2).astype(bool)
    noisy = np.nextafter(x, np.where(up, np.float32(np.inf), np.float32(-np.inf)))
    assert noisy.dtype == np.float32 and (noisy != x).all()
    a, b = x @ _fit(x).weights, noisy @ _fit(noisy).weights
    return float(np.abs(_align_signs(b, a) - a).max())


def _jax_fit(method, x, **kw):
    est = JaxStreamingHTICA(**SHAPE)
    xd = jnp.asarray(x)
    getattr(est, method)(lambda start: jax.lax.dynamic_slice_in_dim(xd, start, BLOCK, 0),
                         N_FRAMES, BLOCK, **kw)
    return est


def _port_fit(method, x, **kw):
    est = _port()
    xt = torch.from_numpy(x)
    getattr(est, method)(lambda start: _device_slice(xt, start), N_FRAMES, BLOCK, **kw)
    return est


CASES = [("fit_fused", {})] + [("fit_chunked", {"blocks_per_dispatch": k})
                               for k in (1, 2, 3, 6)]


@pytest.mark.parametrize("method,kw", CASES)
def test_matches_the_jax_method(method, kw):
    x = _data()
    got, want = _port_fit(method, x, **kw), _jax_fit(method, x, **kw)
    np.testing.assert_allclose(got.eigenvalues_, want.eigenvalues_, atol=1e-4)
    tol = max(1e-4, 3 * _ulp_spread(x))
    pg, pw = x @ got.weights, x @ want.weights
    np.testing.assert_allclose(_align_signs(pg, pw), pw, atol=tol)


@pytest.mark.parametrize("method,kw", CASES)
def test_matches_the_ports_fit(method, kw):
    x = _data(1)
    got, want = _port_fit(method, x, **kw), _fit(x)
    np.testing.assert_allclose(got.eigenvalues_, want.eigenvalues_, atol=1e-5)
    np.testing.assert_allclose(got.level1, want.level1, atol=1e-5)
    np.testing.assert_allclose(x @ got.weights, x @ want.weights, atol=1e-5)


def test_block_args_reach_block_fn():
    """The buffer passed through block_args gives the closure's result."""
    x = _data(2)
    xt = torch.from_numpy(x)
    a = _port_fit("fit_chunked", x, blocks_per_dispatch=3)
    b = _port()
    b.fit_chunked(lambda start, buf: _device_slice(buf, start), N_FRAMES, BLOCK,
                  blocks_per_dispatch=3, block_args=(xt,))
    np.testing.assert_array_equal(a.weights, b.weights)


def test_the_jax_errors():
    est = _port()
    xt = torch.zeros((N_FRAMES, N_FEAT))

    def block(start):
        return _device_slice(xt, start)

    with pytest.raises(ValueError, match="divide evenly into block_size blocks for the "
                                         "fused path"):
        est.fit_fused(block, 550, BLOCK)
    with pytest.raises(ValueError, match="divide evenly into block_size blocks for the "
                                         "chunked path"):
        est.fit_chunked(block, 550, BLOCK)
    with pytest.raises(ValueError, match=r"blocks_per_dispatch \(4\) must divide the "
                                         "6-block pass evenly"):
        est.fit_chunked(block, N_FRAMES, BLOCK, blocks_per_dispatch=4)
    with pytest.raises(ValueError, match=r"blocks_per_dispatch \(0\)"):
        est.fit_chunked(block, N_FRAMES, BLOCK, blocks_per_dispatch=0)
    for call in (lambda: est.fit_fused(lambda s: _device_slice(xt, s, 5), N_FRAMES, 5),
                 lambda: est.fit_chunked(lambda s: _device_slice(xt, s, 5), N_FRAMES, 5)):
        with pytest.raises(ValueError, match="block_size must exceed lag_time"):
            call()
    # and the JAX package raises alike
    jest = JaxStreamingHTICA(**SHAPE)
    with pytest.raises(ValueError, match="fused path"):
        jest.fit_fused(lambda s: None, 550, BLOCK)
    with pytest.raises(ValueError, match="must divide the 6-block pass evenly"):
        jest.fit_chunked(lambda s: None, N_FRAMES, BLOCK, blocks_per_dispatch=4)
    with pytest.raises(ValueError, match="block_size must exceed lag_time"):
        jest.fit_fused(lambda s: None, N_FRAMES, 5)


def test_a_block_of_the_wrong_shape_raises():
    xt = torch.zeros((N_FRAMES, N_FEAT + 1))
    with pytest.raises(ValueError, match="block_fn gave a block of shape"):
        _port().fit_fused(lambda s: _device_slice(xt, s), N_FRAMES, BLOCK)
