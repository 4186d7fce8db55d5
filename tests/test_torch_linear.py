"""Port linear CVs (cv/linear.py, cv/htica_stream.py) against the JAX
package's, on the CPU: PCA, TICA and HTICA on the golden fixture, driven as
tests/test_golden.py drives the JAX package, within 1e-4 of the JAX
projection and of tests/golden/*_projection.npy (the repo's projection
contract); streaming against in-memory; the eigensolver routes."""

import os

import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv import cv_calculators_map as jax_calculators
from deep_cartograph_tpu.cv.htica_stream import _krylov_project as jax_krylov_project
from deep_cartograph_tpu.io.colvars import clear_memory_cache, write_colvars
from deep_cartograph_torch.cv import cv_calculators_map
from deep_cartograph_torch.cv import htica_stream
from deep_cartograph_torch.cv.tica_math import split_subspaces
from deep_cartograph_torch.io import colvars as col
from tests.test_cv import base_config
from tests.test_golden import GOLDEN_DIR, _feature_labels, _fixture_system

torch.set_num_threads(2)

PROJECTION_TOL = 1e-4
LINEAR = ("pca", "tica", "htica")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden fixture's system and its feature matrix as a colvars
    file, written as tests/test_golden.py writes it."""
    tmp = str(tmp_path_factory.mktemp("golden"))
    system = _fixture_system(tmp)
    features = np.load(os.path.join(GOLDEN_DIR, "features.npy"))
    path = os.path.join(tmp, "colvars.dat")
    t = np.arange(features.shape[0], dtype=np.float32)
    write_colvars(path, np.column_stack([t, features]), ["time"] + _feature_labels(),
                  fmt="%.6f")
    return system, path, features


def _run(calculators, cv, paths, tops, out, config=None, **kwargs):
    calc = calculators[cv](configuration=config or base_config(), output_path=out,
                           **kwargs)
    calc.load_training_data(paths, tops, features_list=_feature_labels())
    return calc, calc.run()


def _align_signs(a, b):
    """a's columns flipped to correlate positively with b's."""
    return a * np.sign(np.sum(a * b, axis=0))


@pytest.mark.parametrize("cv", LINEAR)
def test_golden_projection_matches_jax(golden, tmp_path, cv):
    system, path, _ = golden
    clear_memory_cache()
    col.clear_memory_cache()
    calc, (proj, labels) = _run(cv_calculators_map, cv, [path], [system.pdb_path],
                                str(tmp_path / "port"), device="cpu")
    _, want = _run(jax_calculators, cv, [path], [system.pdb_path], str(tmp_path / "jax"))
    assert labels == list(want.columns)
    assert proj.dtype == np.float32 and proj.shape == (60, 2)
    np.testing.assert_allclose(proj, want.to_numpy(), atol=PROJECTION_TOL)
    np.testing.assert_allclose(proj, np.load(os.path.join(GOLDEN_DIR,
                                                          f"{cv}_projection.npy")),
                               atol=PROJECTION_TOL)
    assert np.abs(proj).max() <= 1 + 1e-6  # min-max normalized to [-1, 1]
    # the same training data handed over as a matrix
    matrix, names, labels = col.create_dataframe_from_files(
        [path], features_list=_feature_labels())
    other = cv_calculators_map[cv](configuration=base_config(),
                                   output_path=str(tmp_path / "matrix"), device="cpu")
    other._set_training_data(matrix, labels, names)
    np.testing.assert_allclose(other.run()[0], proj, atol=1e-6)


def _two_files(tmp_path, features):
    paths = []
    for i, rows in enumerate((slice(0, 35), slice(35, None))):
        paths.append(str(tmp_path / f"part{i}.dat"))
        part = features[rows]
        col.write_colvars(paths[-1], np.column_stack([np.arange(len(part)), part]),
                          ["time"] + _feature_labels(), fmt="%.9g")
    col.clear_memory_cache()
    return paths


@pytest.mark.parametrize("cv", LINEAR)
def test_streaming_matches_in_memory(golden, tmp_path, monkeypatch, cv):
    """Two files (no lag pair crosses them), streamed in blocks of 16 rows
    (pairs straddle blocks), against the in-memory calculator and the JAX
    package's streaming one. Projections within 1e-4 after the sign fix
    (streaming TICA's level 2 may flip a component); eigenvalues 1e-5."""
    system, _, features = golden
    paths = _two_files(tmp_path, features)
    monkeypatch.setenv("DEEP_CARTO_STREAM_CHUNK_ROWS", "16")
    config = base_config()
    config["streaming"] = True
    mem, (want, _) = _run(cv_calculators_map, cv, paths, None, str(tmp_path / "mem"),
                          device="cpu")
    stream, (got, labels) = _run(cv_calculators_map, cv, paths, None,
                                 str(tmp_path / "stream"), config, device="cpu")
    assert stream._streaming and not mem._streaming
    np.testing.assert_array_equal(stream.training_data_labels, mem.training_data_labels)
    np.testing.assert_allclose(_align_signs(got, want), want, atol=PROJECTION_TOL)
    if cv != "pca":
        np.testing.assert_allclose(stream.eigenvalues_, mem.eigenvalues_, atol=1e-5)
    clear_memory_cache()
    jstream, jwant = _run(jax_calculators, cv, paths, None, str(tmp_path / "jax"), config)
    assert jstream._streaming
    jwant = jwant.to_numpy()
    np.testing.assert_allclose(_align_signs(got, jwant), jwant, atol=PROJECTION_TOL)


@pytest.mark.parametrize("cv", ("tica", "htica"))
def test_streaming_matches_in_memory_at_smoke_width(tmp_path, monkeypatch, cv):
    """At the smoke's streaming width, 580 features (HTICA: 10 subspaces of
    58, 5 kept each), streamed in blocks of 512 rows against the in-memory
    calculator. Five slow processes mixed into every feature over unit
    noise give each subspace a clear gap after its 5th eigenvalue, so the
    float32 result is well determined: projections within 1e-4 after the
    sign fix, eigenvalues within 1e-5."""
    rng = np.random.default_rng(5)
    n, f = 3000, 580
    slow = np.zeros((n, 5))
    for t in range(1, n):
        slow[t] = np.array([0.995, 0.99, 0.98, 0.95, 0.9]) * slow[t - 1] \
            + rng.normal(size=5)
    slow /= slow.std(0)
    x = (slow @ rng.normal(size=(5, f)) + rng.normal(size=(n, f))
         + rng.uniform(1, 3, f)).astype(np.float32)
    names = [f"f{i}" for i in range(f)]
    path = str(tmp_path / "colvars.dat")
    col.write_colvars(path, np.column_stack([np.arange(n), x]), ["time"] + names,
                      fmt="%.9g")
    col.clear_memory_cache()
    monkeypatch.setenv("DEEP_CARTO_STREAM_CHUNK_ROWS", "512")
    config = dict(base_config(), lag_time=10, num_subspaces=10, subspaces_dimension=5)
    runs = {}
    for streaming in (False, True):
        calc = cv_calculators_map[cv](configuration=dict(config, streaming=streaming),
                                      output_path=str(tmp_path / str(streaming)),
                                      device="cpu")
        calc.load_training_data([path], features_list=names)
        assert calc._streaming == streaming
        runs[streaming] = (calc.run()[0], calc.eigenvalues_)
    (want, ev_want), (got, ev_got) = runs[False], runs[True]
    np.testing.assert_allclose(ev_got, ev_want, atol=1e-5)
    np.testing.assert_allclose(_align_signs(got, want), want, atol=PROJECTION_TOL)


def test_streamed_covariances_match_float64():
    """The streamed moments of drifting data (the feature means move away
    from the first block's shift), summed over 2,000 blocks in two
    segments, against float64 two-pass covariances of the same pairs:
    within 1e-6 relative, float32's rounding of the result plus a margin."""
    from deep_cartograph_torch.cv.tica_math import timelagged_covariances

    rng = np.random.default_rng(11)
    n, d, lag, rows = 32_000, 8, 4, 16
    drift = np.linspace(0, 10, n)[:, None] * rng.uniform(0.5, 1.0, d)
    x = (drift + rng.normal(size=(n, d)) + 10).astype(np.float32)

    def blocks():
        for s in range(0, n, rows):
            if s == n // 2:
                yield None
            yield x[s:s + rows]

    sh = htica_stream.StreamingHTICA(d, 2, 3, 2, lag_time=lag, device="cpu")
    c0, ctau, _ = htica_stream._moments_to_covs(sh._pass(blocks)[0])
    x64 = torch.as_tensor(x, dtype=torch.float64)
    pairs = [(seg[:-lag], seg[lag:]) for seg in (x64[: n // 2], x64[n // 2:])]
    x_t = torch.cat([p[0] for p in pairs]).reshape(-1, 2, d // 2).transpose(0, 1)
    x_lag = torch.cat([p[1] for p in pairs]).reshape(-1, 2, d // 2).transpose(0, 1)
    c0_w, ctau_w, _ = timelagged_covariances(x_t, x_lag)
    for got, want in ((c0, c0_w), (ctau, ctau_w)):
        rel = (got.double() - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
        assert float(rel.max()) <= 1e-6


def _covariances(d, n_sub=2, slow=(0.99, 0.97, 0.9), seed=0):
    """(S, d, d) C0 and Ctau whose generalized spectrum has a few slow modes
    over a bulk below 0.5."""
    rng = np.random.default_rng(seed)
    c0s, ctaus = [], []
    for _ in range(n_sub):
        a = rng.normal(size=(d, d)) / np.sqrt(d)
        c0 = a @ a.T + np.eye(d)
        lam = rng.uniform(-0.2, 0.5, d)
        lam[: len(slow)] = slow
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        ell = np.linalg.cholesky(c0)
        c0s.append(c0)
        ctaus.append(ell @ (q * lam) @ q.T @ ell.T)
    f = lambda x: torch.as_tensor(np.stack(x), dtype=torch.float32)  # noqa: E731
    return f(c0s), f(ctaus)


@pytest.mark.parametrize("d,dim", [(300, 2), (300, 3), (300, 30), (520, 40)])
def test_krylov_and_host_lapack_agree(d, dim):
    """Top eigenpairs by the on-device Krylov route and by host LAPACK:
    eigenvalues within 1e-4, eigenvectors within 1e-3 (relative to their
    largest entry, after the sign fix). (300, 30) and (520, 40) lie in the
    JAX package's known-defect window d/16 <= dim <= d/8, where its basis
    can outgrow d; the port caps it at d."""
    c0, ctau = _covariances(d)
    w_k, v_k = htica_stream._device_krylov_tica(c0, ctau, 1e-6, dim)
    w_h, v_h = htica_stream._host_tica(c0, ctau, 1e-6, dim)
    k = min(dim, 3)  # the slow modes; the bulk converges more slowly
    np.testing.assert_allclose(w_k[:, :k], w_h[:, :k], atol=1e-4)
    for s in range(c0.shape[0]):
        a, b = v_k[s][:, :k], v_h[s][:, :k]
        a = _align_signs(a, b)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    blk, m = htica_stream._krylov_shape(d, dim)
    assert blk * m <= d


def test_krylov_projection_matches_jax():
    """The Krylov projection's Ritz values (eigenvalues of H in the metric
    G) against the JAX package's at a shape outside the defect window."""
    import jax.numpy as jnp
    import scipy.linalg as sla

    c0, ctau = _covariances(300, n_sub=1)
    blk, m = htica_stream._krylov_shape(300, 2)
    h, g, _, _ = htica_stream._krylov_project(c0, ctau, 1e-6, blk, m)
    jh, jg, _, _ = jax_krylov_project(jnp.asarray(c0.numpy()), jnp.asarray(ctau.numpy()),
                                      1e-6, blk, m)
    ours = sla.eigh(h[0].double().numpy(), g[0].double().numpy(), eigvals_only=True)
    theirs = sla.eigh(np.asarray(jh[0], np.float64), np.asarray(jg[0], np.float64),
                      eigvals_only=True)
    np.testing.assert_allclose(ours[-3:], theirs[-3:], atol=1e-4)


def test_solver_routes_and_unknown_solver(monkeypatch):
    c0, ctau = _covariances(300, n_sub=1)
    calls = []
    monkeypatch.setattr(htica_stream, "_host_tica",
                        lambda *a: calls.append("host") or (None, None))
    monkeypatch.setattr(htica_stream, "_device_krylov_tica",
                        lambda *a: calls.append("device") or (None, None))
    for solver, dim, want in (("auto", 2, "device"), ("auto", 40, "host"),
                              ("host", 2, "host"), ("device", 40, "device")):
        monkeypatch.setenv("DC_HTICA_SOLVER", solver)
        htica_stream._run_batched_tica(c0, ctau, 1e-6, dim)
        assert calls[-1] == want, (solver, dim)
    monkeypatch.setenv("DC_HTICA_SOLVER", "lapack")
    with pytest.raises(ValueError, match="DC_HTICA_SOLVER"):
        htica_stream._run_batched_tica(c0, ctau, 1e-6, 2)
    # small subspaces take the batched eigh whatever the route says
    monkeypatch.setenv("DC_HTICA_SOLVER", "host")
    w, v = htica_stream._run_batched_tica(c0[:, :20, :20], ctau[:, :20, :20], 1e-6, 2)
    assert w.shape == (1, 2) and v.shape == (1, 20, 2)


def test_streaming_htica_matches_jax_on_blocks():
    """StreamingHTICA.fit over ragged blocks with a segment break, against
    the JAX package's, then project_blocks."""
    from deep_cartograph_tpu.cv.htica_stream import StreamingHTICA as JaxStreamingHTICA

    rng = np.random.default_rng(3)
    x = np.cumsum(rng.normal(size=(400, 12)), 0).astype(np.float32) * 0.1
    x += rng.normal(size=x.shape).astype(np.float32)

    def blocks():
        for s, e in ((0, 90), (90, 95), (95, 200)):
            yield x[s:e]
        yield None
        for s in range(200, 400, 64):
            yield x[s:s + 64]

    port = htica_stream.StreamingHTICA(12, 3, 2, 2, lag_time=3, device="cpu")
    port.fit(blocks)
    jax = JaxStreamingHTICA(12, 3, 2, 2, lag_time=3)
    jax.fit(blocks)
    np.testing.assert_allclose(port.eigenvalues_, jax.eigenvalues_, atol=1e-5)
    got = port.project_blocks(b for b in blocks() if b is not None)
    want = jax.project_blocks(b for b in blocks() if b is not None)
    np.testing.assert_allclose(_align_signs(got, want), want,
                               atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="divide evenly"):
        htica_stream.StreamingHTICA(10, 3, 2, 2, 1, device="cpu")


def test_split_subspaces_matches_jax():
    from deep_cartograph_tpu.cv.tica_math import split_subspaces as jax_split

    for n, k in ((586, 10), (8, 2), (7, 3), (5, 5)):
        assert [b.tolist() for b in split_subspaces(n, k)] == \
            [b.tolist() for b in jax_split(n, k)]
    with pytest.raises(ValueError, match="larger than"):
        split_subspaces(3, 4)
