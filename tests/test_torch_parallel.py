"""The port's sharded paths (deep_cartograph_torch/parallel and the branches
that call it) against the JAX package's, on the CPU.

The port runs on a mesh that lists the CPU eight times (`use_mesh`), the
JAX package on the suite's 8-device virtual CPU mesh (tests/conftest.py),
from the same seeded numpy inputs. Each test names the branch each side
took. Every entry point is called with device="cpu": under a mesh whose
first device is the CPU that is the mesh's device, so the call shards
(`parallel.mesh.mesh_for`); without the mesh the same call is the port's
one-device path.

Tolerances: moments, halo pairs and rings 1e-5; log densities 1e-5; FES
1e-3 kJ/mol (the repo's FES contract); features 1e-5 against the JAX
package and 1e-6 against the one-device port (each frame is computed
alone, but the CPU's vectorized loops round a lane differently with the
batch's length); int16 dequantized frames equal to the one-device upload
(the same codes);
projections 1e-4 (the repo's projection contract); eigenvalues 1e-4;
entropy and std equal after the 3-decimal rounding; per-epoch losses rel
1e-4 (tests/test_torch_training.py); colvars files byte-equal.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from deep_cartograph_torch.cv import cv_calculators_map
from deep_cartograph_torch.cv import htica_stream
from deep_cartograph_torch.deploy import FramesToCV
from deep_cartograph_torch.fes import kde as port_kde
from deep_cartograph_torch.geom.engine import Featurizer, ShardedChunkEvaluator
from deep_cartograph_torch.geom.kernels import PlanEvaluator
from deep_cartograph_torch.io import colvars as col
from deep_cartograph_torch.io import upload as tup
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.ops import kde as k2
from deep_cartograph_torch.ops import pair_distances as k1
from deep_cartograph_torch.parallel import mesh as port_mesh
from deep_cartograph_torch.parallel import sharding as port_sharding
from deep_cartograph_torch.parallel.mesh import Mesh, use_mesh
from deep_cartograph_torch.stats import descriptors as port_desc
from deep_cartograph_tpu.cv import cv_calculators_map as jax_calculators
from deep_cartograph_tpu.cv import tica_math as jax_tica_math
from deep_cartograph_tpu.cv.htica_stream import StreamingHTICA as JaxStreamingHTICA
from deep_cartograph_tpu.deploy import FramesToCV as JaxFramesToCV
from deep_cartograph_tpu.fes import kde as jax_kde
from deep_cartograph_tpu.geom.engine import Featurizer as JaxFeaturizer
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from deep_cartograph_tpu.parallel import mesh as jax_mesh
from deep_cartograph_tpu.parallel import sharding as jax_sharding
from deep_cartograph_tpu.stats import descriptors as jax_desc
from tests.test_cv import base_config
from tests.test_golden import GOLDEN_DIR, _feature_labels, _fixture_system
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401
from tests.test_torch_upload import FLOAT32_ALLOWANCE, _dihedral_error_bound

torch.set_num_threads(2)

N_DEV = 8
PROJECTION_TOL = 1e-4


@pytest.fixture
def mesh():
    """The CPU listed eight times, the mesh of every call in the block."""
    with use_mesh(Mesh(("cpu",) * N_DEV)) as m:
        yield m


def test_the_jax_side_runs_on_eight_devices():
    assert len(jax.devices()) == N_DEV == len(jax_mesh.get_mesh().devices.flat)


def _align_signs(a, b):
    return a * np.sign(np.sum(a * b, axis=0))


# ---------------------------------------------------------------------------
# The parallel package
# ---------------------------------------------------------------------------


def test_sharded_covariances_match_jax(mesh):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((203, 6)).astype(np.float32)
    x_t, x_lag = x[:-2], x[2:]
    c0, ctau = port_sharding.sharded_covariances(x_t, x_lag)
    want0, want_tau = jax_sharding.sharded_covariances(x_t, x_lag, jax_mesh.get_mesh())
    np.testing.assert_allclose(c0.numpy(), want0, atol=1e-5)
    np.testing.assert_allclose(ctau.numpy(), want_tau, atol=1e-5)
    ref0, ref_tau, _ = jax_tica_math.timelagged_covariances(x_t, x_lag)
    np.testing.assert_allclose(c0.numpy(), np.asarray(ref0), atol=1e-5)
    np.testing.assert_allclose(ctau.numpy(), np.asarray(ref_tau), atol=1e-5)


def test_sharded_stats_match_jax(mesh):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((101, 5)).astype(np.float32) * 3 + 1
    got = port_sharding.sharded_feature_matrix_stats(x)
    want = jax_sharding.sharded_feature_matrix_stats(x)
    for key in ("mean", "std", "min", "max"):
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["min"], x.min(0))
    np.testing.assert_array_equal(got["max"], x.max(0))


def test_lag_pairs_with_halo_match_jax(mesh):
    rng = np.random.default_rng(1)
    lag, x = 2, rng.standard_normal((N_DEV * 5, 3)).astype(np.float32)
    got = [torch.cat(parts).numpy() for parts in
           port_sharding.lag_pairs_with_halo(x, lag, mesh)]
    want = [np.asarray(a) for a in
            jax_sharding.lag_pairs_with_halo(jax.device_put(x), lag, jax_mesh.get_mesh())]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    valid = got[2].astype(bool)
    assert valid.sum() == len(x) - lag
    np.testing.assert_array_equal(got[1][valid], x[lag:])
    with pytest.raises(ValueError, match="lag_time"):
        port_sharding.lag_pairs_with_halo(x[:12], lag, mesh)


def test_feature_sharded_covariance_ring_matches_jax(mesh):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((500, 37)).astype(np.float32)  # 37 % 8 != 0
    rows, f = port_sharding.feature_sharded_covariance_ring(x)
    assert f == 37 and [r.shape[0] for r in rows] == [5] * 5 + [4] * 3
    got = torch.cat(rows).numpy()
    want, fp = jax_sharding.feature_sharded_covariance_ring(x)
    np.testing.assert_allclose(got, np.asarray(want)[:f, :f], atol=1e-5)
    rows, _ = port_sharding.feature_sharded_covariance_ring(x, center=False)
    np.testing.assert_allclose(torch.cat(rows).numpy(), x.T @ x / 500, atol=1e-5)


def test_feature_sharded_timelagged_ring_matches_jax(mesh):
    rng = np.random.default_rng(3)
    n, f, lag = 400, 21, 5
    x = rng.standard_normal((n + lag, f)).astype(np.float32)
    x_t, x_lag = x[:-lag], x[lag:]
    c0, ctau, width = port_sharding.feature_sharded_timelagged_ring(x_t, x_lag)
    w0, wt, _ = jax_sharding.feature_sharded_timelagged_ring(x_t, x_lag)
    assert width == f
    np.testing.assert_allclose(torch.cat(c0).numpy(), np.asarray(w0)[:f, :f], atol=1e-5)
    np.testing.assert_allclose(torch.cat(ctau).numpy(), np.asarray(wt)[:f, :f], atol=1e-5)


def test_collectives_on_a_mesh(mesh):
    parts = [torch.full((3,), float(i)) for i in range(N_DEV)]
    assert port_sharding.psum(parts, mesh).tolist() == [28.0] * 3
    assert port_sharding.pmax(parts, mesh).tolist() == [7.0] * 3
    assert port_sharding.pmin(parts, mesh).tolist() == [0.0] * 3
    rows = [torch.arange(i + 1.0) for i in range(N_DEV)]
    assert port_sharding.all_gather(rows, mesh).tolist() == sum(
        (list(range(i + 1)) for i in range(N_DEV)), [])
    ring = port_sharding.ppermute(parts, mesh)
    assert [float(r[0]) for r in ring] == [1, 2, 3, 4, 5, 6, 7, 0]


def test_sharded_kde_runs_k2_per_shard_and_matches_jax(mesh):
    rng = np.random.default_rng(4)
    samples = rng.standard_normal(203).astype(np.float32)  # uneven shards
    grid = np.linspace(-3, 3, 50).astype(np.float32)
    before = k2.STATS.plain_calls
    lse = port_sharding.sharded_kde_logsumexp(grid, samples, 1.0 / (2 * 0.3 * 0.3))
    assert k2.STATS.plain_calls - before == N_DEV
    want = jax_sharding.sharded_kde_logdensity(samples, grid, 0.3)
    np.testing.assert_allclose(lse.numpy() - np.log(len(samples)), want, atol=1e-5)
    with use_mesh(Mesh(("cpu",))):  # one shard: K2's own logsumexp
        one = port_sharding.sharded_kde_logsumexp(grid, samples, 1.0 / (2 * 0.3 * 0.3))
    np.testing.assert_array_equal(one.numpy(), k2.kde_logsumexp(
        torch.as_tensor(grid[:, None]), torch.as_tensor(samples[:, None]),
        1.0 / (2 * 0.3 * 0.3)).numpy())
    np.testing.assert_allclose(lse.numpy(), one.numpy(), atol=1e-5)


@pytest.mark.parametrize("dim", [1, 2])
def test_compute_fes_takes_the_sharded_branch_and_matches_jax(mesh, monkeypatch, dim):
    """With the threshold lowered, compute_fes shards every block's samples
    over the mesh, as the JAX package's `_kde_fes_sharded` does; on a mesh
    of one the same streaming path runs K2 once a block."""
    rng = np.random.default_rng(5)
    data = np.concatenate([rng.normal(-1.0, 0.2, (700, dim)),
                           rng.normal(1.2, 0.3, (700, dim))]).astype(np.float32)
    taken = []
    real = port_kde.sharded_kde_logsumexp
    monkeypatch.setattr(port_kde, "STREAMING_THRESHOLD", 0)
    monkeypatch.setattr(port_kde, "sharded_kde_logsumexp",
                        lambda *a, **k: taken.append(a[-1]) or real(*a, **k))
    axes, fes, err = port_kde.compute_fes(data, bandwidth=0.1, num_bins=30, num_blocks=4,
                                          device="cpu")
    assert taken == [mesh] * 4
    with use_mesh(Mesh(("cpu",))):
        _, one, one_err = port_kde.compute_fes(data, bandwidth=0.1, num_bins=30,
                                               num_blocks=4, device="cpu")
    assert [len(m) for m in taken[4:]] == [1] * 4
    np.testing.assert_allclose(fes, one, atol=1e-5)
    np.testing.assert_allclose(err, one_err, atol=1e-5)
    if dim == 1:
        grid = axes[0][:, None]
    else:
        gx, gy = np.meshgrid(axes[0], axes[1], indexing="ij")
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    want_fes, want_err = jax_kde._kde_fes_sharded(data, grid, 0.1,
                                                  jax_kde.KB_KJ_MOL * 300.0, 4)
    np.testing.assert_allclose(fes.ravel(), want_fes, atol=1e-3)
    np.testing.assert_allclose(err.ravel(), want_err, atol=1e-3)
    # and the port's one-device path (the dense PyTorch estimate)
    monkeypatch.setattr(port_kde, "STREAMING_THRESHOLD", 5e7)
    _, dense, dense_err = port_kde.compute_fes(data, bandwidth=0.1, num_bins=30,
                                               num_blocks=4, device="cpu")
    np.testing.assert_allclose(fes, dense, atol=1e-3)
    np.testing.assert_allclose(err, dense_err, atol=1e-3)


# ---------------------------------------------------------------------------
# Featurize and serve (K1 per shard)
# ---------------------------------------------------------------------------

LABELS = ["dist-@CA_1-@CA_5", "sin-@CA_1-@CA_2-@CA_3-@CA_4",
          "cos-@CA_1-@CA_2-@CA_3-@CA_4", "dist-@CA_2-@CA_11"]


def test_featurize_frames_sharded_matches_jax(mesh, ca_system):
    top = Topology.from_pdb(ca_system.pdb_path)
    before = k1.STATS.plain_calls
    shards, n = Featurizer(top, LABELS, device="cpu").featurize_frames_sharded(
        ca_system.coords)
    assert k1.STATS.plain_calls - before == N_DEV and len(shards) == N_DEV
    got = torch.cat(shards).numpy()
    want, jn = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), LABELS
                             ).featurize_frames_sharded(ca_system.coords, jax_mesh.get_mesh())
    assert n == jn == ca_system.coords.shape[0]
    np.testing.assert_allclose(got, np.asarray(want)[:n], atol=1e-5)
    single = PlanEvaluator(Featurizer(top, LABELS, device="cpu").plan, device="cpu")
    np.testing.assert_allclose(got, single(ca_system.coords), atol=1e-6)


def test_featurizer_auto_shards_over_the_mesh(mesh, ca_system):
    """Under the mesh the Featurizer's chunks go through a
    ShardedChunkEvaluator (the JAX package's auto-shard), uneven chunks
    included; outside it, through one over the CPU alone."""
    top = Topology.from_pdb(ca_system.pdb_path)
    featurizer = Featurizer(top, LABELS, device="cpu")
    ev = featurizer.evaluator
    assert isinstance(ev, ShardedChunkEvaluator) and len(ev.mesh) == N_DEV
    coords = ca_system.coords[:30]  # 30 frames over 8 devices
    np.testing.assert_allclose(ev(coords), PlanEvaluator(featurizer.plan,
                                                         device="cpu")(coords), atol=1e-6)
    assert ev(coords[:3]).shape == (3, len(LABELS))  # fewer frames than devices
    before = k1.STATS.plain_calls
    got = featurizer.featurize_trajectory(ca_system.dcd_path, frame_chunk=16)
    assert k1.STATS.plain_calls - before == N_DEV * 4  # 60 frames, 4 chunks
    jax_featurizer = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), LABELS,
                                   device="default")
    assert type(jax_featurizer._get_evaluator(None)).__name__ == "ShardedChunkEvaluator"
    want = jax_featurizer.featurize_trajectory(ca_system.dcd_path, frame_chunk=16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    many = featurizer.featurize_trajectories([ca_system.dcd_path] * 3, frame_chunk=16)
    for feats in many:
        np.testing.assert_allclose(feats, got, atol=1e-6)
    with use_mesh(Mesh(("cpu",))):
        assert featurizer.evaluator.mesh.devices == (torch.device("cpu"),)
        np.testing.assert_allclose(
            featurizer.featurize_trajectory(ca_system.dcd_path, frame_chunk=16), got,
            atol=1e-6)


def test_int16_upload_sharded_matches_one_device_and_jax(mesh, ca_system):
    """The sharded int16 branch quantizes each chunk once: every shard's
    frames dequantize to what the one-device upload gives, and the features
    are the JAX package's sharded int16 features (within 1e-5) and within
    tests/test_torch_upload.py's bound of the float32 features."""
    coords = ca_system.coords * 3.0
    block = coords[:29]
    shards = tup.upload_coords_sharded(block, mesh)
    assert [s.shape[0] for s in shards] == [4] * 5 + [3] * 3
    np.testing.assert_array_equal(torch.cat(shards).numpy(),
                                  tup.upload_coords(block, "int16", "cpu").numpy())
    root = os.path.dirname(ca_system.dcd_path)
    from deep_cartograph_torch.io.dcd import write_dcd

    dcd = os.path.join(root, "scaled_for_int16.dcd")
    write_dcd(dcd, coords)
    top = Topology.from_pdb(ca_system.pdb_path)
    featurizer = Featurizer(top, LABELS, device="cpu")
    got = featurizer.featurize_trajectory(dcd, frame_chunk=16, upload="int16")
    exact = featurizer.featurize_trajectory(dcd, frame_chunk=16)
    with use_mesh(Mesh(("cpu",))):
        single = featurizer.featurize_trajectory(dcd, frame_chunk=16, upload="int16")
    np.testing.assert_allclose(got, single, atol=1e-6)
    want = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), LABELS,
                         device="default").featurize_trajectory(dcd, frame_chunk=16,
                                                                upload="int16")
    np.testing.assert_allclose(got, want, atol=1e-5)
    eps = float(np.finfo(np.float32).eps)
    delta = np.empty(len(coords))
    for s in range(0, len(coords), 16):
        blk = coords[s:s + 16]
        delta[s:s + 16] = (tup.quantization_step(tup.quantize_coords(blk)[1])
                           + 2 * eps * np.abs(blk).max())
    for j in (0, 3):  # distances
        assert (np.abs(got[:, j] - exact[:, j])
                <= 0.1 * 2 * np.sqrt(3) * delta + FLOAT32_ALLOWANCE).all()
    bound = _dihedral_error_bound(coords, [(1, 2, 3, 4)], delta)[:, 0]
    for j in (1, 2):  # sin, cos
        assert (np.abs(got[:, j] - exact[:, j]) <= bound).all()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """TICA and deep-TICA trained by the JAX package on the golden fixture
    (its TICA takes the sharded branch on its 8 devices), with their
    model.zip files."""
    tmp = str(tmp_path_factory.mktemp("parallel_zips"))
    system = _fixture_system(tmp)
    features = np.load(os.path.join(GOLDEN_DIR, "features.npy"))
    path = os.path.join(tmp, "colvars.dat")
    write_colvars(path, np.column_stack([np.arange(60, dtype=np.float32), features]),
                  ["time"] + _feature_labels(), fmt="%.9g")
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 2, "max_epochs": 6, "batch_size": 16})
    out = {}
    for cv in ("tica", "deep_tica"):
        calc = jax_calculators[cv](configuration=cfg, output_path=tmp)
        calc.load_training_data([path], [system.pdb_path], features_list=_feature_labels())
        proj = calc.run().to_numpy()
        out[cv] = (calc, os.path.join(tmp, cv, "model.zip"), proj)
    return system, path, out, cfg


@pytest.mark.parametrize("cv", ["tica", "deep_tica"])
def test_frames_to_cv_sharded_matches_jax(mesh, trained, tmp_path, cv):
    system, _, runs, _ = trained
    from deep_cartograph_torch.io.dcd import read_dcd

    coords = read_dcd(system.dcd_path)
    zip_path = runs[cv][1]
    before = k1.STATS.plain_calls
    pipeline = FramesToCV.from_model_zip(zip_path, system.pdb_path, str(tmp_path / "p"),
                                         device="cpu")
    assert pipeline.mesh is mesh
    got = pipeline(coords)
    assert k1.STATS.plain_calls - before == N_DEV
    want_pipeline = JaxFramesToCV.from_model_zip(zip_path, system.pdb_path,
                                                 str(tmp_path / "j"))
    assert want_pipeline._sharding is not None  # the JAX package's sharded serving
    np.testing.assert_allclose(got, want_pipeline(coords), atol=PROJECTION_TOL)
    with use_mesh(Mesh(("cpu",))):
        one = FramesToCV.from_model_zip(zip_path, system.pdb_path, str(tmp_path / "o"),
                                        device="cpu")
        assert one.mesh.devices == (torch.device("cpu"),)
        np.testing.assert_allclose(got, one(coords), atol=1e-6)


# ---------------------------------------------------------------------------
# Filter statistics, TICA, streaming HTICA, training
# ---------------------------------------------------------------------------


def test_filter_stats_shard_the_feature_axis(mesh, monkeypatch):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((400, 37)).astype(np.float32)
    small_ent = port_desc.shannon_entropy(x, device="cpu")
    small_std = port_desc.standard_deviation(x, device="cpu")
    placed = []
    real = port_desc.run_per_device
    monkeypatch.setattr(port_desc, "run_per_device",
                        lambda *a, **k: placed.append(a[1]) or real(*a, **k))
    monkeypatch.setattr("deep_cartograph_torch.utils.device.SMALL_WORK_ELEMENTS", 0)
    monkeypatch.setattr("deep_cartograph_tpu.utils.device.SMALL_WORK_ELEMENTS", 0)
    ent = port_desc.shannon_entropy(x, device="cpu")
    std = port_desc.standard_deviation(x, device="cpu")
    assert placed == [mesh, mesh]
    np.testing.assert_array_equal(ent, small_ent)
    np.testing.assert_array_equal(std, small_std)
    np.testing.assert_array_equal(ent, jax_desc.shannon_entropy(x))
    np.testing.assert_array_equal(std, jax_desc.standard_deviation(x))
    # a tensor on the host shards as a numpy matrix does
    placed.clear()
    port_desc.standard_deviation(torch.as_tensor(x), device="cpu")
    assert placed == [mesh]


def test_filter_stats_keep_small_work_off_the_mesh(mesh, monkeypatch):
    placed = []
    real = port_desc.run_per_device
    monkeypatch.setattr(port_desc, "run_per_device",
                        lambda *a, **k: placed.append(a[1]) or real(*a, **k))
    x = np.ones((100, 10), np.float32)
    port_desc.standard_deviation(x, device="cpu")
    assert [m.devices for m in placed] == [(torch.device("cpu"),)]


def test_tica_sharded_matches_jax(mesh):
    rng = np.random.default_rng(7)
    n = 4000
    slow = np.zeros(n)
    for i in range(1, n):
        slow[i] = 0.99 * slow[i - 1] + 0.1 * rng.standard_normal()
    data = np.stack([slow, rng.standard_normal(n)], 1) @ np.array([[1.0, 0.5], [0.2, 1.0]])
    data = data.astype(np.float32)
    x_t, x_lag = data[:-5], data[5:]
    from deep_cartograph_torch.cv.tica_math import tica

    evals, evecs = tica(x_t, x_lag, 2, device="cpu", mesh=mesh)
    want_evals, want_evecs = jax_tica_math.tica_sharded(x_t, x_lag, 2)
    np.testing.assert_allclose(evals, want_evals, atol=1e-4)
    np.testing.assert_allclose(evecs, want_evecs, atol=1e-4 * np.abs(want_evecs).max())
    one_evals, one_evecs = tica(x_t, x_lag, 2, device="cpu")
    np.testing.assert_allclose(evals, one_evals, atol=1e-4)


def test_tica_calculator_takes_the_sharded_branch(mesh, trained, tmp_path, monkeypatch):
    system, path, runs, cfg = trained
    from deep_cartograph_torch.cv import linear

    calls = []
    real = linear.tica
    monkeypatch.setattr(linear, "tica",
                        lambda *a, **k: calls.append(k["mesh"]) or real(*a, **k))
    calc = cv_calculators_map["tica"](configuration=cfg, output_path=str(tmp_path),
                                      device="cpu")
    calc.load_training_data([path], [system.pdb_path], features_list=_feature_labels())
    proj = calc.run()[0]
    assert calls == [mesh]
    jax_calc, _, want = runs["tica"]
    np.testing.assert_allclose(calc.eigenvalues_, jax_calc.eigenvalues_, atol=1e-4)
    np.testing.assert_allclose(proj, want, atol=PROJECTION_TOL)


def _slow_features(n, f, seed):
    """Five slow processes mixed into every feature over unit noise (each
    subspace has a clear gap after its 5th eigenvalue)."""
    rng = np.random.default_rng(seed)
    slow = np.zeros((n, 5))
    for t in range(1, n):
        slow[t] = np.array([0.995, 0.99, 0.98, 0.95, 0.9]) * slow[t - 1] + rng.normal(size=5)
    slow /= slow.std(0)
    return (slow @ rng.normal(size=(5, f)) + rng.normal(size=(n, f))
            + rng.uniform(1, 3, f)).astype(np.float32)


def test_streaming_htica_with_a_mesh_matches_jax(mesh):
    """8 subspaces of 6 features over the 8-entry mesh, ragged blocks and a
    segment break, against the JAX StreamingHTICA on its mesh and the
    port without one."""
    x = _slow_features(1500, 48, seed=8)

    def blocks():
        yield x[:500]
        yield x[500:505]
        yield None
        for s in range(505, 1500, 128):
            yield x[s:s + 128]

    port = htica_stream.StreamingHTICA(48, 8, 3, 2, lag_time=4, device="cpu", mesh=mesh)
    port.fit(blocks)
    one = htica_stream.StreamingHTICA(48, 8, 3, 2, lag_time=4, device="cpu")
    one.fit(blocks)
    jx = JaxStreamingHTICA(48, 8, 3, 2, lag_time=4, mesh=jax_mesh.get_mesh())
    jx.fit(blocks)
    np.testing.assert_allclose(port.eigenvalues_, jx.eigenvalues_, atol=1e-4)
    np.testing.assert_allclose(port.eigenvalues_, one.eigenvalues_, atol=1e-5)
    got = port.project_blocks(b for b in blocks() if b is not None)
    for other in (jx, one):
        want = other.project_blocks(b for b in blocks() if b is not None)
        np.testing.assert_allclose(_align_signs(got, want), want,
                                   atol=PROJECTION_TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="divide evenly over"):
        htica_stream.StreamingHTICA(42, 7, 3, 2, 1, device="cpu", mesh=mesh)


def test_htica_calculator_streams_with_the_mesh(mesh, tmp_path, monkeypatch, caplog):
    x = _slow_features(1200, 48, seed=9)
    names = [f"f{i}" for i in range(48)]
    path = str(tmp_path / "colvars.dat")
    col.write_colvars(path, np.column_stack([np.arange(len(x)), x]), ["time"] + names,
                      fmt="%.9g")
    col.clear_memory_cache()
    monkeypatch.setenv("DEEP_CARTO_STREAM_CHUNK_ROWS", "256")
    config = dict(base_config(), lag_time=4, num_subspaces=8, subspaces_dimension=3,
                  streaming=True)
    results = {}
    with caplog.at_level(logging.INFO):
        for pkg, calcs, kwargs in (("port", cv_calculators_map, {"device": "cpu"}),
                                   ("jax", jax_calculators, {})):
            calc = calcs["htica"](configuration=config, output_path=str(tmp_path / pkg),
                                  **kwargs)
            calc.load_training_data([path], features_list=names)
            proj = calc.run()
            results[pkg] = (proj[0] if pkg == "port" else proj.to_numpy(), calc.eigenvalues_)
    sharded = [r.name for r in caplog.records if r.getMessage().startswith("Streaming HTICA sharded over 8 devices")]
    assert sorted(sharded) == ["deep_cartograph_torch.cv.linear",
                               "deep_cartograph_tpu.cv.linear"]
    (got, ev), (want, jev) = results["port"], results["jax"]
    np.testing.assert_allclose(ev, jev, atol=1e-4)
    np.testing.assert_allclose(_align_signs(got, want), want, atol=PROJECTION_TOL)


def test_fit_ensemble_shards_tries_over_the_mesh(mesh, caplog):
    """T = 8 deep-TICA tries over the 8-entry mesh (T / n = 1 a device)
    against the JAX package's try-sharded fit_ensemble from the same Flax
    initial parameters, and against the port on one device."""
    from deep_cartograph_torch.models.weights import params_from_flax
    from tests.test_torch_training import (
        _assert_result_matches,
        _jax_init,
        _splits,
        _toy_pairs,
        _trainers,
    )

    seeds = list(range(21, 21 + N_DEV))
    full = _toy_pairs()
    train_idx, valid_idx = _splits(len(full["data"]), seeds)
    _, params = _jax_init(seeds)
    jt, pt = _trainers(max_epochs=3)
    with caplog.at_level(logging.INFO):
        want = jt.fit_ensemble(params, full, train_idx, valid_idx, seeds)
        got = pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx, seeds)
    sharded = [r.name for r in caplog.records
               if r.getMessage() == f"Sharding {N_DEV} training tries over {N_DEV} devices."]
    assert sorted(sharded) == ["deep_cartograph_torch.models.training",
                               "deep_cartograph_tpu.models.training"]
    assert len(got) == len(want) == N_DEV
    for g, w in zip(got, want):
        _assert_result_matches(g, w)
    with use_mesh(Mesh(("cpu",))):
        one = pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx, seeds)
    for g, o in zip(got, one):
        assert g.best_epoch == o.best_epoch and g.description == o.description
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(g.metrics[key], o.metrics[key], rtol=1e-4)


def test_fit_ensemble_on_the_jax_tests_setup(mesh, caplog):
    """tests/test_parallel.py's try-sharded setup (a linear map trained by
    Adam, T = 8 over 8 devices, batch 16, 8 epochs) in both packages from
    the same zero parameters and data: per-epoch losses rel 1e-4, scores
    and weights alike, and the same against the port on one device."""
    import jax.numpy as jnp

    from deep_cartograph_torch.models import training as port_training
    from deep_cartograph_tpu.models import training as jax_training

    seeds = list(range(1, N_DEV + 1))
    full = {"data": np.random.default_rng(42).standard_normal((96, 4)).astype(np.float32)}
    kwargs = dict(batch_size=16, max_epochs=8, shuffle=True, check_val_every_n_epoch=1,
                  early_stop_patience=100, optimizer_name="Adam",
                  optimizer_kwargs={"lr": 0.05})

    def jax_loss(params, batch, rng_, beta):
        pred = batch["data"] @ params["w"]
        err = jnp.mean((pred - jnp.sum(batch["data"], axis=1, keepdims=True)) ** 2, axis=1)
        w = batch["weight"]
        return jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1e-9), {}

    def port_loss(params, batch, generators, beta, train=True):
        pred = batch["data"] @ params["w"]
        err = ((pred - batch["data"].sum(-1, keepdim=True)) ** 2).mean(-1)
        w = batch["weight"]
        return (err * w).sum(-1) / w.sum(-1).clamp_min(1e-9), {}

    orders = [np.random.default_rng(s).permutation(96) for s in seeds]
    train_idx = np.asarray([o[:80] for o in orders], np.int32)
    valid_idx = np.asarray([o[80:] for o in orders], np.int32)
    zeros = np.zeros((N_DEV, 4, 1), np.float32)
    with caplog.at_level(logging.INFO):
        want = jax_training.Trainer(jax_loss, jax_training.TrainerConfig(
            device="default", **kwargs)).fit_ensemble(
            {"w": jnp.asarray(zeros)}, full, train_idx, valid_idx, seeds)
        trainer = port_training.Trainer(port_loss, port_training.TrainerConfig(**kwargs),
                                        device="cpu")
        got = trainer.fit_ensemble({"w": torch.as_tensor(zeros)}, full, train_idx,
                                   valid_idx, seeds)
    sharded = [r.name for r in caplog.records
               if r.getMessage() == f"Sharding {N_DEV} training tries over {N_DEV} devices."]
    assert sorted(sharded) == ["deep_cartograph_torch.models.training",
                               "deep_cartograph_tpu.models.training"]
    with use_mesh(Mesh(("cpu",))):
        one = trainer.fit_ensemble({"w": torch.as_tensor(zeros)}, full, train_idx,
                                   valid_idx, seeds)
    for g, w, o in zip(got, want, one):
        assert g.best_epoch == w.best_epoch == o.best_epoch
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(g.metrics[key], w.metrics[key], rtol=1e-4)
            np.testing.assert_allclose(g.metrics[key], o.metrics[key], rtol=1e-4)
        np.testing.assert_allclose(g.score, w.score, rtol=1e-4)
        np.testing.assert_allclose(g.params["w"].numpy(), np.asarray(w.params["w"]),
                                   rtol=1e-4, atol=1e-6)


def test_fit_ensemble_keeps_tries_together_when_the_mesh_does_not_divide(mesh, caplog):
    from deep_cartograph_torch.models.weights import params_from_flax
    from tests.test_torch_training import SEEDS, _jax_init, _splits, _toy_pairs, _trainers

    full = _toy_pairs()
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS)
    _, params = _jax_init(SEEDS)
    _, pt = _trainers(max_epochs=1)
    with caplog.at_level(logging.INFO):
        pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx, SEEDS)
    assert not [r for r in caplog.records if "training tries over" in r.getMessage()]


# ---------------------------------------------------------------------------
# The tool
# ---------------------------------------------------------------------------


def test_compute_features_over_the_mesh_writes_the_same_colvars(ca_system, tmp_path):
    import importlib

    from deep_cartograph_torch.tools import compute_features

    tool_module = importlib.import_module("deep_cartograph_torch.tools.compute_features")

    from tests.test_torch_tools import features_config

    config = features_config()
    files = {}
    for name, m in (("mesh", Mesh(("cpu",) * N_DEV)), ("one", Mesh(("cpu",)))):
        with use_mesh(m):
            tool_module._featurizer_cache.clear()
            paths = compute_features(config, ca_system.dcd_path, ca_system.pdb_path,
                                     output_folder=str(tmp_path / name), device="cpu")
        files[name] = [open(p, "rb").read() for p in paths]
    tool_module._featurizer_cache.clear()
    assert files["mesh"] == files["one"] and len(files["mesh"][0]) > 1000


def test_mesh_routing_and_local_shard():
    cpu = torch.device("cpu")
    # the default mesh holds cards only: a CPU call runs on the CPU alone
    assert port_mesh.mesh_for(cpu).devices == (cpu,)
    with use_mesh(Mesh(("cpu",) * 3)) as m:
        assert port_mesh.get_mesh() is m and port_mesh.mesh_for(cpu) is m
        with use_mesh(Mesh(("cpu",))):
            assert port_mesh.mesh_for(cpu).devices == (cpu,)
        assert port_mesh.get_mesh() is m
    items = [f"traj_{i}.dcd" for i in range(7)]
    assert port_mesh.local_shard(items) == items
    parts = [port_mesh.local_shard(items, process_id=p, num_processes=3) for p in range(3)]
    assert parts == [items[0::3], items[1::3], items[2::3]]
    with pytest.raises(ValueError, match="Unsupported mesh device"):
        Mesh(("meta",))
    with pytest.raises(ValueError, match="at least one device"):
        Mesh(())
    placed = port_mesh.shard(np.ones((2, 7)), Mesh(("cpu",) * 3), axis=1)
    assert [p.shape for p in placed] == [(2, 3), (2, 2), (2, 2)]
