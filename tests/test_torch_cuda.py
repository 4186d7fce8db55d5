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


def _kde_against_plain(cuda, grid, samples, inv_two_bw2):
    """K2 on the card against its plain version on the wrapper's own scaled
    inputs; one launch counted."""
    grid = torch.tensor(np.asarray(grid, np.float32), device=cuda)
    samples = torch.tensor(np.asarray(samples, np.float32), device=cuda)
    before = torch_kde.STATS.launches
    got = torch_kde.kde_logsumexp(grid, samples, inv_two_bw2)
    torch.cuda.synchronize()
    assert torch_kde.STATS.launches == before + 1
    scale = torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32)).to(cuda)
    want = torch_kde.kde_logsumexp_plain(grid * scale, samples * scale)
    assert got.shape == want.shape == (grid.shape[0],)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    return want


@pytest.mark.parametrize("D", range(1, 9))
@pytest.mark.parametrize("G,N", [
    (1, 1), (150, 100_000), (22_500, 5_000), (1000, 513),
    # G not a multiple of the 512 grid points of a block; N from one sample
    # to a few 512-sample tiles
    (511, 1), (513, 37), (1025, 511), (2049, 1537),
])
def test_kde_logsumexp_kernel_matches_plain(cuda, D, G, N):
    rng = np.random.default_rng(D * 7 + G + N)
    _kde_against_plain(cuda, rng.uniform(-1, 1, (G, D)), rng.normal(0, 0.4, (N, D)),
                       1.0 / (2 * 0.05**2))


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


@pytest.mark.parametrize("D", [1, 2, 3, 5, 8])
def test_kde_kernel_far_grid(cuda, D):
    """Every grid point farther than sqrt(200) scaled units from every
    sample: exp underflows in float32, the running max keeps the answer."""
    rng = np.random.default_rng(D)
    samples = rng.normal(0, 0.3, (20_000, D))
    grid = rng.uniform(3, 6, (3000, D)) * rng.choice([-1, 1], (3000, D))
    want = _kde_against_plain(cuda, grid, samples, 200.0)
    assert float(want.max()) < -200


def test_kde_kernel_max_in_last_tile(cuda):
    """Every sample far but the last, nearest to every grid point."""
    rng = np.random.default_rng(2)
    samples = rng.normal(3.0, 0.2, (40_000, 2))
    samples[-1] = [0.0, 0.0]
    _kde_against_plain(cuda, rng.uniform(-0.3, 0.3, (4000, 2)), samples, 200.0)


def test_kde_kernel_sorted_farthest_first(cuda):
    """The main path's shape, grid pushed out, samples sorted by distance
    from a grid corner, farthest first: the running max rises tile by tile."""
    rng = np.random.default_rng(4)
    samples = np.clip(rng.normal(0, 0.4, (100_000, 2)), -1, 1)
    axis = np.linspace(-2.5, 2.5, 150)
    grid = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    samples = samples[np.argsort(-((samples - grid[0]) ** 2).sum(1))]
    _kde_against_plain(cuda, grid, samples, 200.0)


@pytest.mark.parametrize("D", [2, 4, 7])
def test_kde_kernel_first_sample_far(cuda, D):
    """The first 128 samples far away, the rest near: the sum of the first
    near chunk overflows against the max of the far ones and is redone."""
    rng = np.random.default_rng(D)
    samples = rng.normal(0, 0.3, (6000, D))
    samples[:128] += 4.0
    _kde_against_plain(cuda, rng.uniform(-0.6, 0.6, (3000, D)), samples, 200.0)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_kde_kernel_large_coordinates(cuda, D):
    """Coordinates of 1e3 at bandwidth 0.05: scaled values near 1.4e4, where
    the differences must be taken on the caller's scaled inputs."""
    rng = np.random.default_rng(D)
    samples = 1e3 + rng.normal(0, 0.3, (7000, D))
    grid = 1e3 + rng.uniform(-1, 1, (777, D))
    _kde_against_plain(cuda, grid, samples, 1.0 / (2 * 0.05**2))


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


def _autoencoder_config(**architecture):
    return {
        "dimension": 2, "features_normalization": "mean_std",
        "architecture": {"encoder": {"layers": [16, 8], "activation": ["leaky_relu"] * 2,
                                     **architecture}},
        "training": {"general": {"num_tries": 2, "batch_size": 256, "max_epochs": 4},
                     "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}},
                     "kl_annealing": {"type": "sigmoid", "start_epoch": 1,
                                      "n_epochs_anneal": 2}},
    }


@pytest.mark.parametrize("cv,batchnorm", [("ae", False), ("ae", True), ("vae", False)])
def test_autoencoder_training_on_the_card_matches_the_cpu(cuda, monkeypatch, cv,
                                                          batchnorm):
    """The same seeded AE / VAE training (2 tries, 4 epochs, the VAE through
    its KL annealing) on the card and on the CPU: the same initial
    parameters and batches, and the VAE's noise shared (the k-th call's
    draw the same on both devices: the k-th of a seeded bank, read through
    a count on the device, so that a step captured in a CUDA graph draws
    the next one at each replay); with batchnorm, the fold on the card
    too."""
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.models import networks

    x = _toy_features()
    # 4 epochs of 10 steps and 4 validations, the largest draw the
    # validation's 600 rows of 2 tries
    bank = torch.randn((64, 2, 600, 2), generator=torch.Generator().manual_seed(0))
    drawn = {}

    def shared_noise(shape, generators):
        dev = generators[0].device
        if dev not in drawn:
            drawn[dev] = bank.to(dev), torch.zeros(1, dtype=torch.int64, device=dev)
        table, k = drawn[dev]
        draw = table.index_select(0, k)[0, :shape[0], :shape[1], :shape[2]]
        k += 1
        return draw

    monkeypatch.setattr(networks, "reparam_noise", shared_noise)
    config = _autoencoder_config(batchnorm=[batchnorm, batchnorm])
    runs = []
    for device in ("cuda", "cpu"):
        calc = cv_calculators_map[cv](config, device=device)
        calc._set_training_data(x, None, [f"f{i}" for i in range(x.shape[1])])
        assert calc.train()
        calc.normalize_cv()
        runs.append(calc)
    card, host = runs
    assert not any(card.architecture["encoder_options"]["batchnorm"])
    for (_, a), (_, b) in zip(card.try_results, host.try_results):
        for key in a.metrics:
            if key.endswith("loss"):
                np.testing.assert_allclose(a.metrics[key], b.metrics[key], rtol=1e-4,
                                           err_msg=key)
    np.testing.assert_allclose(card.project_data(x), host.project_data(x), atol=1e-4)


def _align_signs(a, b):
    return a * np.sign(np.sum(a * b, axis=0))


def _gapped_features(n=3000, d=20, seed=0):
    """Two slow AR(1) signals (0.999, 0.99) and d fast ones (0.3), mixed into
    d features with a little white noise: the top two TICA components stand
    clear of the rest, so they are well determined in float32 (a random
    walk per feature would give near-degenerate eigenvalues)."""
    rng = np.random.default_rng(seed)
    rho = np.r_[0.999, 0.99, np.full(d, 0.3)]
    z = np.zeros((n, d + 2))
    for t in range(1, n):
        z[t] = rho * z[t - 1] + np.sqrt(1 - rho ** 2) * rng.standard_normal(d + 2)
    mix = rng.standard_normal((d + 2, d))
    return (z @ mix + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


# No training figures: the card machine has no matplotlib, and plot_loss
# (default true) asks for the sensitivity bars and the training curves.
LINEAR_CONFIG = {"dimension": 2, "lag_time": 5, "features_normalization": "mean_std",
                 "num_subspaces": 4, "subspaces_dimension": 3,
                 "training": {"plot_loss": False}}


@pytest.mark.parametrize("cv,d", [("pca", 20), ("pca", 300), ("tica", 20),
                                  ("tica", 300), ("htica", 20), ("htica", 300)])
def test_linear_cvs_on_the_card_match_the_cpu(cuda, tmp_path, cv, d):
    """PCA, TICA and HTICA trained on the card and by the port on the CPU
    from the same matrix (PCA at 300 features takes the host subset eigh):
    projections within 1e-4 after the sign fix, eigenvalues within 1e-4."""
    from deep_cartograph_torch.cv import cv_calculators_map

    x = _gapped_features(d=d)
    runs = []
    for device in ("cuda", "cpu"):
        calc = cv_calculators_map[cv](dict(LINEAR_CONFIG), str(tmp_path / device),
                                      device=device)
        calc._set_training_data(x, None, [f"f{i}" for i in range(d)])
        proj, labels = calc.run()
        runs.append((calc, proj))
    (card, got), (host, want) = runs
    np.testing.assert_allclose(_align_signs(got, want), want, atol=1e-4)
    if cv != "pca":
        np.testing.assert_allclose(card.eigenvalues_, host.eigenvalues_, atol=1e-4)


@pytest.mark.parametrize("cv", ["tica", "htica"])
def test_streaming_on_the_card_matches_the_cpu(cuda, tmp_path, cv):
    """Streaming TICA over 300 features (the on-card Krylov solver) and
    streaming HTICA, from a colvars file, on the card and on the CPU."""
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.io.colvars import write_colvars

    x = _gapped_features(d=300)
    names = [f"f{i}" for i in range(x.shape[1])]
    path = str(tmp_path / "colvars.dat")
    write_colvars(path, np.column_stack([np.arange(len(x)), x]), ["time"] + names,
                  fmt="%.9g")
    runs = []
    for device in ("cuda", "cpu"):
        calc = cv_calculators_map[cv](dict(LINEAR_CONFIG, streaming=True),
                                      str(tmp_path / device), device=device)
        calc.load_training_data([path])
        assert calc._streaming
        runs.append((calc, calc.run()[0]))
    (card, got), (host, want) = runs
    np.testing.assert_allclose(_align_signs(got, want), want, atol=1e-4)
    np.testing.assert_allclose(card.eigenvalues_, host.eigenvalues_, atol=1e-4)


def _ca_system(folder, n_atoms=12, n_frames=400, seed=0):
    """A CA chain (PDB) with a random-walk trajectory (DCD)."""
    import os

    from deep_cartograph_torch.io.dcd import write_dcd

    rng = np.random.default_rng(seed)
    base = np.stack([np.arange(n_atoms) * 3.8, np.zeros(n_atoms), np.zeros(n_atoms)], 1)
    walk = np.cumsum(rng.normal(0, 0.05, (n_frames, n_atoms, 3)), 0)
    coords = (base + walk + rng.normal(0, 0.1, walk.shape)).astype(np.float32)
    pdb = os.path.join(folder, "ca.pdb")
    with open(pdb, "w") as fh:
        for i, (x, y, z) in enumerate(coords[0]):
            fh.write(f"ATOM  {i + 1:>5}  CA  ALA A{i + 1:>4}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           C\n")
        fh.write("END\n")
    dcd = os.path.join(folder, "traj.dcd")
    write_dcd(dcd, coords)
    return pdb, dcd, coords


@pytest.mark.parametrize("cv", ["tica", "deep_tica", "ae", "vae"])
def test_from_model_zip_on_the_card_matches_project_data(cuda, tmp_path, cv):
    """A CV trained on the card from a colvars file, saved, and served from
    the DCD by FramesToCV.from_model_zip (K1) on the card, against the
    calculator's project_data of the featurized frames (1e-4)."""
    from deep_cartograph_torch.cv import cv_calculators_map
    from deep_cartograph_torch.deploy import FramesToCV
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.colvars import write_colvars
    from deep_cartograph_torch.io.topology import Topology

    pdb, dcd, coords = _ca_system(str(tmp_path))
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, 13) for j in range(i + 3, 13)]
    features = Featurizer(Topology.from_pdb(pdb), labels, device="cpu")(coords)
    path = str(tmp_path / "colvars.dat")
    write_colvars(path, np.column_stack([np.arange(len(features)), features]),
                  ["time"] + labels, fmt="%.9g")
    config = dict(LINEAR_CONFIG, architecture={"encoder": {"layers": [16],
                                                           "activation": ["tanh"]}},
                  training={"general": {"num_tries": 2, "batch_size": 64,
                                        "max_epochs": 3}, "plot_loss": False})
    calc = cv_calculators_map[cv](config, str(tmp_path / "out"))
    calc.load_training_data([path], [pdb])
    assert calc.run() is not None
    model = str(tmp_path / "out" / cv / "model.zip")
    before = torch_pd.STATS.launches
    served = FramesToCV.from_model_zip(model, pdb, str(tmp_path / "serve"))(coords)
    assert torch_pd.STATS.launches > before
    np.testing.assert_allclose(served, calc.project_data(features), atol=1e-4)


def _blobs(n, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (4, 2))
    x = centers[rng.integers(0, 4, n)] + rng.normal(0, 0.5, (n, 2))
    x[: int(noise * n)] = rng.uniform(-10, 10, (int(noise * n), 2))
    return x.astype(np.float32)


def test_kmeans_on_the_card_matches_the_cpu(cuda):
    """Batched Lloyd runs from shared centres: the same labels, centroids
    within 1e-5; the card's labels come back from a CPU warm start."""
    from deep_cartograph_torch.cluster import clustering

    x = _blobs(5000, 1)
    rng = np.random.default_rng(2)
    inits = np.stack([x[rng.choice(len(x), 6, replace=False)] for _ in range(8)])
    card = clustering._lloyd(torch.tensor(x, device=cuda), torch.tensor(inits, device=cuda))
    cpu = clustering._lloyd(torch.tensor(x), torch.tensor(inits))
    np.testing.assert_array_equal(card[1].cpu().numpy(), cpu[1].numpy())
    np.testing.assert_allclose(card[0].cpu().numpy(), cpu[0].numpy(), atol=1e-5)
    labels, centers = clustering.kmeans_clustering(x, 6, 10)
    back, _ = clustering.kmeans_clustering(x, 6, 1, initial_centroids=centers, device="cpu")
    np.testing.assert_array_equal(back, labels)


def test_scores_on_the_card_match_the_cpu(cuda):
    from deep_cartograph_torch.cluster import clustering

    x = _blobs(4000, 3)
    labels = np.random.default_rng(4).integers(-1, 5, len(x))
    np.testing.assert_allclose(clustering.clustering_scores(x, labels),
                               clustering.clustering_scores(x, labels, device="cpu"),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(min_cluster_size=5, min_samples=3),
                                dict(min_cluster_size=5, cluster_selection_method="leaf"),
                                dict(min_cluster_size=5, cluster_selection_epsilon=0.5)])
def test_hdbscan_on_the_card_matches_the_cpu(cuda, kw):
    """float64 core distances and Prim's tree on the card: the same labels,
    probabilities and centroids within 1e-9, duplicated rows included."""
    from deep_cartograph_torch.cluster import clustering

    x = _blobs(3000, 5)
    x = np.concatenate([x, x[:200], np.round(x[:300], 1)])
    card = clustering.hdbscan_fit(x, **kw)
    cpu = clustering.hdbscan_fit(x, device="cpu", **kw)
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_allclose(card[1], cpu[1], atol=1e-9, rtol=0)
    np.testing.assert_allclose(clustering.hdbscan_clustering(x, **kw)[1],
                               clustering.hdbscan_clustering(x, device="cpu", **kw)[1],
                               atol=1e-9, rtol=0)


def test_nearest_neighbor_on_the_card_matches_the_cpu(cuda, monkeypatch):
    from deep_cartograph_torch.cluster import clustering

    rng = np.random.default_rng(6)
    new = rng.normal(size=(3000, 2)).astype(np.float32)
    ref = rng.normal(size=(2000, 2)).astype(np.float32)
    monkeypatch.setattr(clustering, "TILE_ELEMENTS", 2000 * 7)   # blocks of 7 rows
    card = clustering.assign_nearest_neighbor(new, ref)
    cpu = clustering.assign_nearest_neighbor(new, ref, device="cpu")
    d = ((new[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    rows = np.arange(len(new))
    np.testing.assert_allclose(d[rows, card], d[rows, cpu], rtol=1e-5, atol=1e-6)
    assert (card == cpu).mean() > 0.999


def test_multi_trajectory_featurization_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Three XTC trajectories of uneven length through shared chunks (K1)."""
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.io.xtc import write_xtc

    pdb, _, coords = _ca_system(str(tmp_path))
    paths = []
    for i, part in enumerate(np.split(coords, [11, 37])):
        paths.append(str(tmp_path / f"part{i}.xtc"))
        write_xtc(paths[-1], part)
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, 13) for j in range(i + 3, 13)]
    labels += ["sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_5-@CA_6-@CA_7-@CA_8"]
    top = Topology.from_pdb(pdb)
    before = torch_pd.STATS.launches
    card = Featurizer(top, labels).featurize_trajectories(paths, frame_chunk=16)
    assert torch_pd.STATS.launches > before
    cpu = Featurizer(top, labels, device="cpu").featurize_trajectories(paths, frame_chunk=16)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_rmsd_and_rmsf_on_the_card_match_the_cpu(cuda, tmp_path):
    """The batched Kabsch fits (SVD of (frames, 3, 3)) on the card."""
    from deep_cartograph_torch.geom.analysis import RMSD, RMSF, dRMSD

    pdb, dcd, coords = _ca_system(str(tmp_path))
    for fn, args in ((RMSD, ("name CA", "name CA")), (RMSF, ("name CA", "name CA")),
                     (dRMSD, ("name CA", 1, pdb))):
        card = fn(dcd, pdb, *args)
        cpu = fn(dcd, pdb, *args, device="cpu")
        np.testing.assert_allclose(np.asarray(card[0] if fn is RMSF else card),
                                   np.asarray(cpu[0] if fn is RMSF else cpu),
                                   atol=1e-5, rtol=0)


def test_umap_graph_and_one_epoch_on_the_card_match_the_cpu(cuda):
    """The blocked kNN, sigma search and fuzzy weights on the card against
    the CPU; then one layout epoch from the same embedding, graph and draws
    (index_add_ sums duplicate heads in no fixed order on the card)."""
    from deep_cartograph_torch.cv import umap_cv as tu

    rng = np.random.default_rng(71)
    x = (rng.normal(size=(3000, 20)) * np.linspace(3, 0.2, 20)).astype(np.float32)
    graphs = {}
    for dev in ("cuda", "cpu"):
        xt = torch.as_tensor(x, device=dev)
        dists, idx = tu._knn(xt, xt, 15, exclude_self=True, row_block=257)
        w = tu._fuzzy_weights(dists, *tu._smooth_knn(dists))
        graphs[dev] = (dists.cpu().numpy(), idx.cpu().numpy(), w.cpu().numpy())
    (dc, ic, wc), (dh, ih, wh) = graphs["cuda"], graphs["cpu"]
    np.testing.assert_allclose(dc, dh, atol=1e-5, rtol=0)
    same = ic == ih
    assert same.mean() > 0.999
    # a differing neighbour is a near tie: its distance is the CPU's
    np.testing.assert_allclose(dc[~same], dh[~same], atol=1e-5, rtol=0)
    # the weights' exp amplifies the distances' last bits through sigma
    np.testing.assert_allclose(wc[same.all(1)], wh[same.all(1)], atol=1e-5, rtol=1e-4)
    heads, tails, weights = tu._symmetrize(ih, wh, len(x))
    init = tu._pca_init(torch.as_tensor(x), 2)
    uniform = rng.uniform(size=len(heads)).astype(np.float32)
    negatives = rng.integers(0, len(x), (len(heads), 5))
    model = tu.UMAPModel(2, device="cpu")

    def epoch(dev, embedding):
        return tu.layout_epoch(
            embedding.to(dev).clone(), *(torch.as_tensor(v, device=dev)
                                         for v in (heads, tails, weights, uniform)),
            torch.as_tensor(negatives, device=dev), 1.0, model.a, model.b).cpu().numpy()

    cpu = epoch("cpu", init)
    card = [epoch("cuda", init) for _ in range(3)]
    noise = torch.randn(init.shape, generator=torch.Generator().manual_seed(1))
    card.append(epoch("cuda", init * (1 + 6e-8 * noise)))
    assert np.abs(cpu - init.numpy()).max() > 1e-3
    # index_add_ sums a row's updates in no fixed order on the card, and a
    # near negative sample amplifies a last-bit difference: the card is held
    # to 3 x its own spread over repeats and one-ulp input noise
    spread = max(np.abs(c - card[0]).max() for c in card)
    assert np.abs(card[0] - cpu).max() <= max(1e-5, 3 * spread)


def test_int16_featurization_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The DCD read by the prefetching reader, sent as int16, dequantized on
    the card and featurized through K1, against the same on the CPU."""
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.topology import Topology

    pdb, dcd, _ = _ca_system(str(tmp_path))
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, 13) for j in range(i + 2, 13)]
    labels += ["sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_5-@CA_6-@CA_7-@CA_8"]
    top = Topology.from_pdb(pdb)
    before = torch_pd.STATS.launches
    card = Featurizer(top, labels).featurize_trajectory(dcd, frame_chunk=64, upload="int16")
    assert torch_pd.STATS.launches == before + 7
    cpu = Featurizer(top, labels, device="cpu").featurize_trajectory(
        dcd, frame_chunk=64, upload="int16")
    np.testing.assert_allclose(card, cpu, atol=1e-5, rtol=0)


def _htica_blocks(n_frames=1200, n_feat=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_frames, n_feat)).astype(np.float32)
    return (np.cumsum(x, axis=0) / 10 + x).astype(np.float32)


def _device_rows(x, start, size):
    return x.index_select(0, start + torch.arange(size, device=x.device))


@pytest.mark.parametrize("k", [1, 3, 12])
def test_fit_chunked_graph_matches_eager(cuda, k):
    """fit_chunked replays a CUDA graph of k blocks on the card; on the CPU
    the same body runs eagerly. Both, and fit_fused and fit on the card,
    give one estimator."""
    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA

    x = _htica_blocks()
    block = 100

    def fitted(device, method, **kw):
        est = StreamingHTICA(24, 4, 3, 2, lag_time=5, device=device)
        xt = torch.as_tensor(x, device=device)
        if method == "fit":
            est.fit(lambda: (xt[s:s + block] for s in range(0, len(x), block)))
        elif method == "fit_fused":
            est.fit_fused(lambda start: _device_rows(xt, start, block), len(x), block)
        else:
            est.fit_chunked(lambda start, buf: _device_rows(buf, start, block), len(x),
                            block, block_args=(xt,), **kw)
        return est

    graph = fitted("cuda", "fit_chunked", blocks_per_dispatch=k)
    want = x @ graph.weights
    for est in (fitted("cpu", "fit_chunked", blocks_per_dispatch=k),
                fitted("cuda", "fit_fused"), fitted("cuda", "fit")):
        np.testing.assert_allclose(graph.eigenvalues_, est.eigenvalues_, atol=1e-5)
        # the CPU's and the card's eigensolvers may give opposite signs
        np.testing.assert_allclose(_align_signs(x @ est.weights, want), want, atol=1e-5)


def test_graph_replays_launch_k1_that_no_wrapper_counts(cuda):
    """K1 inside fit_chunked's block_fn: its wrapper counts the eager calls
    of each pass (the shift, the warm-up block, the tail check) and not the
    capture; torch.profiler's trace shows those and every replayed block."""
    from torch.profiler import ProfilerActivity, profile

    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA

    rng = np.random.default_rng(5)
    points = torch.tensor(rng.normal(30, 10, (1200, 8, 3)).astype(np.float32), device=cuda)
    pairs = torch.tensor([(i, j) for i in range(8) for j in range(i + 1, 8)],
                         dtype=torch.int32, device=cuda)
    est = StreamingHTICA(28, 4, 3, 2, lag_time=5)
    before = torch_pd.STATS.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.fit_chunked(lambda start: torch_pd.pair_distances(
            _device_rows(points, start, 100), pairs), 1200, 100, blocks_per_dispatch=3)
        torch.cuda.synchronize()
    traced = sum(e.device_type == torch.autograd.DeviceType.CUDA
                 and "pair_distances_kernel" in e.name for e in prof.events())
    assert torch_pd.STATS.launches - before == 2 * 3
    assert traced == 2 * 3 + 2 * 12


def test_fit_chunked_refuses_a_block_fn_it_cannot_capture(cuda):
    """A block_fn that waits for the card cannot be captured; one whose
    blocks come from Python state replays stale blocks. Both raise."""
    from deep_cartograph_torch.cv.htica_stream import StreamingHTICA

    x = torch.as_tensor(_htica_blocks(), device="cuda")
    est = StreamingHTICA(24, 4, 3, 2, lag_time=5)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        est.fit_chunked(lambda start: x[int(start):int(start) + 100], len(x), 100,
                        blocks_per_dispatch=3)
    calls = iter(range(10**6))

    def from_python_state(start):
        i = next(calls) % 12
        return x[i * 100:(i + 1) * 100]

    with pytest.raises(RuntimeError, match="not capturable"):
        est.fit_chunked(from_python_state, len(x), 100, blocks_per_dispatch=3)


def _card_mesh():
    """Every visible card, or the first listed four times with one."""
    from deep_cartograph_torch.parallel.mesh import Mesh

    n = torch.cuda.device_count()
    return Mesh([f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 4)


def test_k1_on_a_mesh_launches_once_a_shard_and_matches_one_device(cuda, tmp_path):
    """The Featurizer and FramesToCV on the card mesh: K1 once per shard of
    a chunk, features equal to the one-device path (each frame alone)."""
    from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.parallel.mesh import Mesh, use_mesh

    pdb, dcd, coords = _ca_system(str(tmp_path), n_frames=403)
    top = Topology.from_pdb(pdb)
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, 13) for j in range(i + 1, 13)]
    labels += [f"{f}-@CA_1-@CA_2-@CA_3-@CA_4" for f in ("sin", "cos")]
    mesh = _card_mesh()
    with use_mesh(Mesh(["cuda:0"])):
        one = Featurizer(top, labels).featurize_trajectory(dcd, frame_chunk=128)
    with use_mesh(mesh):
        before = torch_pd.STATS.launches
        got = Featurizer(top, labels).featurize_trajectory(dcd, frame_chunk=128)
        torch.cuda.synchronize()
        assert torch_pd.STATS.launches - before == 4 * len(mesh)  # 4 chunks
        np.testing.assert_allclose(got, one, atol=1e-6, rtol=0)
        n = len(labels)
        projection = LinearProjection(np.zeros(n), np.ones(n), np.eye(n)[:, :2],
                                      np.zeros(2), np.ones(2))
        before = torch_pd.STATS.launches
        cv = FramesToCV(projection, top, labels)(coords)
        assert torch_pd.STATS.launches - before == len(mesh)
    np.testing.assert_allclose(cv, one[:, :2], atol=1e-6, rtol=0)


def test_k2_on_a_mesh_launches_once_a_shard_and_matches_one_device(cuda):
    from deep_cartograph_torch.parallel.mesh import use_mesh
    from deep_cartograph_torch.parallel.sharding import sharded_kde_logsumexp

    rng = np.random.default_rng(5)
    samples = rng.normal(0, 1, (20_003, 2)).astype(np.float32)
    grid = rng.uniform(-3, 3, (900, 2)).astype(np.float32)
    mesh = _card_mesh()
    with use_mesh(mesh):
        before = torch_kde.STATS.launches
        got = sharded_kde_logsumexp(grid, samples, 50.0).cpu().numpy() - np.log(len(samples))
        assert torch_kde.STATS.launches - before == len(mesh)
    one = torch_kde.kde_logsumexp(torch.as_tensor(grid, device="cuda"),
                                  torch.as_tensor(samples, device="cuda"), 50.0)
    want = one.cpu().numpy() - np.log(len(samples))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _backbone_frames(folder, n_res=20, n_frames=3000, seed=2):
    """A backbone of N, CA, C, O atoms a residue (PDB) with random-walk
    frames, and labels that read the CA atoms alone: the distances of
    residues three or more apart, sin and cos of every CA dihedral."""
    import os

    from deep_cartograph_torch.io.topology import Topology

    rng = np.random.default_rng(seed)
    n_atoms = 4 * n_res
    base = np.stack([np.arange(n_atoms) * 0.95, np.sin(np.arange(n_atoms)),
                     np.cos(np.arange(n_atoms))], 1) * 1.5
    walk = np.cumsum(rng.normal(0, 0.02, (n_frames, n_atoms, 3)), 0)
    coords = (base + walk + rng.normal(0, 0.1, walk.shape)).astype(np.float32)
    pdb = os.path.join(folder, "backbone.pdb")
    with open(pdb, "w") as fh:
        for i, (x, y, z) in enumerate(coords[0]):
            name, res = ("N", "CA", "C", "O")[i % 4], i // 4 + 1
            fh.write(f"ATOM  {i + 1:>5}  {name:<3} ALA A{res:>4}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           {name[0]}\n")
        fh.write("END\n")
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, n_res + 1)
              for j in range(i + 3, n_res + 1)]
    labels += [f"{f}-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}"
               for i in range(1, n_res - 2) for f in ("sin", "cos")]
    return Topology.from_pdb(pdb), coords, labels


@pytest.fixture
def small_ring(monkeypatch):
    """Slots of 256 frames of 20 atoms: a ring of 768 frames."""
    from deep_cartograph_torch.geom import transport

    monkeypatch.setattr(transport, "SLOT_BYTES", 256 * 20 * 12)
    return 256


def _staged_pipeline(top, labels):
    from deep_cartograph_torch.deploy import FramesToCV, LinearProjection

    n = len(labels)
    rng = np.random.default_rng(4)
    projection = LinearProjection(rng.normal(size=n), rng.uniform(0.5, 2.0, n),
                                  rng.normal(size=(n, 2)) / np.sqrt(n), np.zeros(2),
                                  np.ones(2))
    return FramesToCV(projection, top, labels)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 3000])
def test_staged_upload_matches_a_pageable_copy(cuda, tmp_path, small_ring, n):
    """Host frames staged (the 20 CA atoms of 80, chunks of 256 frames, up
    to four times round the ring) against the whole frames copied up
    pageable and evaluated in one piece: features bit for bit, CVs within
    1e-5, the counter at 240 bytes a frame."""
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.geom.kernels import UPLOAD_STATS, PlanEvaluator

    top, coords, labels = _backbone_frames(str(tmp_path))
    frames = coords[:n]
    ev = PlanEvaluator(compile_plan(labels, top))
    UPLOAD_STATS.reset()
    got = ev.eval_raw(frames)
    assert UPLOAD_STATS.chunks == -(-n // small_ring)
    assert (UPLOAD_STATS.bytes_sent, UPLOAD_STATS.bytes_held) == (n * 240, n * 960)
    want = ev.eval_raw(torch.as_tensor(frames).to(cuda))
    assert torch.equal(got, want)
    pipeline = _staged_pipeline(top, labels)
    staged = pipeline(frames)
    whole = pipeline(torch.as_tensor(frames).to(cuda))
    np.testing.assert_allclose(staged, whole, atol=1e-5, rtol=0)


def test_staged_calls_back_to_back_and_an_overwritten_array(cuda, tmp_path, small_ring):
    """Two calls on different frames with nothing waited for between them,
    and a caller that overwrites its array as soon as each call returns:
    every result as if each call had run alone."""
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.geom.kernels import PlanEvaluator

    top, coords, labels = _backbone_frames(str(tmp_path))
    ev = PlanEvaluator(compile_plan(labels, top))
    want = [ev.eval_raw(torch.as_tensor(coords[a:a + 1000]).to(cuda)) for a in (0, 1000)]
    torch.cuda.synchronize()
    buffer = coords[:1000].copy()
    first = ev.eval_raw(buffer)
    buffer[:] = np.nan
    second = ev.eval_raw(coords[1000:2000])
    buffer[:] = coords[2000:3000]
    assert torch.equal(first, want[0]) and torch.equal(second, want[1])
    pipeline = _staged_pipeline(top, labels)
    cv_want = [pipeline(coords[a:a + 1000]) for a in (0, 1000)]
    buffer = coords[:1000].copy()
    cvs = [pipeline.eval_raw(buffer)]
    buffer[:] = np.nan
    cvs.append(pipeline.eval_raw(coords[1000:2000]))
    for got, cv in zip(cvs, cv_want):
        np.testing.assert_allclose(got.cpu().numpy(), cv, atol=1e-6, rtol=0)


def test_a_staged_call_waits_for_the_card_only_at_its_copy_back(cuda, tmp_path, small_ring):
    """Under `torch.cuda.set_sync_debug_mode("error")` from the first
    gather to the copy back, a FramesToCV call four times round the ring
    raises nowhere: the copies are asynchronous from pinned slots and a
    slot is waited for on its event alone."""
    top, coords, labels = _backbone_frames(str(tmp_path))
    pipeline = _staged_pipeline(top, labels)
    want = pipeline(coords)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cvs = pipeline.eval_raw(coords)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_allclose(cvs.cpu().numpy(), want, atol=1e-6, rtol=0)
