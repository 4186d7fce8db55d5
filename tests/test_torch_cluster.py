"""The port's clustering (deep_cartograph_torch/cluster) against the JAX
package's and against scikit-learn, on the CPU.

k-means++ draws differ between the packages (a torch generator against
jax.random), so k-means is held through warm starts from shared centroids;
HDBSCAN and the agglomerative tree are held label for label."""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import HDBSCAN
from sklearn.metrics import (
    adjusted_rand_score,
    calinski_harabasz_score,
    davies_bouldin_score,
    silhouette_score,
)

import deep_cartograph_torch.cluster.clustering as tc
import deep_cartograph_tpu.cluster.clustering as jc

torch.set_num_threads(2)

CENTROID_TOL = 1e-5     # float32 Lloyd means, sums in another order
SCORE_RTOL = 1e-4       # float32 scores against float64 references
HDBSCAN_TOL = 1e-9      # float64 probabilities and centroids


def blobs(n, seed, n_centers=4, spread=0.5, noise=0.0, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (n_centers, d))
    truth = rng.integers(0, n_centers, n)
    x = centers[truth] + rng.normal(0, spread, (n, d))
    m = int(noise * n)
    x[:m] = rng.uniform(-10, 10, (m, d))
    return x.astype(np.float32), truth


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,d,seed", [(300, 3, 2, 0), (500, 6, 2, 1), (257, 5, 7, 2)])
def test_kmeans_warm_start_matches_jax(n, k, d, seed):
    x, _ = blobs(n, seed, n_centers=k, d=d)
    init = x[np.random.default_rng(seed + 10).choice(n, k, replace=False)]
    labels, centers = tc.kmeans_clustering(x, k, 1, initial_centroids=init, device="cpu")
    want_centers, want_labels = jc._kmeans_warmstart(jnp.asarray(x), jnp.asarray(init))
    np.testing.assert_array_equal(labels, np.asarray(want_labels))
    np.testing.assert_allclose(centers, np.asarray(want_centers), atol=CENTROID_TOL, rtol=0)
    jax_labels, jax_centers = jc.kmeans_clustering(x, k, 1, initial_centroids=init)
    np.testing.assert_array_equal(labels, jax_labels)


def test_batched_lloyd_freezes_each_restart_on_its_own():
    """R restarts from given centre sets in one batched run equal the JAX
    warm start from each set alone, though they converge after different
    numbers of iterations."""
    x, _ = blobs(600, 3, n_centers=5)
    rng = np.random.default_rng(4)
    inits = np.stack([x[rng.choice(len(x), 5, replace=False)] for _ in range(6)])
    centers, assign, inertia, iters = tc._lloyd(torch.as_tensor(x), torch.as_tensor(inits))
    assert len(set(iters.tolist())) > 1, iters
    for r in range(len(inits)):
        want_centers, want_labels = jc._kmeans_warmstart(jnp.asarray(x),
                                                         jnp.asarray(inits[r]))
        np.testing.assert_array_equal(assign[r].numpy(), np.asarray(want_labels))
        np.testing.assert_allclose(centers[r].numpy(), np.asarray(want_centers),
                                   atol=CENTROID_TOL, rtol=0)
        alone = tc._lloyd(torch.as_tensor(x), torch.as_tensor(inits[r : r + 1]))
        assert int(alone[3][0]) == int(iters[r])
        torch.testing.assert_close(alone[0][0], centers[r], atol=0, rtol=0)
        np.testing.assert_allclose(
            float(inertia[r]),
            float(((x - np.asarray(want_centers)[np.asarray(want_labels)]) ** 2).sum()),
            rtol=1e-5)


def test_kmeans_cold_start_recovers_separated_blobs():
    x, truth = blobs(800, 5, n_centers=4, spread=0.2)
    labels, centers = tc.kmeans_clustering(x, 4, 10, seed=3, device="cpu")
    assert centers.shape == (4, 2)
    assert adjusted_rand_score(truth, labels) == 1.0
    jax_labels, _ = jc.kmeans_clustering(x, 4, 10)
    assert adjusted_rand_score(jax_labels, labels) == 1.0


def test_kmeans_with_fewer_distinct_points_than_k():
    x = np.repeat(np.arange(10, dtype=np.float32).reshape(5, 2), 7, axis=0)
    labels, centers = tc.kmeans_clustering(x, 8, 4, seed=1, device="cpu")
    assert labels.shape == (35,) and centers.shape == (8, 2)
    assert np.isfinite(centers).all()
    # every point sits on its own centre
    np.testing.assert_array_equal(centers[labels], x)


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------

def _sklearn_scores(x, labels):
    return (calinski_harabasz_score(x, labels), davies_bouldin_score(x, labels),
            silhouette_score(x, labels))


@pytest.mark.parametrize("case", ["kmeans", "noise", "three_d"])
def test_scores_match_jax_and_sklearn(case):
    x, truth = blobs(400, 7, n_centers=3, d=3 if case == "three_d" else 2)
    labels = truth.copy()
    if case == "noise":
        labels[::9] = -1
    got = tc.clustering_scores(x, labels, device="cpu")
    np.testing.assert_allclose(got, jc.clustering_scores(x, labels), rtol=SCORE_RTOL)
    np.testing.assert_allclose(got, _sklearn_scores(x.astype(np.float64), labels),
                               rtol=SCORE_RTOL)


def test_scores_blocked_equal_dense():
    x, labels = blobs(300, 8, n_centers=4)
    data, lab = torch.as_tensor(x), torch.as_tensor(labels)
    dense = torch.stack(tc._scores_device(data, lab, 4, 300))
    for block in (1, 7, 128, 299):
        torch.testing.assert_close(torch.stack(tc._scores_device(data, lab, 4, block)),
                                   dense, rtol=1e-6, atol=0)
    np.testing.assert_allclose(dense.numpy(), _sklearn_scores(x.astype(np.float64), labels),
                               rtol=SCORE_RTOL)


def test_scores_of_all_noise_are_nan():
    x, _ = blobs(50, 9)
    assert all(np.isnan(tc.clustering_scores(x, -np.ones(50, int), device="cpu")))


# ---------------------------------------------------------------------------
# HDBSCAN
# ---------------------------------------------------------------------------

HDBSCAN_CASES = {
    "eom": dict(min_cluster_size=5),
    "eom_min_samples_1": dict(min_cluster_size=10, min_samples=1),
    "eom_min_samples_3": dict(min_cluster_size=5, min_samples=3),
    "leaf": dict(min_cluster_size=5, cluster_selection_method="leaf"),
    "leaf_min_samples_3": dict(min_cluster_size=5, min_samples=3,
                               cluster_selection_method="leaf"),
    "eom_epsilon": dict(min_cluster_size=5, min_samples=3, cluster_selection_epsilon=0.5),
    "leaf_epsilon": dict(min_cluster_size=5, min_samples=3, cluster_selection_epsilon=0.5,
                         cluster_selection_method="leaf"),
    "max_cluster_size": dict(min_cluster_size=5, max_cluster_size=40),
}


def _sklearn_hdbscan(x, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return HDBSCAN(store_centers="centroid", copy=False, **kw).fit(x)


def _check_hdbscan(x, kw):
    labels, probs = tc.hdbscan_fit(x, device="cpu", **kw)
    want = _sklearn_hdbscan(x, **kw)
    np.testing.assert_array_equal(labels, want.labels_)
    np.testing.assert_allclose(probs, want.probabilities_, atol=HDBSCAN_TOL, rtol=0)
    got_labels, centroids = tc.hdbscan_clustering(x, device="cpu", **kw)
    np.testing.assert_array_equal(got_labels, labels)
    assert centroids.shape == want.centroids_.shape
    np.testing.assert_allclose(centroids, want.centroids_, atol=HDBSCAN_TOL, rtol=0)
    jax_labels, jax_centroids = jc.hdbscan_clustering(x, **kw)
    np.testing.assert_array_equal(labels, jax_labels)
    np.testing.assert_allclose(centroids, jax_centroids, atol=HDBSCAN_TOL, rtol=0)
    return labels


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(HDBSCAN_CASES))
def test_hdbscan_matches_sklearn(case, seed):
    x, _ = blobs(300 + 91 * seed, seed, noise=0.1)
    labels = _check_hdbscan(x, HDBSCAN_CASES[case])
    assert labels.max() >= 1 and (labels == -1).any()


@pytest.mark.parametrize("kw", [dict(min_cluster_size=5, min_samples=3),
                                dict(min_cluster_size=5)])
def test_hdbscan_ties_from_duplicated_rows(kw):
    """Duplicated and rounded rows give equal mutual reachabilities: Prim's
    order, the edge sort and the tree steps must break the ties as
    scikit-learn does."""
    x, _ = blobs(200, 11, noise=0.1)
    dup = np.concatenate([x, x[:50], x[:20]])
    _check_hdbscan(dup, kw)
    _check_hdbscan(np.round(blobs(400, 12, noise=0.1)[0], 1), kw)
    _check_hdbscan(np.round(blobs(400, 13, noise=0.1)[0], 0), kw)


def test_hdbscan_non_finite_rows():
    """Rows with an inf get label -2 and probability 0, rows with a NaN -3
    and NaN, as scikit-learn labels them; the centroids are the
    probability-weighted means over the finite rows. (The JAX package's
    scikit-learn call with store_centers raises on such input: the centre
    step indexes the finite rows with the labels of all rows.)"""
    x, _ = blobs(300, 14, noise=0.1)
    x = x.astype(np.float64)
    x[5, 0], x[17, 1], x[30] = np.inf, np.nan, (np.inf, -np.inf)
    labels, probs = tc.hdbscan_fit(x, min_cluster_size=5, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = HDBSCAN(min_cluster_size=5, copy=False).fit(x)
    np.testing.assert_array_equal(labels, want.labels_)
    np.testing.assert_allclose(probs, want.probabilities_, atol=HDBSCAN_TOL, rtol=0)
    assert labels[[5, 17, 30]].tolist() == [-2, -3, -3]
    _, centroids = tc.hdbscan_clustering(x, min_cluster_size=5, device="cpu")
    for c in range(labels.max() + 1):
        m = labels == c
        np.testing.assert_allclose(centroids[c], np.average(x[m], weights=probs[m], axis=0),
                                   atol=HDBSCAN_TOL, rtol=0)
    with pytest.raises(IndexError):
        jc.hdbscan_clustering(x, min_cluster_size=5)


@pytest.mark.parametrize("kw", [dict(min_cluster_size=1), dict(min_samples=0),
                                dict(cluster_selection_epsilon=-1.0),
                                dict(max_cluster_size=0),
                                dict(cluster_selection_method="tree"),
                                dict(min_samples=500)])
def test_hdbscan_rejects_what_sklearn_rejects(kw):
    x, _ = blobs(60, 15)
    with pytest.raises(ValueError):
        _sklearn_hdbscan(x, **kw)
    with pytest.raises(ValueError):
        tc.hdbscan_fit(x, device="cpu", **kw)


def test_hdbscan_n_jobs_keeps_slurm_default(monkeypatch):
    monkeypatch.setenv("SLURM_CPUS_PER_TASK", "4")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    x, _ = blobs(120, 16)
    a = tc.hdbscan_clustering(x, n_jobs=None, device="cpu")
    b = tc.hdbscan_clustering(x, n_jobs=1, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------------------------------------
# Hierarchical
# ---------------------------------------------------------------------------

def _relabelled(got, want):
    """The permutation p with p[got] == want (asserting one exists)."""
    pairs = set(zip(got.tolist(), want.tolist()))
    mapping = dict(pairs)
    assert len(pairs) == len(mapping) == len(set(mapping.values()))
    return mapping


@pytest.mark.parametrize("linkage", ["complete", "average", "single", "ward"])
@pytest.mark.parametrize("n_clusters", [2, 5])
def test_hierarchical_matches_jax(linkage, n_clusters):
    x, _ = blobs(150, 17, n_centers=5, spread=0.8)   # no tied merge heights
    labels, centroids = tc.hierarchical_clustering(x, None, n_clusters, linkage)
    want_labels, want_centroids = jc.hierarchical_clustering(x, None, n_clusters, linkage)
    mapping = _relabelled(labels, want_labels)
    assert len(mapping) == n_clusters
    for got, want in mapping.items():
        np.testing.assert_allclose(centroids[got], want_centroids[want], rtol=1e-6)


def test_hierarchical_cutoff_and_argument_checks():
    x, _ = blobs(120, 18, n_centers=3)
    labels, _ = tc.hierarchical_clustering(x, 3.0, None)
    want, _ = jc.hierarchical_clustering(x, 3.0, None)
    _relabelled(labels, want)
    for args in ((None, None), (3.0, 4)):
        with pytest.raises(ValueError) as port_err:
            tc.hierarchical_clustering(x, *args)
        with pytest.raises(ValueError) as jax_err:
            jc.hierarchical_clustering(x, *args)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("algorithm", ["hierarchical", "kmeans"])
def test_optimize_clustering_picks_the_jax_k(algorithm):
    x, _ = blobs(240, 19, n_centers=5, spread=0.3)
    settings = {"algorithm": algorithm, "search_interval": [2, 8], "n_init": 10}
    labels, centroids = tc.optimize_clustering(x, settings, device="cpu")
    want_labels, want_centroids = jc.optimize_clustering(x, settings)
    assert len(centroids) == len(want_centroids)
    _relabelled(labels, want_labels)


# ---------------------------------------------------------------------------
# Dispatch and helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["kmeans", "hdbscan", "hierarchical"])
def test_cluster_data_fallback_defaults_equal_jax(monkeypatch, algorithm):
    """The arguments each package's cluster_data passes on when settings
    give only the algorithm (clustering.py:312-321 of the JAX package)."""
    seen = {}

    def spy(tag):
        def record(*args, **kwargs):
            seen[tag] = (args[1:], {k: v for k, v in kwargs.items() if k != "device"})
            return np.zeros(len(args[0]), int), np.zeros((1, 2))
        return record

    name = {"kmeans": "kmeans_clustering", "hdbscan": "hdbscan_clustering",
            "hierarchical": "hierarchical_clustering"}[algorithm]
    monkeypatch.setattr(tc, name, spy("port"))
    monkeypatch.setattr(jc, name, spy("jax"))
    x = np.zeros((2500, 2), np.float32)
    tc.cluster_data(x, {"algorithm": algorithm}, device="cpu")
    jc.cluster_data(x, {"algorithm": algorithm})
    assert seen["port"] == seen["jax"]
    with pytest.raises(ValueError, match="not implemented"):
        tc.cluster_data(x, {"algorithm": "dbscan"}, device="cpu")


def test_find_centroids_marks_the_jax_samples():
    x, _ = blobs(500, 20, n_centers=4)
    _, centroids = tc.kmeans_clustering(x, 4, 5, device="cpu")
    mask = tc.find_centroids(x, centroids, device="cpu")
    frame = jc.find_centroids(pd.DataFrame(x, columns=["a", "b"]), centroids, ["a", "b"])
    np.testing.assert_array_equal(mask, frame["centroid"].to_numpy())
    assert mask.sum() == 4
    assert not tc.find_centroids(x, np.zeros((0, 2)), device="cpu").any()
    with pytest.raises(ValueError, match="dimension"):
        tc.find_centroids(x, np.zeros((2, 3)), device="cpu")


@pytest.mark.parametrize("block_elements", [None, 1000])
def test_assign_nearest_neighbor_matches_jax(monkeypatch, block_elements):
    rng = np.random.default_rng(21)
    new = rng.normal(size=(700, 2)).astype(np.float32)
    ref = rng.normal(size=(300, 2)).astype(np.float32)
    if block_elements is not None:   # blocks of 3 query rows
        monkeypatch.setattr(tc, "TILE_ELEMENTS", block_elements)
    got = tc.assign_nearest_neighbor(new, ref, device="cpu")
    np.testing.assert_array_equal(got, jc.assign_nearest_neighbor(new, ref))
    np.testing.assert_array_equal(
        got, ((new[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1).argmin(1))
