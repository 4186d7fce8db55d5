"""The port's UMAP (deep_cartograph_torch/cv/umap_cv.py) against the
benchmark's plain float64 reference (`carto_bench/reference_umap.py`), on
the CPU at a small size: the kNN within the float32 bound of the d2
expansion, rho and sigma, the fuzzy union's edges and weights, the PCA
start up to sign, the first 3 epochs and a last epoch from the port's own
embedding with the same draws (the `draws` seam), the calculator's
normalized CV, and the port's counter and spans."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import deep_cartograph_torch.cv.umap_cv as tu
from carto_bench import reference_umap as ru
from deep_cartograph_torch.cv import cv_calculators_map
from deep_cartograph_torch.cv.umap_cv import UMAPModel, UMAPStats
from tests.test_torch_spans import inside, of, traced_spans

N, D, K, EPOCHS = 2000, 64, 15, 20
SEED = 2**31 + 77

# The float32 start: its covariance over 2,000 rows and an eigh, each
# component scaled to a standard deviation of 10; the leading relative
# eigengaps are about 0.6, and float32 moves the start by 2e-5 at most
# (3 seeds); 1e-4 leaves five times that.
PCA_TOL = 1e-4
# One epoch from the same float32 embedding: the attraction and repulsion
# in float32 against float64; a negative sample near its head multiplies
# the rounding of its difference by up to 2b / 0.001 (~1,800), so an epoch
# errs by up to 5.5e-4 (3 seeds, epochs 1-3 and 20) on embeddings of size
# ~30; 5e-3 leaves nine times that.
EPOCH_TOL = 5e-3
# rho and sigma from the same float32 distances: 64 bisections in float32
# stop at its resolution, and the float32 exp rounds: 1.4e-7 at most (3
# seeds); weights within 1e-6.
WEIGHT_TOL = 1e-6


def data(n: int = N, d: int = D, seed: int = 0) -> np.ndarray:
    """Gaussian rows with well separated principal variances, so that the
    float32 and float64 PCA starts agree component by component."""
    scales = np.concatenate([[8.0, 5.0, 3.0], np.geomspace(2.0, 0.5, d - 3)])
    return (np.random.default_rng(seed).normal(size=(n, d)) * scales).astype(np.float32)


def seeded_draws(seed: int, n: int, negative_samples: int = 5):
    """Each epoch's draws from a CPU generator of the seed, recorded."""
    gen = torch.Generator().manual_seed(seed)
    drawn = []

    def draws(epoch, n_edges):
        drawn.append((torch.rand(n_edges, generator=gen),
                      torch.randint(0, n, (n_edges, negative_samples), generator=gen)))
        return drawn[-1]

    return draws, drawn


def test_the_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse(Path(ru.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "scipy", "carto_bench"}
    assert not names & {"jax", "jaxlib", "flax", "deep_cartograph_torch",
                        "deep_cartograph_tpu", "deep_cartograph"}


def test_fit_ab_is_the_port_s():
    assert ru.fit_ab(0.1) == pytest.approx(tu._fit_ab(0.1), rel=1e-9)


@pytest.mark.parametrize("row_block, col_block", [(None, None), (300, 700)])
def test_knn_within_the_float32_bound_of_the_exact_one(row_block, col_block):
    x = data()
    dists, idx = tu._knn(torch.as_tensor(x), torch.as_tensor(x), K, True, row_block, col_block)
    x64 = torch.as_tensor(x).double()
    d2 = ru.squared_distances(x64, x64)
    d2.fill_diagonal_(math.inf)
    exact = torch.topk(d2, K, dim=1, largest=False).values
    mine = torch.gather(d2, 1, idx)
    sq = (x64 * x64).sum(1)
    bound = 2 * (2 * D + 5) * ru.FLOAT32_UNIT_ROUNDOFF * (sq + sq.max())
    assert float(((mine - exact) / bound[:, None]).max()) <= 1.0
    assert not (idx == torch.arange(N)[:, None]).any()
    # distances of the reported pairs: float32's d2 expansion errs by about
    # u |x|^2 sqrt(d), 2.7e-5 at most (3 seeds) of distances about 20
    assert float((dists.double() - mine.clamp_min(0).sqrt()).abs().max()) <= 2e-4
    ref_d, ref_i = ru.knn(x64, K)
    assert float((ref_d - exact.sqrt()).abs().max()) == 0.0
    assert (ref_i == idx).float().mean() > 0.99


def test_rho_sigma_and_the_union_from_the_port_s_knn():
    x = data()
    xt = torch.as_tensor(x)
    dists, idx = tu._knn(xt, xt, K, True)
    rho, sigma = tu._smooth_knn(dists)
    rho64, sigma64 = ru.smooth_knn(dists.double(), K)
    assert torch.equal(rho.double(), rho64)
    w = tu._fuzzy_weights(dists, rho, sigma)
    w64 = ru.membership(dists.double(), rho64, sigma64)
    assert float((w.double() - w64).abs().max()) <= WEIGHT_TOL
    heads, tails, weights = tu._symmetrize(idx.numpy(), w.numpy(), N)
    ref = ru.fuzzy_union(idx, w64, N)
    order = np.lexsort((tails, heads))
    np.testing.assert_array_equal(heads[order], ref["heads"].numpy())
    np.testing.assert_array_equal(tails[order], ref["tails"].numpy())
    assert np.abs(weights[order] - ref["weights"].numpy()).max() <= WEIGHT_TOL
    # every pair once, both directions present: a symmetric graph
    key = set(zip(heads.tolist(), tails.tolist()))
    assert len(key) == len(heads) and all((t, h) in key for h, t in key)
    w_only = ru.fuzzy_union(idx, w64, N, union=False)
    assert len(w_only["heads"]) == N * K < len(heads)


def test_the_pca_start_up_to_sign():
    x = data()
    got = tu._pca_init(torch.as_tensor(x), 2).double()
    ref, evals = ru.pca_init(torch.as_tensor(x).double(), 2)
    assert float(((evals[:2] - evals[1:3]) / evals[:2]).min()) > 0.05
    got = got * torch.sign((got * ref).sum(0))
    assert float((got - ref).abs().max()) <= PCA_TOL
    assert torch.allclose(ref.std(0, unbiased=False), torch.full((2,), 10.0, dtype=ref.dtype))


def observed_layout(monkeypatch):
    """`layout_epoch` recording each epoch's input, draws and output."""
    epochs = []
    real = tu.layout_epoch

    def kept(emb, heads, tails, weights, uniform, negatives, alpha, a, b):
        before = emb.clone()
        out = real(emb, heads, tails, weights, uniform, negatives, alpha, a, b)
        epochs.append({"input": before, "uniform": uniform, "negatives": negatives,
                       "alpha": alpha, "output": out.clone(),
                       "graph": {"heads": heads, "tails": tails, "weights": weights.double()}})
        return out

    monkeypatch.setattr(tu, "layout_epoch", kept)
    return epochs


def test_the_first_epochs_and_the_last_from_the_port_s_own_embedding(monkeypatch):
    x = data(n=1500)
    epochs = observed_layout(monkeypatch)
    draws, drawn = seeded_draws(SEED, len(x))
    model = UMAPModel(2, n_epochs=EPOCHS, device="cpu").fit(x, draws)
    assert len(epochs) == len(drawn) == EPOCHS
    a, b = ru.fit_ab(0.1)
    start = tu._pca_init(torch.as_tensor(model.training_data), 2)
    assert torch.equal(epochs[0]["input"], start)
    for e in (0, 1, 2, EPOCHS - 1):
        ep = epochs[e]
        assert ep["alpha"] == pytest.approx(ru.learning_rate(e, EPOCHS), rel=1e-6)
        assert torch.equal(ep["uniform"], drawn[e][0])
        ref = ru.layout_epoch(ep["input"].double(), ep["graph"], ep["uniform"], ep["negatives"],
                              ru.learning_rate(e, EPOCHS), a, b)
        moved = float((ref - ep["input"].double()).abs().max())
        assert float((ep["output"].double() - ref).abs().max()) <= EPOCH_TOL, e
        assert moved > 100 * EPOCH_TOL * ru.learning_rate(e, EPOCHS), e
    np.testing.assert_array_equal(model.embedding_, epochs[-1]["output"].numpy())
    # without its repulsion an epoch lands far from the port's
    ep = epochs[0]
    bare = ru.layout_epoch(ep["input"].double(), ep["graph"], ep["uniform"], ep["negatives"],
                           1.0, a, b, repulsion=False)
    assert float((ep["output"].double() - bare).abs().max()) > 100 * EPOCH_TOL


def test_the_calculator_s_normalized_cv(tmp_path):
    x = data(n=1200, d=16)
    calc = cv_calculators_map["umap"]({"dimension": 2, "features_normalization": "mean_std"},
                                      str(tmp_path), device="cpu")
    calc._set_training_data(x, np.zeros(len(x), np.int64), [f"f{i}" for i in range(16)])
    calc.compute_cv()
    calc.normalize_cv()
    projected = (calc.cv.embedding_ - calc.cv_norm_mean) / calc.cv_norm_range
    ref = ru.normalized_cv(torch.as_tensor(calc.cv.embedding_).double()).numpy()
    # float32 midpoint and half-range against float64: a few ulps of 1
    assert np.abs(projected - ref).max() <= 1e-6
    assert np.abs(ref).max() == pytest.approx(1.0)
    # the features the fit saw: normalized in float64, rounded to float32
    xn = ru.normalize(torch.as_tensor(x), "mean_std")
    assert float((torch.as_tensor(calc.cv.training_data).double() - xn).abs().max()) <= 1e-5


def test_the_counter_counts_each_part_once(monkeypatch):
    stats = UMAPStats(fits=3, epochs=7)
    monkeypatch.setattr(tu, "UMAP_STATS", stats)
    stats.reset()
    assert stats == UMAPStats()
    x = data(n=900, d=8)
    model = UMAPModel(2, n_epochs=EPOCHS, device="cpu").fit(x)
    assert (stats.fits, stats.knn_tiles, stats.knn_candidates) == (1, 1, 900 * 900)
    assert (stats.edges, stats.epochs, stats.nonfinite_rows) == (len(model.graph_[0]), EPOCHS, 0)
    xt = torch.as_tensor(x)
    tu._knn(xt, xt[:100], 5, False, row_block=30, col_block=400)
    assert (stats.knn_tiles, stats.knn_candidates) == (1 + 4 * 3, 900 * 900 + 100 * 900)
    model.transform(x[:50], n_epochs=3)
    assert (stats.fits, stats.epochs, stats.knn_candidates) == (1, EPOCHS, 900 * 1000 + 50 * 900)


def test_the_counter_counts_under_its_lock():
    import threading

    stats = UMAPStats()
    threads = [threading.Thread(target=lambda: [stats.add(epochs=2, fits=1)
                                                for _ in range(2000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert (stats.epochs, stats.fits) == (32000, 16000)


def test_the_spans_of_a_fit_and_a_transform(tmp_path):
    x = data(n=600, d=8)
    model = UMAPModel(2, n_epochs=3, device="cpu")
    _, spans = traced_spans(lambda: model.fit(x).transform(x[:20], n_epochs=2), tmp_path)
    parts = ["umap.knn", "umap.sigma", "umap.symmetrize", "umap.pca_init", "umap.layout"]
    (fit,) = of(spans, "umap.fit")
    within = [s["name"] for s in sorted(spans, key=lambda s: s["a"])
              if s is not fit and inside(s, fit) and s["name"].startswith("umap.")]
    assert within == parts
    (transform,) = of(spans, "umap.transform")
    assert not inside(transform, fit)
    assert set(model.fit_seconds) == {p.split(".")[1] for p in parts}
