"""The port's UMAP (deep_cartograph_torch/cv/umap_cv.py) against the JAX
package's, on the CPU.

The layout's draws differ between the packages (a torch generator against
jax.random), so the tests feed the port the JAX package's per-epoch draws
(`split(key, 3)`, uniform, randint) through the `draws` seam.

The layout is chaotic: a negative sample close to its head is pushed with a
coefficient near 2b/0.001, so a last-bit difference (the packages' float32
`pow` differ in the last bit for some inputs) grows epoch after epoch; one
ulp of input noise moves the port's fit by ~1e-4 after one epoch and ~3e-2
after ten (umap_float32_floor.py). One epoch from the same embedding is held
to 1e-5; a fit of 10 epochs or more is held to max(1e-5, 3 x the port's own
spread between inputs one float32 ulp apart), as the card run holds TICA."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_cartograph_torch.cv.umap_cv as tu
import deep_cartograph_tpu.cv.umap_cv as ju
from deep_cartograph_torch.cv import cv_calculators_map as torch_calculators
from deep_cartograph_torch.cv.base import CVCalculator as TorchCVCalculator
from deep_cartograph_torch.io.colvars import write_colvars
from deep_cartograph_tpu.cv import cv_calculators_map as jax_calculators
from deep_cartograph_tpu.cv.base import CVCalculator as JaxCVCalculator

torch.set_num_threads(2)

TOL = 1e-5
ULP_SPREAD_MULTIPLE = 3
LABELS = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_7", "dist-@CA_3-@CA_9",
          "dist-@CA_1-@CA_9", "dist-@CA_4-@CA_10", "dist-@CA_2-@CA_11"]


def jax_draws(seed: int, n: int, negative_samples: int = 5):
    """The JAX layout's draws, epoch after epoch: split(key, 3), then the
    acceptance uniforms and the negative samples (umap_cv.py:157-188)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(epoch, n_edges):
        key, k1, k2 = jax.random.split(state["key"], 3)
        state["key"] = key
        return (np.array(jax.random.uniform(k1, (n_edges,))),
                np.array(jax.random.randint(k2, (n_edges, negative_samples), 0, n)))

    return draws


def anisotropic(n: int, seed: int, d: int = 6) -> np.ndarray:
    """Gaussian rows with well separated principal variances, so that both
    packages' float32 eigh give the same PCA initialization."""
    scales = np.array([5.0, 3.0, 2.0, 1.0, 0.5, 0.2])[:d]
    return (np.random.default_rng(seed).normal(size=(n, d)) * scales).astype(np.float32)


def with_ulp_noise(x: np.ndarray, seed: int) -> np.ndarray:
    noise = np.random.default_rng(seed).standard_normal(x.shape)
    return (x * (1 + 6e-8 * noise)).astype(np.float32)


def align_signs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a's columns flipped to correlate positively with b's."""
    return a * np.sign(np.sum(a * b, axis=0))


def port_graph(x: np.ndarray, k: int = 15):
    xt = torch.as_tensor(x)
    dists, idx = tu._knn(xt, xt, k, exclude_self=True)
    w = tu._fuzzy_weights(dists, *tu._smooth_knn(dists))
    return tu._symmetrize(idx.numpy(), w.numpy(), x.shape[0])


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_dist,spread", [(0.1, 1.0), (0.5, 1.0), (0.1, 2.0), (0.25, 0.5)])
def test_fit_ab_matches_jax(min_dist, spread):
    assert tu._fit_ab(min_dist, spread) == ju._fit_ab(min_dist, spread)


@pytest.mark.parametrize("n,d,k,exclude_self,row_block,col_block,seed", [
    (300, 6, 15, True, None, None, 0),
    (300, 6, 15, True, 7, 13, 1),
    (257, 17, 15, True, 64, 50, 2),
    (200, 3, 5, False, 1, 1, 3),
    (129, 40, 15, False, 128, 16, 4),
])
def test_blocked_knn_matches_jax(n, d, k, exclude_self, row_block, col_block, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    queries = data if exclude_self else rng.normal(size=(n // 3, d)).astype(np.float32)
    want_d, want_i = ju._knn(jnp.asarray(data), jnp.asarray(queries), k, exclude_self)
    got_d, got_i = tu._knn(torch.as_tensor(data), torch.as_tensor(queries), k,
                           exclude_self, row_block, col_block)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=TOL, rtol=0)
    whole_d, whole_i = tu._knn(torch.as_tensor(data), torch.as_tensor(queries), k,
                               exclude_self)
    assert torch.equal(whole_i, got_i)
    if exclude_self:
        assert not (got_i.numpy() == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("row_block,col_block", [(None, None), (7, 13), (1, 1), (64, 50),
                                                 (3, 200)])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_knn_ties_go_to_the_lower_index(row_block, col_block, exclude_self):
    """Small integer coordinates: every d2 is exact, runs of equal distances
    (duplicated rows among them) are long, and the tiles cut through them.
    The order equals jax.lax.top_k's, lower index first."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 3, size=(200, 4)).astype(np.float32)
    data[50:80] = data[3]
    queries = data if exclude_self else data[::3]
    want_d, want_i = ju._knn(jnp.asarray(data), jnp.asarray(queries), 15, exclude_self)
    got_d, got_i = tu._knn(torch.as_tensor(data), torch.as_tensor(queries), 15,
                           exclude_self, row_block, col_block)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_smooth_knn_matches_jax():
    x = anisotropic(300, seed=5)
    want_d, _ = ju._knn(jnp.asarray(x), jnp.asarray(x), 15, True)
    want_rho, want_sigma = ju._smooth_knn(want_d)
    dists = torch.as_tensor(np.array(want_d))
    rho, sigma = tu._smooth_knn(dists)
    np.testing.assert_array_equal(rho.numpy(), np.asarray(want_rho))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=1e-5)
    # sigma solves the defining equation sum exp(-(d - rho)/sigma) = log2(k)
    total = torch.exp(-(dists - rho[:, None]).clamp_min(0) / sigma[:, None]).sum(1)
    np.testing.assert_allclose(total.numpy(), np.log2(15), rtol=1e-4)
    np.testing.assert_allclose(
        tu._fuzzy_weights(dists, rho, sigma).numpy(),
        np.asarray(ju._fuzzy_weights(want_d, want_rho, want_sigma)), atol=1e-6, rtol=0)


def test_symmetrized_edges_match_jax():
    """The edge list in the order of scipy's tocoo(), which fixes which
    draw goes with which edge (umap_cv.py:125-135)."""
    import scipy.sparse as sp

    x = anisotropic(300, seed=6)
    n = x.shape[0]
    idx, w = ju.UMAPModel(2)._graph(jnp.asarray(x))
    rows = np.repeat(np.arange(n), idx.shape[1])
    W = sp.coo_matrix((np.asarray(w).reshape(-1), (rows, np.asarray(idx).reshape(-1))),
                      shape=(n, n))
    Wt = W.T
    want = (W + Wt - W.multiply(Wt)).tocoo()
    heads, tails, weights = port_graph(x)
    np.testing.assert_array_equal(heads, want.row)
    np.testing.assert_array_equal(tails, want.col)
    # the packages' kNN distances differ in the d2 expansion's last bits and
    # their float32 exp in the last bit: weights within 1e-5
    np.testing.assert_allclose(weights, want.data, atol=TOL, rtol=0)
    assert weights.dtype == np.float32


# ---------------------------------------------------------------------------
# Layout and transform
# ---------------------------------------------------------------------------

def test_pca_init_matches_jax():
    """The JAX fit with no epoch returns its PCA initialization."""
    x = anisotropic(300, seed=7)
    want = ju.UMAPModel(2, n_epochs=0).fit(x).embedding_
    got = tu._pca_init(torch.as_tensor(x), 2).numpy()
    np.testing.assert_allclose(align_signs(got, want), want, atol=1e-4 * np.abs(want).max())


def test_one_layout_epoch_matches_jax():
    x = anisotropic(300, seed=8)
    init = ju.UMAPModel(2, n_epochs=0).fit(x).embedding_
    want = ju.UMAPModel(2, n_epochs=1).fit(x).embedding_
    model = tu.UMAPModel(2, n_epochs=1, device="cpu")
    got = model.layout(torch.as_tensor(np.array(init)), *port_graph(x),
                       jax_draws(model.seed, x.shape[0])).numpy()
    assert np.abs(got - init).max() > 100 * TOL  # the epoch moved the points
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_layout_epoch_is_the_layout_of_one_epoch():
    x = anisotropic(200, seed=9)
    heads, tails, weights = port_graph(x)
    init = tu._pca_init(torch.as_tensor(x), 2)
    model = tu.UMAPModel(2, n_epochs=1, device="cpu")
    draws = jax_draws(3, x.shape[0])
    want = model.layout(init, heads, tails, weights, draws)
    uniform, negatives = jax_draws(3, x.shape[0])(0, len(heads))
    got = tu.layout_epoch(init.clone(), torch.as_tensor(heads), torch.as_tensor(tails),
                          torch.as_tensor(weights), torch.as_tensor(uniform),
                          torch.as_tensor(negatives).long(), 1.0, model.a, model.b)
    assert torch.equal(got, want)


def test_ten_epoch_fit_matches_jax_within_its_ulp_spread():
    x = anisotropic(300, seed=10)
    n = x.shape[0]
    want = ju.UMAPModel(2, n_epochs=10).fit(x).embedding_
    got = tu.UMAPModel(2, n_epochs=10, device="cpu").fit(x, jax_draws(42, n)).embedding_
    noisy = tu.UMAPModel(2, n_epochs=10, device="cpu").fit(
        with_ulp_noise(x, 1), jax_draws(42, n)).embedding_
    spread = np.abs(align_signs(noisy, got) - got).max()
    err = np.abs(align_signs(got, want) - want).max()
    assert got.shape == (n, 2) and np.isfinite(got).all()
    assert err <= max(TOL, ULP_SPREAD_MULTIPLE * spread), (err, spread)


def test_seeded_fit_runs_on_the_generator():
    """Without given draws the layout draws from the seeded generator: two
    fits with one seed are equal, another seed differs."""
    x = anisotropic(200, seed=12)
    a = tu.UMAPModel(2, n_epochs=5, seed=1, device="cpu").fit(x)
    b = tu.UMAPModel(2, n_epochs=5, seed=1, device="cpu").fit(x).embedding_
    c = tu.UMAPModel(2, n_epochs=5, seed=2, device="cpu").fit(x).embedding_
    np.testing.assert_array_equal(a.embedding_, b)
    assert not np.array_equal(b, c)
    assert set(a.fit_seconds) == {"knn", "sigma", "symmetrize", "pca_init", "layout"}
    np.testing.assert_array_equal(a.training_data, x)


@pytest.mark.parametrize("n_queries,n_epochs", [(40, 50), (97, 7)])
def test_transform_matches_jax(n_queries, n_epochs):
    x = anisotropic(300, seed=13)
    jax_model = ju.UMAPModel(2, n_epochs=20).fit(x)
    model = tu.UMAPModel(2, device="cpu")
    model.training_data, model.embedding_ = x, jax_model.embedding_
    queries = anisotropic(n_queries, seed=14)
    got = model.transform(queries, n_epochs=n_epochs)
    want = jax_model.transform(queries, n_epochs=n_epochs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The calculator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cv_dataset(tmp_path_factory, ca_system):
    """A two-state colvars dataset tied to the CA topology (the JAX
    package's tests/test_cv.py fixture, made with its own seed)."""
    root = tmp_path_factory.mktemp("umap_cv_data")
    rng = np.random.default_rng(3)
    n = 400
    state = np.zeros(n)
    for i in range(1, n):
        state[i] = 1 - state[i - 1] if rng.random() < 0.01 else state[i - 1]
    slow = state + 0.05 * rng.standard_normal(n)
    data = np.zeros((n, len(LABELS)), np.float32)
    data[:, 0] = 0.5 + 0.3 * slow
    data[:, 1] = 0.7 - 0.2 * slow + 0.02 * rng.standard_normal(n)
    data[:, 2] = 0.6 + 0.05 * rng.standard_normal(n)
    data[:, 3] = 0.9 + 0.1 * slow + 0.05 * rng.standard_normal(n)
    data[:, 4] = 0.4 + 0.03 * rng.standard_normal(n)
    data[:, 5] = 0.8 + 0.15 * slow + 0.03 * rng.standard_normal(n)
    time_col = np.arange(n, dtype=np.float32)
    path = os.path.join(str(root), "colvars.dat")
    write_colvars(path, np.column_stack([time_col, data]), ["time"] + LABELS, fmt="%.6f")
    # frames that are not training frames: a training frame's nearest
    # neighbour is itself, at the d2 expansion's rounding (~3e-4 after the
    # square root), which the packages round apart
    held_out = os.path.join(str(root), "held_out.dat")
    write_colvars(held_out, np.column_stack([
        time_col, data + rng.normal(0, 0.01, data.shape).astype(np.float32)]),
        ["time"] + LABELS, fmt="%.6f")
    return {"colvars": path, "held_out": held_out, "topology": ca_system.pdb_path,
            "data": data}


CONFIG = {"dimension": 2, "features_normalization": "mean_std"}


def _jax_run(cv_dataset, out):
    calc = jax_calculators["umap"](configuration=dict(CONFIG), output_path=out)
    calc.load_training_data([cv_dataset["colvars"]], [cv_dataset["topology"]],
                            features_list=LABELS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return calc, calc.run()


def _torch_run(cv_dataset, out, data=None):
    calc = torch_calculators["umap"](dict(CONFIG), out, device="cpu")
    if data is None:
        calc.load_training_data([cv_dataset["colvars"]], [cv_dataset["topology"]],
                                features_list=LABELS)
    else:
        calc._set_training_data(data, None, LABELS)
        calc.ref_topology_path = cv_dataset["topology"]
    calc.layout_draws = jax_draws(calc.seed, 400)
    return calc, calc.run()


def test_umap_calculator_matches_jax(cv_dataset, tmp_path):
    jax_calc, jax_projection = _jax_run(cv_dataset, str(tmp_path / "jax"))
    calc, (projection, labels) = _torch_run(cv_dataset, str(tmp_path / "torch"))
    _, (noisy, _) = _torch_run(cv_dataset, str(tmp_path / "noisy"),
                               with_ulp_noise(calc.training_data.numpy(), 2))
    want = jax_projection.to_numpy()
    assert labels == list(jax_projection.columns) == ["UMAP 1", "UMAP 2"]
    assert projection.shape == (400, 2) and projection.dtype == np.float32
    np.testing.assert_allclose(np.abs(projection).max(0), 1.0, rtol=1e-6)
    # it fits on normalized features, as the JAX calculator does
    np.testing.assert_allclose(calc.cv.training_data, jax_calc.cv.training_data,
                               atol=TOL, rtol=0)
    spread = np.abs(align_signs(noisy, projection) - projection).max()
    err = np.abs(align_signs(projection, want) - want).max()
    assert err <= max(TOL, ULP_SPREAD_MULTIPLE * spread), (err, spread)
    # the training projection is the normalized embedding, not a transform
    np.testing.assert_allclose(
        projection, (calc.cv.embedding_ - calc.cv_norm_mean) / calc.cv_norm_range,
        atol=1e-6)
    model = tmp_path / "torch" / "umap" / "model.zip"
    assert model.exists()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_model_zip_projects_alike_in_both_packages(cv_dataset, tmp_path, writer):
    """A model.zip written by either package projects new frames in the
    other as in the package that wrote it."""
    if writer == "jax":
        _jax_run(cv_dataset, str(tmp_path / "w"))
    else:
        _torch_run(cv_dataset, str(tmp_path / "w"))
    model = str(tmp_path / "w" / "umap" / "model.zip")
    jax_loaded = JaxCVCalculator.load(model, str(tmp_path / "jl"))
    torch_loaded = TorchCVCalculator.load(model, str(tmp_path / "tl"), device="cpu")
    want = jax_loaded.project_colvars([cv_dataset["held_out"]],
                                      [cv_dataset["topology"]]).to_numpy()
    got, labels = torch_loaded.project_colvars([cv_dataset["held_out"]],
                                               [cv_dataset["topology"]])
    assert labels == ["UMAP 1", "UMAP 2"]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(torch_loaded.cv.training_data, jax_loaded.cv.training_data)
    assert (torch_loaded.cv.a, torch_loaded.cv.b) == (jax_loaded.cv.a, jax_loaded.cv.b)


def test_from_model_zip_refuses_umap_in_both_packages(cv_dataset, tmp_path):
    """Neither package serves UMAP from frames (JAX deploy.py:121-124)."""
    from deep_cartograph_torch.deploy import FramesToCV as TorchFramesToCV
    from deep_cartograph_tpu.deploy import FramesToCV as JaxFramesToCV

    _torch_run(cv_dataset, str(tmp_path / "w"))
    model = str(tmp_path / "w" / "umap" / "model.zip")
    with pytest.raises(TypeError, match="no fused device path for UMAP"):
        JaxFramesToCV.from_model_zip(model, cv_dataset["topology"], str(tmp_path / "j"))
    with pytest.raises(TypeError, match="no fused device path for UMAP"):
        TorchFramesToCV.from_model_zip(model, cv_dataset["topology"], str(tmp_path / "t"),
                                       device="cpu")


def test_every_default_family_constructs_on_the_cpu(tmp_path):
    from deep_cartograph_torch.config.schemas import cv_configuration, train_colvars_config
    from deep_cartograph_tpu.config.schemas import TrainColvarsSchema

    config = train_colvars_config()
    assert config["cvs"] == TrainColvarsSchema().cvs
    for name in config["cvs"]:
        calc = torch_calculators[name](cv_configuration(config, name), str(tmp_path),
                                       device="cpu")
        assert calc.device.type == "cpu"
    assert torch_calculators["umap"] is tu.UMAP


def test_umap_calculator_warns_instead_of_plumed_files(tmp_path, caplog):
    calc = torch_calculators["umap"]({"dimension": 2}, str(tmp_path), device="cpu")
    calc.write_plumed_files(None, str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert "not generated for UMAP" in caplog.text
