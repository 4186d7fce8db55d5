"""Port deep-TICA (cv/deep.py) against the JAX package's: the batch loss,
the calculator from the same initial parameters, and the training slice as
a whole (features -> statistics -> filter -> train -> FramesToCV -> FES),
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from deep_cartograph_tpu.cv.deep import (
    DeepTICACalculator as JaxDeepTICACalculator,
    deep_tica_batch_eigvals as jax_batch_eigvals,
)
from deep_cartograph_tpu.deploy import FramesToCV as JaxFramesToCV
from deep_cartograph_tpu.fes.kde import compute_fes as jax_compute_fes
from deep_cartograph_tpu.geom.engine import Featurizer as JaxFeaturizer
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.io.topology import Topology as JaxTopology
from deep_cartograph_tpu.models.networks import DeepTICANet as JaxDeepTICANet
from deep_cartograph_tpu.stats import descriptors as jax_stats
from deep_cartograph_torch.cv.deep import (
    DeepTICACalculator,
    deep_tica_batch_eigvals,
    make_deep_tica_loss,
)
from deep_cartograph_torch.deploy import FramesToCV
from deep_cartograph_torch.fes.kde import compute_fes
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models.networks import DeepTICAStack
from deep_cartograph_torch.models.weights import params_from_flax, params_to_flax
from deep_cartograph_torch.stats import descriptors as torch_stats
from tests.test_cv import base_config

torch.set_num_threads(2)

PROJECTION_TOL = 1e-4  # the repo's projection contract (tests/test_golden.py)
FES_TOL = 1e-3         # kJ/mol


def _config(**general):
    cfg = base_config()
    cfg["training"]["general"].update(
        {"num_tries": 3, "max_epochs": 12, "batch_size": 16, **general}
    )
    return cfg


# ---------------------------------------------------------------------------
# The batch loss
# ---------------------------------------------------------------------------

def test_batch_eigvals_and_gradient_match_jax():
    """Value and gradient of -sum(eigenvalues) with zero-weight padded rows,
    for two tries at once against the JAX loss per try."""
    rng = np.random.default_rng(0)
    layers, options = (7, 9, 2), {"activation": ["tanh", None]}
    x = rng.standard_normal((2, 50, 7)).astype(np.float32)
    x_lag = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    weight = np.ones((2, 50), np.float32)
    weight[:, 41:] = 0.0  # a ragged batch: rows past 41 are padding
    x[:, 41:] = 100.0     # which must not count, whatever they hold
    net = JaxDeepTICANet(layers=layers, options=options)
    keys = [jax.random.PRNGKey(s) for s in (3, 4)]
    jparams = [net.init({"params": k}, jnp.zeros((2, 7)))["params"] for k in keys]

    stacked = params_from_flax(
        jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]), *jparams)
    )
    for v in stacked.values():
        v.requires_grad_(True)
    batch = {"data": torch.from_numpy(x), "data_lag": torch.from_numpy(x_lag),
             "weight": torch.from_numpy(weight)}
    module = DeepTICAStack(layers, options)
    evals = deep_tica_batch_eigvals(module, stacked, batch, None, 1e-6)
    loss, aux = make_deep_tica_loss(module, 1e-6, 2)(stacked, batch, None, 0.0)
    torch.testing.assert_close(loss, -evals.sum(-1))
    torch.testing.assert_close(aux["eigval_2"], evals[:, 1])
    grads = torch.autograd.grad(loss.sum(), list(stacked.values()))
    grads = dict(zip(stacked, grads))

    for t in range(2):
        jbatch = {"data": jnp.asarray(x[t]), "data_lag": jnp.asarray(x_lag[t]),
                  "weight": jnp.asarray(weight[t])}
        want = np.asarray(jax_batch_eigvals(net, jparams[t], jbatch, keys[t], 1e-6))
        np.testing.assert_allclose(evals[t].detach().numpy(), want, atol=1e-5)
        jgrad = jax.grad(
            lambda p: -jnp.sum(jax_batch_eigvals(net, p, jbatch, keys[t], 1e-6))
        )(jparams[t])
        for key, value in params_from_flax(jax.tree.map(np.asarray, jgrad)).items():
            np.testing.assert_allclose(grads[key][t].numpy(), value.numpy(),
                                       atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# The calculator from the same initial parameters
# ---------------------------------------------------------------------------

def _colvars(path, features, names):
    t = np.arange(features.shape[0], dtype=np.float32)
    # %.9g round-trips float32: both packages see the same matrix
    write_colvars(path, np.column_stack([t, features]), ["time"] + list(names),
                  fmt="%.9g")
    return path


def _train_both(tmp_path, features, labels, names, config, monkeypatch,
                validation=None):
    """Train the JAX calculator (through its colvars reader) and the port's
    (through `_set_training_data` / `_set_validation_data`) from the JAX
    package's initial parameters. Returns both, trained and
    post-normalized."""
    path = _colvars(str(tmp_path / "colvars.dat"), features, names)
    jcalc = JaxDeepTICACalculator(configuration=config, output_path=str(tmp_path))
    jcalc.load_training_data([path], features_list=list(names))
    jcalc.create_output_folders()

    calc = DeepTICACalculator(configuration=config, device="cpu")
    calc._set_training_data(jcalc.training_data, labels, names)
    if validation is not None:
        vpath = _colvars(str(tmp_path / "valid.dat"), validation, names)
        jcalc.load_validation_data([vpath], features_list=list(names))
        calc._set_validation_data(jcalc.validation_data, jcalc.validation_data_labels)

    seeds = [calc.seed + t for t in range(1, calc.num_tries + 1)]
    jax_init = jax.tree.map(np.asarray, jcalc._init_params_stack(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    port_init = calc._init_params_stack

    def carried(seeds_):
        assert list(seeds_) == seeds
        port_init(seeds_)  # builds the module
        return params_from_flax(jax_init)

    monkeypatch.setattr(calc, "_init_params_stack", carried)
    assert jcalc.train() and calc.train()
    jcalc.normalize_cv()
    calc.normalize_cv()
    return jcalc, calc


def test_deep_tica_calculator_matches_jax(ca_system, tmp_path, monkeypatch):
    labels = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_11",
              "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_1-@CA_2-@CA_3-@CA_4"]
    features = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), labels)\
        .featurize_trajectory(ca_system.dcd_path)
    jcalc, calc = _train_both(tmp_path, features, np.zeros(len(features)), labels,
                              _config(), monkeypatch)

    np.testing.assert_allclose(calc.features_norm_mean, jcalc.features_norm_mean,
                               atol=1e-6)
    np.testing.assert_allclose(calc.features_norm_range, jcalc.features_norm_range,
                               atol=1e-6)
    np.testing.assert_allclose(calc.cv_score, jcalc.cv_score, rtol=1e-4)
    np.testing.assert_allclose(calc.metrics["valid_loss"], jcalc.metrics["valid_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(calc.eigenvalues_, jcalc.eigenvalues_, atol=1e-4)
    np.testing.assert_allclose(calc.tica_evecs, jcalc.tica_evecs, atol=1e-4)
    # post_mean carries the output layer's bias, which the loss leaves free
    # (tests/test_torch_training.py): compared through the projection only
    np.testing.assert_allclose(calc.post_range, jcalc.post_range, atol=1e-4)
    got = calc.project_data(features)
    want = jcalc.project_data(features)
    assert got.dtype == np.float32 and got.shape == (len(features), 2)
    np.testing.assert_allclose(got, want, atol=PROJECTION_TOL)
    # the JAX package's projection runs the port's trained weights unchanged
    out = JaxDeepTICANet(
        layers=tuple(calc.architecture["layers"]),
        options=calc.architecture["encoder_options"],
        norm_mean=jnp.asarray(calc.architecture["norm_mean"], jnp.float32),
        norm_range=jnp.asarray(calc.architecture["norm_range"], jnp.float32),
    ).apply({"params": params_to_flax(calc.params)}, jnp.asarray(features))
    jax_on_port = (np.asarray(out) @ calc.tica_evecs - calc.post_mean) / calc.post_range
    np.testing.assert_allclose(jax_on_port, got, atol=PROJECTION_TOL)


def test_deep_tica_calculator_with_validation_data_matches_jax(
        ca_system, tmp_path, monkeypatch):
    """Provided validation data: every try trains on all training pairs and
    is scored on the validation pairs."""
    labels = ["dist-@CA_2-@CA_7", "dist-@CA_4-@CA_12", "sin-@CA_3-@CA_4-@CA_5-@CA_6"]
    features = JaxFeaturizer(JaxTopology.from_pdb(ca_system.pdb_path), labels)\
        .featurize_trajectory(ca_system.dcd_path)
    jcalc, calc = _train_both(tmp_path, features[:40], np.zeros(40), labels,
                              _config(max_epochs=8), monkeypatch,
                              validation=features[40:])
    assert calc.val_x_t.shape == (19, 3)
    np.testing.assert_allclose(calc.metrics["valid_loss"], jcalc.metrics["valid_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(calc.project_data(features),
                               jcalc.project_data(features), atol=PROJECTION_TOL)


@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_smoke_trajectory_trains_alike_in_both_packages(jitter, tmp_path, monkeypatch):
    """chip_smoke.py's helix cut to 1,000 frames and 2 tries, all 1,171
    features filtered at the median std, its training config. Noiseless,
    the lag-10 motion is deterministic and training pushes the batch TICA
    eigenvalues past 1: both packages reject the same try for a score below
    -dimension, and both fit an output eigenvalue above 1. With the smoke
    run's 0.2 A jitter every try passes in both."""
    import copy

    import chip_smoke

    n_frames = 1000
    coords = chip_smoke.make_trajectory(n_frames, chip_smoke.N_ATOMS, jitter=jitter)
    labels = chip_smoke.make_labels(chip_smoke.N_ATOMS)
    pdb = str(tmp_path / "ca.pdb")
    chip_smoke.write_ca_pdb(pdb, coords[0])
    feat = Featurizer(Topology.from_pdb(pdb), labels, device="cpu")(coords)
    config = copy.deepcopy(chip_smoke.TRAIN_CONFIG)
    config["training"]["general"]["num_tries"] = 2
    std = torch_stats.standard_deviation(feat, device="cpu")
    keep = torch_stats.quantile_mask(std, 0.5)
    kept = [lab for lab, k in zip(labels, keep) if k]

    jax_tries = {}
    run_tries = JaxDeepTICACalculator._run_tries_ensemble

    def record(self, *args, **kwargs):
        jax_tries["results"] = run_tries(self, *args, **kwargs)
        return jax_tries["results"]

    monkeypatch.setattr(JaxDeepTICACalculator, "_run_tries_ensemble", record)
    jcalc, calc = _train_both(tmp_path, feat[:, keep], np.zeros(n_frames), kept,
                              config, monkeypatch)
    want = [r.score for _, r in jax_tries["results"]]
    got = [r.score for _, r in calc.try_results]
    assert [calc._validate_result(r) for _, r in calc.try_results] == [
        jcalc._validate_result(r) for _, r in jax_tries["results"]]
    np.testing.assert_allclose(calc.eigenvalues_, jcalc.eigenvalues_, atol=1e-5)
    if jitter:
        assert all(s >= -2.0 for s in got)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert (jcalc.eigenvalues_ <= 1.0).all()
    else:
        assert min(got) < -2.0 <= max(got)
        # past -dimension C0 nears singular, and float32 sums in other
        # orders part the two packages' scores by ~3e-4 relative
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert jcalc.eigenvalues_[0] > 1.0 and calc.eigenvalues_[0] > 1.0


def test_batched_tries_equal_serial_tries(ca_system):
    labels = ["dist-@CA_1-@CA_6", "dist-@CA_4-@CA_10", "cos-@CA_2-@CA_3-@CA_4-@CA_5"]
    features = Featurizer(Topology.from_pdb(ca_system.pdb_path), labels,
                          device="cpu").featurize_trajectory(ca_system.dcd_path)
    calc = DeepTICACalculator(configuration=_config(max_epochs=5), device="cpu")
    calc._set_training_data(features, None, labels)
    assert calc.train()
    from deep_cartograph_torch.models.training import Trainer

    trainer = Trainer(calc.loss_fn, calc._trainer_config(3), device="cpu")
    serial = calc._run_tries_serial(trainer, calc.train_datasets(), None)
    for (n_s, s), (n_e, e) in zip(serial, calc.try_results):
        assert n_s == n_e and s.best_epoch == e.best_epoch
        np.testing.assert_allclose(s.metrics["valid_loss"], e.metrics["valid_loss"],
                                   rtol=1e-5)


def test_lag_pairs_stay_inside_each_trajectory():
    calc = DeepTICACalculator(configuration=_config(), device="cpu")
    calc.configuration["lag_time"] = 2
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    calc._set_training_data(x, np.array([0] * 5 + [1] * 7), ["a", "b"])
    assert calc.x_t.shape == (3 + 5, 2)
    np.testing.assert_array_equal((calc.x_lag - calc.x_t).numpy(), 4.0)


def test_batchnorm_and_colvars_are_not_ported_yet(ca_system, tmp_path):
    """The colvars reader: the calculator reads the file it is given (time
    column dropped). Batchnorm now trains and is folded into the dense
    layers of the deployed net (tests/test_torch_autoencoders.py holds the
    fold to the JAX package's)."""
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    path = _colvars(str(tmp_path / "colvars.dat"), x, ["a", "b", "c"])
    calc = DeepTICACalculator(configuration=_config(), device="cpu")
    calc.load_training_data([path])
    assert calc.features_ref_labels == ["a", "b", "c"]
    np.testing.assert_array_equal(calc.training_data.numpy(), x)
    assert calc.x_t.shape == (39, 3)
    cfg = _config()
    cfg["architecture"]["encoder"]["batchnorm"] = [True]
    calc = DeepTICACalculator(configuration=cfg, device="cpu")
    calc._set_training_data(np.random.default_rng(0).normal(size=(40, 3)), None,
                            ["a", "b", "c"])
    assert calc.train()
    assert calc.architecture["encoder_options"]["batchnorm"] == [False, False]
    assert not any("bn_" in key for key in calc.params)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _all_labels(n_atoms):
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, n_atoms + 1)
              for j in range(i + 2, n_atoms + 1)]
    for i in range(1, n_atoms - 2):
        ents = "-".join(f"@CA_{k}" for k in range(i, i + 4))
        labels += [f"sin-{ents}", f"cos-{ents}"]
    return labels


def test_training_slice_matches_jax(ca_system, tmp_path, monkeypatch):
    """features -> entropy/std -> std quantile filter -> deep-TICA training
    -> FramesToCV -> FES, the port against the JAX package."""
    labels = _all_labels(ca_system.n_residues)
    jtop = JaxTopology.from_pdb(ca_system.pdb_path)
    top = Topology.from_pdb(ca_system.pdb_path)
    jfeat = JaxFeaturizer(jtop, labels).featurize_trajectory(ca_system.dcd_path)
    feat = Featurizer(top, labels, device="cpu").featurize_trajectory(ca_system.dcd_path)
    np.testing.assert_allclose(feat, jfeat, atol=1e-5)

    jstd = jax_stats.standard_deviation(jfeat)
    std = torch_stats.standard_deviation(feat, device="cpu")
    jent = jax_stats.shannon_entropy(jfeat)
    ent = torch_stats.shannon_entropy(feat, device="cpu")
    np.testing.assert_allclose(std, jstd, atol=1.0001e-3)
    np.testing.assert_allclose(ent, jent, atol=1.0001e-3)
    jkeep = (pd.Series(jstd) >= pd.Series(jstd).quantile(q=0.5)).to_numpy()
    keep = torch_stats.quantile_mask(std, 0.5)
    np.testing.assert_array_equal(keep, jkeep)
    kept = [lab for lab, k in zip(labels, keep) if k]

    jcalc, calc = _train_both(tmp_path, jfeat[:, keep], np.zeros(len(jfeat)), kept,
                              _config(), monkeypatch)
    want = JaxFramesToCV(jcalc, jtop)(ca_system.coords)
    pipeline = FramesToCV(calc.projection(), top, kept, device="cpu")
    got = pipeline(ca_system.coords)
    assert got.shape == want.shape == (len(jfeat), 2)
    np.testing.assert_allclose(got, want, atol=PROJECTION_TOL)
    np.testing.assert_allclose(got, calc.project_data(feat[:, keep]), atol=1e-5)

    # The FES stage on one input: the port's within FES_TOL everywhere.
    axes_w, fes_w, _ = jax_compute_fes(want, bandwidth=0.05, num_bins=40)
    axes, fes, _ = compute_fes(want, bandwidth=0.05, num_bins=40, device="cpu")
    for a, b in zip(axes, axes_w):
        np.testing.assert_array_equal(a, b)
    assert fes.shape == fes_w.shape == (40, 40)
    np.testing.assert_allclose(fes, fes_w, atol=FES_TOL)
    # Each package on its own projection: within FES_TOL in the basins
    # (below 10 kJ/mol, 4 kT). Far from the samples the FES grows as
    # d^2 / (2 h^2) kT, whose slope turns the projections' ~1e-5 differences
    # into up to ~1e-5 of the value: held to a relative 1e-4 there.
    _, fes_own, _ = compute_fes(got, bandwidth=0.05, num_bins=40, device="cpu")
    basin = fes_w < 10.0
    assert basin.sum() > 20
    np.testing.assert_allclose(fes_own[basin], fes_w[basin], atol=FES_TOL)
    np.testing.assert_allclose(fes_own, fes_w, rtol=1e-4, atol=FES_TOL)
