"""Port AE and VAE (models/networks.py, cv/deep.py) against the JAX
package's, on the CPU: batchnorm folding, the AE reconstruction loss and
the VAE ELBO (value and gradient, two stacked tries, padded rows), the
calculators from the same initial parameters (the VAE with the same or
zeroed noise), the golden AE projection, the decoder's coupling to the
feature normalization, and deep-TICA with batchnorm folded."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_tpu.cv.deep import (
    AECalculator as JaxAECalculator,
    DeepTICACalculator as JaxDeepTICACalculator,
    VAECalculator as JaxVAECalculator,
)
from deep_cartograph_tpu.io.colvars import write_colvars
from deep_cartograph_tpu.models.networks import (
    AutoEncoderCV,
    FeedForward,
    VAECV,
    fold_feedforward_batchnorm as jax_fold,
)
from deep_cartograph_torch.cv.deep import (
    AECalculator,
    DeepTICACalculator,
    VAECalculator,
)
from deep_cartograph_torch.models import networks
from deep_cartograph_torch.models.networks import (
    AutoEncoderStack,
    VAEStack,
    feedforward_stack,
    fold_feedforward_batchnorm,
)
from deep_cartograph_torch.models.training import Trainer
from deep_cartograph_torch.models.weights import params_from_flax, params_to_flax
from tests.test_cv import base_config
from tests.test_golden import GOLDEN_DIR, _feature_labels, _fixture_system

torch.set_num_threads(2)

PROJECTION_TOL = 1e-4  # the repo's projection contract (tests/test_golden.py)
FOLD_TOL = 1e-6
LOSS_TOL = 1e-5

JAX_CALCULATORS = {"ae": JaxAECalculator, "vae": JaxVAECalculator,
                   "deep_tica": JaxDeepTICACalculator}
PORT_CALCULATORS = {"ae": AECalculator, "vae": VAECalculator,
                    "deep_tica": DeepTICACalculator}


def _stack_trees(trees):
    """Flax trees of T tries -> one tree with a leading tries axis."""
    return jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]), *trees)


# ---------------------------------------------------------------------------
# Batchnorm folding
# ---------------------------------------------------------------------------

def _bn_tree(rng, layers, batchnorm):
    tree = {}
    for i in range(len(layers) - 1):
        tree[f"dense_{i}"] = {
            "kernel": rng.normal(0, 0.4, (layers[i], layers[i + 1])).astype(np.float32),
            "bias": rng.normal(0, 0.2, layers[i + 1]).astype(np.float32),
        }
        if batchnorm[i]:
            tree[f"bn_scale_{i}"] = rng.uniform(0.5, 1.5, layers[i + 1]).astype(np.float32)
            tree[f"bn_bias_{i}"] = rng.normal(0, 0.3, layers[i + 1]).astype(np.float32)
    return tree


@pytest.mark.parametrize("tries", [None, 3])
def test_fold_feedforward_batchnorm_matches_jax(tries):
    """Folded dense layers (1e-6) and outputs, one try or three stacked,
    against the JAX fold of each try; and the folded plain MLP equals the
    batchnorm net normalized with the statistics of the whole input. The
    outputs (up to ~6 after three layers) are held to 1e-6 relative: a few
    float32 ulps of their size."""
    rng = np.random.default_rng(1)
    layers, act, bn = (6, 9, 7, 3), ["tanh", "leaky_relu", None], [True, False, True]
    x = rng.normal(1.0, 0.7, (64, 6)).astype(np.float32)
    trees = [_bn_tree(rng, layers, bn) for _ in range(tries or 1)]
    params = params_from_flax(_stack_trees(trees) if tries else trees[0])
    folded, out = fold_feedforward_batchnorm(params, layers, act, bn, torch.from_numpy(x))
    assert set(folded) == {f"dense_{i}/{leaf}" for i in range(3) for leaf in ("kernel", "bias")}
    for t, tree in enumerate(trees):
        want, want_out = jax_fold(tree, layers, act, bn, jnp.asarray(x))
        got = {k: (v[t] if tries else v) for k, v in folded.items()}
        for key, value in params_from_flax(want).items():
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=FOLD_TOL,
                                       err_msg=key)
        np.testing.assert_allclose((out[t] if tries else out).numpy(), np.asarray(want_out),
                                   rtol=FOLD_TOL, atol=FOLD_TOL)
    # the batchnorm net on the whole input as one batch
    stacked = params if tries else {k: v[None] for k, v in params.items()}
    bn_out = feedforward_stack(stacked, torch.from_numpy(x).expand(len(trees), -1, -1),
                               act, [None] * 3, bn)
    np.testing.assert_allclose(bn_out.numpy(), (out if tries else out[None]).numpy(),
                               rtol=FOLD_TOL, atol=FOLD_TOL)


# ---------------------------------------------------------------------------
# The losses
# ---------------------------------------------------------------------------

def _batch(rng, n_tries=2, n=50, d=7, n_real=41):
    """(T, n, d) data whose rows past n_real are padding (weight 0, and
    values far off that must not count)."""
    x = rng.normal(0.5, 1.0, (n_tries, n, d)).astype(np.float32)
    weight = np.ones((n_tries, n), np.float32)
    weight[:, n_real:] = 0.0
    x[:, n_real:] = 100.0
    return x, weight


def _port_loss(calc, module, params, x, weight, beta=0.0):
    calc.module = module
    batch = {"data": torch.from_numpy(x), "weight": torch.from_numpy(weight)}
    gens = [torch.Generator().manual_seed(s) for s in range(len(x))]
    loss, aux = calc.loss_fn(params, batch, gens, beta)
    grads = dict(zip(params, torch.autograd.grad(loss.sum(), list(params.values()))))
    return loss, aux, grads


def _jax_loss_and_grads(jcalc, jparams, x, weight, key, beta=0.0):
    batch = {"data": jnp.asarray(x), "weight": jnp.asarray(weight)}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jcalc.loss_fn(p, batch, key, beta), has_aux=True)(jparams)
    return float(loss), aux, params_from_flax(jax.tree.map(np.asarray, grads))


def _assert_grads(grads, t, want):
    for key, value in want.items():
        np.testing.assert_allclose(grads[key][t].numpy(), value.numpy(), atol=LOSS_TOL,
                                   err_msg=key)


def test_ae_reconstruction_loss_and_gradient_match_jax():
    """Two stacked tries against the JAX calculator's loss per try, with a
    ragged batch (padded rows weighted 0) and norm_in."""
    rng = np.random.default_rng(0)
    x, weight = _batch(rng)
    mean, scale = rng.normal(size=7).astype(np.float32), rng.uniform(0.5, 2, 7).astype(np.float32)
    enc, dec = (7, 9, 2), (2, 9, 7)
    eo = {"activation": ["tanh", None], "dropout": [None, None], "batchnorm": [False, False]}
    do = {"activation": ["leaky_relu", None], "dropout": [None, None],
          "batchnorm": [False, False]}
    net = AutoEncoderCV(enc, dec, eo, do, jnp.asarray(mean), jnp.asarray(scale))
    keys = [jax.random.PRNGKey(s) for s in (3, 4)]
    jparams = [net.init({"params": k}, jnp.zeros((2, 7)), method=AutoEncoderCV.reconstruct)
               ["params"] for k in keys]
    params = params_from_flax(_stack_trees(jparams))
    assert {k.split("/")[0] for k in params} == {"encoder", "decoder"}
    for v in params.values():
        v.requires_grad_(True)
    calc = AECalculator({"dimension": 2}, device="cpu")
    loss, aux, grads = _port_loss(calc, AutoEncoderStack(enc, dec, eo, do, mean, scale),
                                  params, x, weight)
    assert aux == {} and loss.shape == (2,)
    jcalc = JaxAECalculator({"dimension": 2})
    jcalc.module = net
    for t in range(2):
        want, _, want_grads = _jax_loss_and_grads(jcalc, jparams[t], x[t], weight[t], keys[t])
        np.testing.assert_allclose(float(loss[t]), want, rtol=LOSS_TOL)
        _assert_grads(grads, t, want_grads)


def _vae_setup(rng, eo=None):
    n_cvs, enc, dec = 2, (7, 9), (9, 7)
    eo = eo or {"activation": ["tanh"], "dropout": [None], "batchnorm": [False]}
    do = {"activation": ["tanh", None], "dropout": [None, None], "batchnorm": [False, False]}
    net = VAECV(n_cvs, enc, dec, eo, do)
    keys = [jax.random.PRNGKey(s) for s in (5, 6)]
    jparams = [net.init({"params": k, "dropout": k}, jnp.zeros((2, 7)), k, train=False,
                        method=VAECV.elbo_parts)["params"] for k in keys]
    return net, keys, jparams, VAEStack(n_cvs, enc, dec, eo, do)


def test_vae_elbo_parts_and_gradient_match_jax(monkeypatch):
    """The per-sample (reconstruction, KL) and the ELBO loss at a beta,
    value and gradient, with the JAX loss's own noise handed to the port."""
    rng = np.random.default_rng(2)
    x, weight = _batch(rng)
    net, keys, jparams, stack = _vae_setup(rng)
    params = params_from_flax(_stack_trees(jparams))
    assert {k.split("/")[0] for k in params} == {"encoder", "mean_nn", "log_var_nn", "decoder"}
    for v in params.values():
        v.requires_grad_(True)
    # the eps the JAX loss draws: normal(split(key)[1]) at the latent's shape
    eps = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[1], (50, 2)))
                    for k in keys])
    monkeypatch.setattr(networks, "reparam_noise",
                        lambda shape, gens: torch.from_numpy(eps).reshape(shape))
    beta = 0.37
    calc = VAECalculator({"dimension": 2}, device="cpu")
    loss, aux, grads = _port_loss(calc, stack, params, x, weight, beta)
    recon, kl = stack.elbo_parts(params, torch.from_numpy(x), None)
    jcalc = JaxVAECalculator({"dimension": 2})
    jcalc.module = net
    for t in range(2):
        want_recon, want_kl = net.apply({"params": jparams[t]}, jnp.asarray(x[t]),
                                        jax.random.split(keys[t])[1],
                                        method=VAECV.elbo_parts)
        np.testing.assert_allclose(recon[t].detach().numpy(), np.asarray(want_recon),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(kl[t].detach().numpy(), np.asarray(want_kl),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        want, want_aux, want_grads = _jax_loss_and_grads(jcalc, jparams[t], x[t],
                                                         weight[t], keys[t], beta)
        np.testing.assert_allclose(float(loss[t]), want, rtol=LOSS_TOL)
        for name in ("reconstruction_loss", "kl_loss"):
            np.testing.assert_allclose(float(aux[name][t]), float(want_aux[name]),
                                       rtol=LOSS_TOL)
        _assert_grads(grads, t, want_grads)


def test_reparam_noise_draws_each_try_from_its_generator():
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    eps = networks.reparam_noise((2, 5, 3), gens)
    assert eps.shape == (2, 5, 3)
    for t, s in enumerate((1, 2)):
        want = torch.randn((5, 3), generator=torch.Generator().manual_seed(s))
        torch.testing.assert_close(eps[t], want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The calculators from the same initial parameters
# ---------------------------------------------------------------------------

def _colvars(path, features, names, fmt="%.9g"):
    t = np.arange(features.shape[0], dtype=np.float32)
    write_colvars(path, np.column_stack([t, features]), ["time"] + list(names), fmt=fmt)
    return path


def _train_both(cv, tmp_path, features, names, config, monkeypatch, fmt="%.9g",
                topology=None):
    """Train the JAX calculator (through its colvars reader) and the port's
    (through `_set_training_data`) from the JAX package's initial
    parameters. Returns both, trained and post-normalized."""
    path = _colvars(str(tmp_path / "colvars.dat"), features, names, fmt)
    jcalc = JAX_CALCULATORS[cv](configuration=config, output_path=str(tmp_path / "jax"))
    jcalc.load_training_data([path], None if topology is None else [topology],
                             features_list=list(names))
    jcalc.create_output_folders()
    calc = PORT_CALCULATORS[cv](configuration=config, device="cpu")
    calc._set_training_data(jcalc.training_data, jcalc.training_data_labels, names)

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


def _autoencoder_config(**general):
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 3, "max_epochs": 12, "batch_size": 16,
                                       **general})
    return cfg


def _assert_architectures_match(got, want, free=()):
    """The same JSON; the arrays computed from data (feature normalization,
    post-normalization, TICA layer) within float32 reach of each other.
    Keys in `free` hold what the loss leaves free: checked through the
    projection only."""
    want = json.loads(json.dumps(want))
    assert set(got) == set(want)
    for key, value in want.items():
        if key in free:
            continue
        if key.startswith(("norm_", "post_")) or key == "tica_evecs":
            np.testing.assert_allclose(got[key], value, atol=1e-4, rtol=1e-5, err_msg=key)
        else:
            assert got[key] == value, key


def _assert_calculators_match(jcalc, calc, features, free=()):
    np.testing.assert_allclose(calc.cv_score, jcalc.cv_score, rtol=1e-4)
    for key in jcalc.metrics:
        if key.startswith("valid_") or key in ("train_loss", "beta", "epoch"):
            np.testing.assert_allclose(calc.metrics[key], jcalc.metrics[key], rtol=1e-4,
                                       err_msg=key)
    _assert_architectures_match(calc.architecture, jcalc.architecture, free)
    got = calc.project_data(features)
    assert got.dtype == np.float32 and got.shape == (len(features), 2)
    np.testing.assert_allclose(got, jcalc.project_data(features), atol=PROJECTION_TOL)
    return got


@pytest.fixture(scope="module")
def golden_features():
    return np.load(f"{GOLDEN_DIR}/features.npy")


def test_ae_calculator_matches_jax(golden_features, tmp_path, monkeypatch):
    jcalc, calc = _train_both("ae", tmp_path, golden_features, _feature_labels(),
                              _autoencoder_config(), monkeypatch)
    _assert_calculators_match(jcalc, calc, golden_features)
    assert [r.description for _, r in calc.try_results] == ["best overall"] * 3


def test_vae_calculator_with_zero_noise_matches_jax(golden_features, tmp_path, monkeypatch):
    """eps = 0 in both packages (a test-time patch of each one's noise
    source): the ELBO is deterministic, so the two runs match step by step,
    KL annealing and the post-annealing checkpoint included."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(networks, "reparam_noise",
                        lambda shape, gens: torch.zeros(tuple(shape)))
    jcalc, calc = _train_both("vae", tmp_path, golden_features, _feature_labels(),
                              _autoencoder_config(), monkeypatch)
    _assert_calculators_match(jcalc, calc, golden_features)
    assert calc.metrics["beta"][0] == 1e-6 and calc.metrics["beta"][-1] > 9e-3
    assert all(r.description == "best post-annealing" for _, r in calc.try_results)
    assert calc.cv_score == min(r.score for _, r in calc.try_results)


def test_ae_matches_the_golden_projection(tmp_path, monkeypatch):
    """The golden fixture's AE run (tests/test_golden.py: base_config, the
    colvars file at %.6f, the JAX package's initial parameters) by the
    port: within 1e-4 of tests/golden/ae_projection.npy."""
    system = _fixture_system(str(tmp_path / "system"))
    features = np.load(f"{GOLDEN_DIR}/features.npy")
    jcalc, calc = _train_both("ae", tmp_path, features, _feature_labels(), base_config(),
                              monkeypatch, fmt="%.6f", topology=system.pdb_path)
    got = calc.project_data(calc.training_data)
    np.testing.assert_allclose(got, np.load(f"{GOLDEN_DIR}/ae_projection.npy"),
                               atol=PROJECTION_TOL)
    np.testing.assert_allclose(got, jcalc.project_data(jcalc.training_data),
                               atol=PROJECTION_TOL)


def test_vae_batched_tries_equal_serial_tries(golden_features):
    """With the noise live, the batched tries draw as the serial tries do:
    each try's eps comes from its own generator."""
    calc = VAECalculator(_autoencoder_config(max_epochs=6), device="cpu")
    calc._set_training_data(golden_features, None, _feature_labels())
    assert calc.train()
    trainer = Trainer(calc.loss_fn, calc._trainer_config(3), device="cpu")
    serial = calc._run_tries_serial(trainer, calc.train_datasets(), None)
    for (n_s, s), (n_e, e) in zip(serial, calc.try_results):
        assert n_s == n_e and s.best_epoch == e.best_epoch
        for key in ("valid_loss", "valid_kl_loss", "train_loss"):
            np.testing.assert_allclose(s.metrics[key], e.metrics[key], rtol=1e-5)


@pytest.mark.parametrize("cv", ["ae", "vae"])
@pytest.mark.parametrize("mode", [None, "mean_std", "min_max_range1", "min_max_range2"])
def test_architecture_json_and_decoder_coupling_match_jax(cv, mode):
    """The architecture dict (what model.zip stores) equals the JAX
    package's, the decoder's last activation coupled to the normalization
    (custom_sigmoid for min_max_range1, tanh for min_max_range2, else the
    configured one)."""
    cfg = base_config(features_normalization=mode)
    cfg["architecture"]["decoder"]["last_layer_activation"] = "elu"
    cfg["architecture"]["encoder"].update(layers=[8, 4], activation=["tanh", "relu"],
                                          dropout=[0.1, None], batchnorm=[False, True])
    archs = []
    for calc in (JAX_CALCULATORS[cv](cfg), PORT_CALCULATORS[cv](cfg, device="cpu")):
        calc.num_features = 5
        calc.features_norm_mean = np.linspace(0.1, 0.5, 5)
        calc.features_norm_range = np.linspace(1.0, 2.0, 5)
        archs.append(json.loads(json.dumps(calc.build_architecture_dict())))
    want, got = archs
    assert got == want
    last = {"min_max_range1": "custom_sigmoid", "min_max_range2": "tanh"}.get(mode, "elu")
    assert got["decoder_options"]["activation"][-1] == last


@pytest.mark.parametrize("mode,last", [("min_max_range1", "custom_sigmoid"),
                                       ("min_max_range2", "tanh")])
def test_decoder_coupling_exports_alike(mode, last, golden_features, tmp_path):
    """An AE with the decoder's last activation set wrong for the
    normalization: the coupling corrects it, and the TorchScript weights
    project as the calculator (cf. tests/test_export_variants.py)."""
    cfg = _autoencoder_config(max_epochs=4)
    cfg["features_normalization"] = mode
    cfg["architecture"]["decoder"]["last_layer_activation"] = "softplus"
    calc = AECalculator(cfg, device="cpu")
    calc._set_training_data(golden_features, None, _feature_labels())
    assert calc.train()
    calc.normalize_cv()
    assert calc.architecture["decoder_options"]["activation"][-1] == last
    x_hat, _ = calc.module.reconstruct({k: v[None] for k, v in calc.params.items()},
                                       calc.training_data[None])
    lo, hi = (0.0, 1.0) if mode == "min_max_range1" else (-1.0, 1.0)
    assert float(x_hat.min()) >= lo and float(x_hat.max()) <= hi
    path = str(tmp_path / "weights.pt")
    calc.save_weights(path)
    with torch.no_grad():
        out = torch.jit.load(path)(torch.from_numpy(golden_features)).numpy()
    np.testing.assert_allclose(out, calc.project_data(golden_features), atol=1e-5)


# ---------------------------------------------------------------------------
# Batchnorm in the deep CVs
# ---------------------------------------------------------------------------

def _bn_config(**general):
    """Batchnorm after both encoder layers and after the decoder's second.
    Not after the decoder's first: that would make the latent's bias free
    (the reconstruction cannot see it), and the VAE's KL term, the one pull
    on it, is too weak to hold it against float32 noise in Adam."""
    cfg = _autoencoder_config(**general)
    cfg["architecture"]["encoder"].update(layers=[8, 6], activation=["tanh", "tanh"],
                                          dropout=[None, None], batchnorm=[True, True])
    cfg["architecture"]["decoder"].update(layers=[6, 8], activation=["tanh", "tanh"],
                                          dropout=[None, None], batchnorm=[False, True])
    return cfg


@pytest.mark.parametrize("cv", ["deep_tica", "ae", "vae"])
def test_batchnorm_folded_matches_jax(cv, golden_features, tmp_path, monkeypatch):
    """Each deep CV with batchnorm in its encoder (and the autoencoders'
    decoder) trains in both packages from the same initial parameters: the
    folded weights equal the JAX fold's (1e-6 on each try's own fold;
    1e-4 after training), the architecture drops its batchnorm flags, and
    the TorchScript weights project as the calculator."""
    if cv == "vae":
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
        monkeypatch.setattr(networks, "reparam_noise",
                            lambda shape, gens: torch.zeros(tuple(shape)))
    jcalc, calc = _train_both(cv, tmp_path, golden_features, _feature_labels(),
                              _bn_config(max_epochs=6), monkeypatch)
    for opts in ("encoder_options", "decoder_options"):
        if opts in calc.architecture:
            assert not any(calc.architecture[opts]["batchnorm"])
    assert not any(k.split("/")[-1].startswith("bn_") for k in calc.params)
    # deep-TICA's loss leaves its output layer's bias free (TICA centers
    # the outputs), so Adam moves it on float32 noise, differently in each
    # package; post_mean carries it, and the projection takes it out
    free = ("post_mean", "nn/dense_2/bias") if cv == "deep_tica" else ()
    got = _assert_calculators_match(jcalc, calc, golden_features, free)
    for key, value in params_from_flax(jax.tree.map(np.asarray, jcalc.params)).items():
        if key in free:
            continue
        np.testing.assert_allclose(calc.params[key].numpy(), value.numpy(), atol=1e-4,
                                   err_msg=key)
    # the fold of one set of parameters, in both packages
    xn = calc._normalized_training_inputs()
    best = min((r for _, r in calc.try_results), key=lambda r: r.score)
    prefix = "nn/" if cv == "deep_tica" else "encoder/"
    layers = calc.architecture.get("layers") or calc.architecture["encoder_layers"]
    opts = _bn_config()["architecture"]["encoder"]
    act = opts["activation"] + ([None] if cv != "vae" else [])
    bn = opts["batchnorm"] + ([False] if cv != "vae" else [])
    folded, _ = fold_feedforward_batchnorm(best.params, layers, act, bn, xn, prefix)
    tree = params_to_flax(best.params)[prefix[:-1]]
    want, _ = jax_fold(tree, layers, act, bn, jnp.asarray(xn.numpy()))
    for key, value in params_from_flax(want).items():
        np.testing.assert_allclose(folded[prefix + key].numpy(), value.numpy(),
                                   atol=FOLD_TOL, err_msg=key)
    path = str(tmp_path / "weights.pt")
    calc.save_weights(path)
    with torch.no_grad():
        out = torch.jit.load(path)(torch.from_numpy(golden_features)).numpy()
    np.testing.assert_allclose(out, got, atol=1e-5)


def test_unfolded_batchnorm_is_not_exported(golden_features, tmp_path):
    """An architecture that still has batchnorm flags (a zip written before
    folding) refuses the TorchScript export."""
    calc = AECalculator(_bn_config(max_epochs=2), device="cpu")
    calc._set_training_data(golden_features, None, _feature_labels())
    assert calc.train()
    arch = copy.deepcopy(calc.architecture)
    arch["encoder_options"]["batchnorm"][0] = True
    calc.architecture = arch
    with pytest.raises(ValueError, match="unfolded batchnorm"):
        calc.save_weights(str(tmp_path / "w.pt"))


def test_feedforward_jax_module_names_carry_over():
    """The JAX FeedForward's parameter names are the port's keys."""
    ff = FeedForward((4, 3, 2), ["tanh", None], [None, None], [True, False])
    tree = ff.init(jax.random.PRNGKey(0), jnp.zeros((2, 4)))["params"]
    assert set(params_from_flax(jax.tree.map(np.asarray, tree))) == {
        "dense_0/kernel", "dense_0/bias", "bn_scale_0", "bn_bias_0",
        "dense_1/kernel", "dense_1/bias"}


@pytest.mark.parametrize("cv", ["ae", "vae"])
def test_weights_from_jax_project_as_the_jax_calculator(cv, golden_features, tmp_path):
    """`ae_from_jax` / `vae_from_jax` on a JAX calculator's parameters and
    architecture project as that calculator (1e-5); every Flax subtree
    (encoder, decoder, mean_nn, log_var_nn) carries both ways unchanged."""
    from deep_cartograph_torch.models.weights import ae_from_jax, vae_from_jax

    path = _colvars(str(tmp_path / "colvars.dat"), golden_features, _feature_labels())
    jcalc = JAX_CALCULATORS[cv](configuration=_autoencoder_config(max_epochs=3),
                                output_path=str(tmp_path))
    jcalc.load_training_data([path], features_list=_feature_labels())
    assert jcalc.train()
    jcalc.normalize_cv()
    tree = jax.tree.map(np.asarray, jcalc.params)
    scopes = {"encoder", "decoder"} | ({"mean_nn", "log_var_nn"} if cv == "vae" else set())
    assert set(tree) == scopes
    back = params_to_flax(params_from_flax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    projection = (ae_from_jax if cv == "ae" else vae_from_jax)(tree, jcalc.architecture)
    with torch.no_grad():
        got = projection(torch.from_numpy(golden_features)).numpy()
    np.testing.assert_allclose(got, jcalc.project_data(golden_features), atol=1e-5)
    with pytest.raises(ValueError, match="architecture"):
        (vae_from_jax if cv == "ae" else ae_from_jax)(tree, jcalc.architecture)
