"""Port training engine (models/training.py) against the JAX package's, on
the same numpy inputs and the same initial parameters, on the CPU.

The batch orders come from numpy in both packages, so the two see the same
batches; the parameters start from the JAX package's Flax initialization,
carried across with models/weights.py. No test uses dropout: its masks come
from different generators in the two packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_cartograph_tpu.cv.deep import make_deep_tica_loss as jax_deep_tica_loss
from deep_cartograph_tpu.models import training as jax_training
from deep_cartograph_tpu.models.networks import DeepTICANet as JaxDeepTICANet
from deep_cartograph_torch.cv.deep import make_deep_tica_loss
from deep_cartograph_torch.models import training
from deep_cartograph_torch.models.networks import DeepTICAStack
from deep_cartograph_torch.models.weights import params_from_flax, params_to_flax

torch.set_num_threads(2)

LAYERS = (12, 16, 16, 2)
OPTIONS = {"activation": ["tanh", "tanh", None]}
SEEDS = [11, 12, 13]
# float32 sums in another order, compounded over the steps of 4 epochs
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _toy_pairs(n=300, lag=3, seed=0):
    """A slow 12-feature toy trajectory and its lag pairs."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n + lag, 12)), 0) * 0.1
    x = (np.sin(x) + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return {"data": x[:-lag], "data_lag": x[lag:]}


def _jax_init(seeds):
    net = JaxDeepTICANet(layers=LAYERS, options=OPTIONS)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    params = jax.vmap(
        lambda k: net.init({"params": k, "dropout": k}, jnp.zeros((2, 12)),
                           train=False)["params"]
    )(keys)
    return net, jax.tree.map(np.asarray, params)


def _config_kwargs(**overrides):
    kwargs = dict(batch_size=64, max_epochs=4, early_stop_patience=50,
                  optimizer_name="Adam", optimizer_kwargs={"lr": 1e-2})
    kwargs.update(overrides)
    return kwargs


def _trainers(**overrides):
    net, _ = _jax_init(SEEDS[:1])
    jt = jax_training.Trainer(
        jax_deep_tica_loss(net, 1e-6, 2),
        jax_training.TrainerConfig(device="cpu", **_config_kwargs(**overrides)),
    )
    pt = training.Trainer(
        make_deep_tica_loss(DeepTICAStack(LAYERS, OPTIONS), 1e-6, 2),
        training.TrainerConfig(**_config_kwargs(**overrides)),
        device="cpu",
    )
    return jt, pt


def _splits(n, seeds, frac=0.8):
    n_train = int(n * frac)
    orders = [np.random.default_rng(s).permutation(n) for s in seeds]
    return (np.asarray([o[:n_train] for o in orders], np.int32),
            np.asarray([o[n_train:] for o in orders], np.int32))


def _assert_result_matches(got, want):
    assert got.best_epoch == want.best_epoch
    assert got.description == want.description
    assert got.metrics["epoch"] == want.metrics["epoch"]
    for key in ("train_loss", "valid_loss", "valid_eigval_1", "valid_eigval_2"):
        np.testing.assert_allclose(got.metrics[key], want.metrics[key],
                                   rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(got.metrics["lr"], want.metrics["lr"], rtol=1e-6)
    np.testing.assert_allclose(got.score, want.score, rtol=LOSS_RTOL)
    flat_want = params_from_flax(jax.tree.map(np.asarray, want.params))
    assert set(got.params) == set(flat_want)
    # The output layer's bias is not compared: TICA removes the output mean,
    # so the loss does not depend on it and its gradient is float32 noise
    # (~1e-9) that Adam scales up to steps of the full learning rate. The
    # trained CV does not depend on it either (tests/test_torch_deep_tica.py
    # compares projections).
    flat_want.pop(f"nn/dense_{len(LAYERS) - 2}/bias")
    for key, value in flat_want.items():
        np.testing.assert_allclose(got.params[key].numpy(), value.numpy(),
                                   atol=PARAM_ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------

OPTIMIZERS = [
    ("Adam", {"lr": 1e-2}),
    ("Adam", {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-2}),
    ("SGD", {"lr": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.05}),
    ("RMSprop", {"lr": 1e-2}),
    ("RMSprop", {"lr": 1e-2, "alpha": 0.9, "eps": 1e-4, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS)
def test_optimizer_matches_optax_chain(name, kwargs):
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10 ** rng.uniform(-4, 0)
              for k, v in p0.items()} for _ in range(5)]

    opt = jax_training.make_optimizer(name, kwargs)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    port = training.Optimizer(name, kwargs)
    tp = {k: torch.from_numpy(v.copy())[None] for k, v in p0.items()}
    tstate = port.init(tp)
    lr = torch.tensor([kwargs["lr"]], dtype=torch.float32)
    for g in grads:
        port.step(tp, {k: torch.from_numpy(v)[None] for k, v in g.items()}, tstate, lr)
    for key in p0:
        np.testing.assert_allclose(tp[key][0].numpy(), np.asarray(jp[key]),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="not recognized"):
        training.Optimizer("LBFGS")


@pytest.mark.parametrize("total,kwargs", [
    (100, {}), (37, {"pct_start": 0.5, "div_factor": 10.0}),
    (1, {}), (250, {"final_div_factor": 100.0}),
])
def test_one_cycle_schedule_matches_optax(total, kwargs):
    want = jax_training.one_cycle_schedule(0.05, total, **kwargs)
    got = training.one_cycle_schedule(0.05, total, **kwargs)
    # float32 cosines of the two libraries differ by an ulp, which the
    # cancellation in cos + 1 near the cycle's end magnifies: held to 1e-6
    # of the peak rate
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-6 * 0.05, err_msg=str(count))


@pytest.mark.parametrize("n,batch,shuffle", [(130, 32, True), (64, 64, False), (5, 8, True)])
def test_make_batches_identical(n, batch, shuffle):
    for seed in (0, 7):
        got = training._make_batches(n, batch, shuffle, np.random.default_rng(seed))
        want = jax_training._make_batches(n, batch, shuffle, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_plateau_and_kl_annealing_match_jax():
    rng = np.random.default_rng(4)
    losses = np.cumsum(rng.normal(0, 1, 40))
    ours = training.ReduceLROnPlateau(factor=0.5, patience=2, cooldown=1, start_epoch=3)
    theirs = jax_training.ReduceLROnPlateau(factor=0.5, patience=2, cooldown=1, start_epoch=3)
    assert [ours.step(e, v) for e, v in enumerate(losses)] == \
        [theirs.step(e, v) for e, v in enumerate(losses)]
    for kind in ("linear", "sigmoid", "cyclical"):
        a = training.KLAnnealing(type=kind, start_epoch=5, n_epochs_anneal=20)
        b = jax_training.KLAnnealing(type=kind, start_epoch=5, n_epochs_anneal=20)
        assert [a.beta(e) for e in range(40)] == [b.beta(e) for e in range(40)]
        assert a.end_epoch == b.end_epoch


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer on a toy deep-TICA
# ---------------------------------------------------------------------------

def test_fit_ensemble_matches_jax():
    """3 tries, 4 epochs, batch 64 over 240 training pairs (a ragged tail of
    48 rows padded at weight 0)."""
    full = _toy_pairs()
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS)
    assert train_idx.shape[1] % 64 != 0
    _, params = _jax_init(SEEDS)
    jt, pt = _trainers()
    want = jt.fit_ensemble(params, full, train_idx, valid_idx, SEEDS)
    got = pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx, SEEDS)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_result_matches(g, w)


@pytest.mark.parametrize("model_to_save", ["best", "last"])
def test_fit_matches_jax(model_to_save):
    full = _toy_pairs(seed=1)
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS[:1])
    train = {k: v[train_idx[0]] for k, v in full.items()}
    valid = {k: v[valid_idx[0]] for k, v in full.items()}
    _, params = _jax_init(SEEDS[:1])
    one = jax.tree.map(lambda a: a[0], params)
    jt, pt = _trainers(model_to_save=model_to_save, early_stop_patience=2,
                       max_epochs=6)
    want = jt.fit(one, train, valid, seed=SEEDS[0])
    got = pt.fit(params_from_flax(one), train, valid, seed=SEEDS[0])
    _assert_result_matches(got, want)


def test_fit_ensemble_with_schedulers_matches_jax():
    full = _toy_pairs(seed=2)
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS[:2])
    _, params = _jax_init(SEEDS[:2])
    for scheduler in (
        {"name": "OneCycleLR", "kwargs": {"max_lr": 0.05}},
        {"name": "ReduceLROnPlateau",
         "kwargs": {"factor": 0.5, "patience": 0, "cooldown": 0}},
    ):
        jt, pt = _trainers(lr_scheduler=scheduler, max_epochs=5)
        want = jt.fit_ensemble(params, full, train_idx, valid_idx, SEEDS[:2])
        got = pt.fit_ensemble(params_from_flax(params), full, train_idx,
                              valid_idx, SEEDS[:2])
        for g, w in zip(got, want):
            _assert_result_matches(g, w)


def test_early_stop_with_small_patience_matches_jax():
    full = _toy_pairs(seed=3)
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS)
    _, params = _jax_init(SEEDS)
    # nothing "improves" by 1e9: every try stops after 1 + patience checks
    jt, pt = _trainers(early_stop_patience=2, early_stop_min_delta=1e9,
                       max_epochs=10, model_to_save="last")
    want = jt.fit_ensemble(params, full, train_idx, valid_idx, SEEDS)
    got = pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx, SEEDS)
    for g, w in zip(got, want):
        assert len(g.metrics["epoch"]) == 3
        _assert_result_matches(g, w)


def test_checkpoint_cadence_and_misalignment_match_jax():
    full = _toy_pairs(seed=4)
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS[:2])
    _, params = _jax_init(SEEDS[:2])
    for save_every, check_every in ((2, 1), (5, 3)):  # (5, 3) never aligns
        jt, pt = _trainers(save_check_every_n_epoch=save_every,
                           check_val_every_n_epoch=check_every, max_epochs=7)
        want = jt.fit_ensemble(params, full, train_idx, valid_idx, SEEDS[:2])
        got = pt.fit_ensemble(params_from_flax(params), full, train_idx,
                              valid_idx, SEEDS[:2])
        for g, w in zip(got, want):
            _assert_result_matches(g, w)


# ---------------------------------------------------------------------------
# The port against itself: the cases the JAX package's own tests cover
# ---------------------------------------------------------------------------

def test_serial_equals_ensemble():
    full = _toy_pairs(seed=5)
    train_idx, valid_idx = _splits(len(full["data"]), SEEDS)
    _, params = _jax_init(SEEDS)
    stacked = params_from_flax(params)
    _, pt = _trainers(max_epochs=5)
    ensemble = pt.fit_ensemble(stacked, full, train_idx, valid_idx, SEEDS)
    for t, seed in enumerate(SEEDS):
        train = {k: v[train_idx[t]] for k, v in full.items()}
        valid = {k: v[valid_idx[t]] for k, v in full.items()}
        serial = pt.fit({k: v[t] for k, v in stacked.items()}, train, valid, seed)
        assert serial.best_epoch == ensemble[t].best_epoch
        # the batched product sums in another order than one try alone
        np.testing.assert_allclose(serial.metrics["valid_loss"],
                                   ensemble[t].metrics["valid_loss"], rtol=1e-5)
        for key, value in serial.params.items():
            np.testing.assert_allclose(value.numpy(), ensemble[t].params[key].numpy(),
                                       atol=1e-5)


def test_provided_validation_matches_jax():
    """valid_idx indexes a separate validation dict, not the training rows."""
    full = _toy_pairs(n=256, seed=6)
    valid = _toy_pairs(n=80, seed=7)
    T = 2
    train_idx = np.tile(np.arange(256, dtype=np.int32), (T, 1))
    valid_idx = np.tile(np.arange(80, dtype=np.int32), (T, 1))
    _, params = _jax_init(SEEDS[:T])
    jt, pt = _trainers()
    want = jt.fit_ensemble(params, full, train_idx, valid_idx, SEEDS[:T], valid_data=valid)
    got = pt.fit_ensemble(params_from_flax(params), full, train_idx, valid_idx,
                          SEEDS[:T], valid_data=valid)
    for g, w in zip(got, want):
        _assert_result_matches(g, w)


@pytest.mark.parametrize("provided_valid", [False, True])
def test_index_offsets_zero_copy_equals_explicit_pairs(provided_valid):
    lag = 3
    rng = np.random.default_rng(8)
    x = np.sin(np.cumsum(rng.standard_normal((303, 12)), 0) * 0.1).astype(np.float32)
    explicit = {"data": x[:-lag], "data_lag": x[lag:]}
    shared = {"data": x, "data_lag": x}
    n = len(explicit["data"])
    train_idx, valid_idx = _splits(n, SEEDS[:2])
    valid = _toy_pairs(n=60, seed=9) if provided_valid else None
    if provided_valid:
        valid_idx = np.tile(np.arange(60, dtype=np.int32), (2, 1))
    _, params = _jax_init(SEEDS[:2])
    _, pt = _trainers()
    want = pt.fit_ensemble(params_from_flax(params), explicit, train_idx,
                           valid_idx, SEEDS[:2], valid_data=valid)
    got = pt.fit_ensemble(params_from_flax(params), shared, train_idx, valid_idx,
                          SEEDS[:2], valid_data=valid, index_offsets={"data_lag": lag})
    for g, w in zip(got, want):
        assert g.metrics["valid_loss"] == w.metrics["valid_loss"]
        for key in w.params:
            torch.testing.assert_close(g.params[key], w.params[key], rtol=0, atol=0)


def test_params_round_trip_through_the_flax_layout():
    _, params = _jax_init(SEEDS)
    flat = params_from_flax(params)
    assert flat["nn/dense_0/kernel"].shape == (3, 12, 16)
    back = params_to_flax(flat)
    for key, value in params_from_flax(back).items():
        torch.testing.assert_close(value, flat[key], rtol=0, atol=0)
