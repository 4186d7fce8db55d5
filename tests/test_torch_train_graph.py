"""The trainer's step as a CUDA graph (`models/training.py::_Steps`) and
what the capture needs: deep-TICA's training loss as the trace of the
whitened Ctau (no eigh, Cholesky's info checked at the epoch's end),
dropout masks drawn once for both forwards, and the counters of replays
and captures.

On the CPU: the trace loss and its gradient against the sum of
`generalized_eigh`'s eigenvalues, the masks against the generator-state
replay they took the place of, the counters, and a Cholesky failure
raised at the epoch's end. On the card (marker `cuda`; these import no
JAX, so they run past the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py

every step's loss, Adam's moments and the final parameters of a replayed
fit against the same fit run eagerly on the card (deep-TICA with dropout,
the VAE through its KL annealing, the AE), the steps after the eager ones
under `torch.cuda.set_sync_debug_mode("error")`, the counters, the
Cholesky failure, and a loss that cannot be captured."""

import sys
import threading

import numpy as np
import pytest
import torch

from deep_cartograph_torch.cv import cv_calculators_map
from deep_cartograph_torch.cv.deep import _deep_tica_covariances, make_deep_tica_loss
from deep_cartograph_torch.cv.tica_math import (
    generalized_eigh,
    generalized_eigvals_sum,
    timelagged_covariances,
)
from deep_cartograph_torch.models import training
from deep_cartograph_torch.models.networks import DeepTICAStack
from deep_cartograph_torch.models.training import (
    CHOLESKY_INFO,
    TRAIN_STATS,
    Trainer,
    TrainerConfig,
    TrainStats,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def _gap(got, want):
    """The largest difference over the largest magnitude, across leaves."""
    got, want = list(got), list(want)
    diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return diff / max(float(b.double().abs().max()) for b in want)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 64 * torch.finfo(torch.float32).eps)])
def test_trace_loss_equals_minus_the_eigenvalue_sum_and_so_does_its_gradient(dtype, tol):
    """The training loss (trace of the whitened Ctau) against validation's
    -sum of `generalized_eigh`'s eigenvalues, through a net of two tries
    with a ragged batch: values and every parameter's gradient."""
    stack = DeepTICAStack([7, 9, 3], {"activation": ["tanh", None]})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 50, 7), generator=gen, dtype=dtype)
    weight = torch.ones((2, 50), dtype=dtype)
    weight[:, 41:] = 0.0
    batch = {"data": x, "data_lag": x + 0.3 * torch.randn(x.shape, generator=gen, dtype=dtype),
             "weight": weight}
    loss_fn = make_deep_tica_loss(stack, 1e-6, 3)
    got, want = [], []
    for train, out in ((True, got), (False, want)):
        params = {k: v.to(dtype).requires_grad_(True) for k, v in stack.init([1, 2]).items()}
        loss, aux = loss_fn(params, batch, None, 0.0, train)
        out.append(loss.detach())
        out.extend(torch.autograd.grad(loss.sum(), list(params.values())))
    assert sorted(aux) == ["eigval_1", "eigval_2", "eigval_3"]
    assert _gap(got[:1], want[:1]) <= tol
    assert _gap(got[1:], want[1:]) <= tol


def test_trace_loss_carries_cholesky_s_info():
    """A C0 + reg I that is not positive definite: the training loss
    returns Cholesky's info for that try and raises nothing."""
    c0 = torch.eye(3).expand(2, 3, 3).clone()
    c0[1, 1, 1] = -1.0
    total, info = generalized_eigvals_sum(torch.eye(3).expand(2, 3, 3), c0, 1e-6)
    assert info.tolist() == [0, 2]
    assert float(total[0]) == pytest.approx(3 / (1 + 1e-6))
    with pytest.raises(torch.linalg.LinAlgError, match="positive-definite"):
        generalized_eigh(torch.eye(3).expand(2, 3, 3), c0, 1e-6)


def test_masks_drawn_once_equal_the_generator_state_replay():
    """Dropout on both of deep-TICA's forwards: the masks drawn once by the
    first forward give the outputs the generator-state replay gave (q_t's
    draws, the generators set back, q_lag's draws), and leave every
    generator where that replay left it."""
    stack = DeepTICAStack([6, 8, 8, 2], {"activation": ["tanh", "tanh", None],
                                         "dropout": [0.3, 0.2, None]})
    params = stack.init([5, 6, 7])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 40, 6), generator=gen)
    x_lag = torch.randn((3, 40, 6), generator=gen)

    def generators():
        return [torch.Generator().manual_seed(s) for s in (11, 12, 13)]

    replayed = generators()
    states = [g.get_state() for g in replayed]
    q_t = stack(params, x, train=True, generators=replayed)
    for g, state in zip(replayed, states):
        g.set_state(state)
    q_lag = stack(params, x_lag, train=True, generators=replayed)

    once, masks = generators(), {}
    assert torch.equal(stack(params, x, train=True, generators=once, masks=masks), q_t)
    assert sorted(masks) == [0, 1] and masks[0].shape == (3, 40, 8)
    assert torch.equal(stack(params, x_lag, train=True, generators=once, masks=masks), q_lag)
    for a, b in zip(once, replayed):
        assert torch.equal(a.get_state(), b.get_state())
    c0, ctau = _deep_tica_covariances(stack, params, {"data": x, "data_lag": x_lag,
                                                      "weight": torch.ones(3, 40)},
                                      generators(), True)
    want = timelagged_covariances(q_t, q_lag, torch.ones(3, 40))
    assert torch.equal(c0, want[0]) and torch.equal(ctau, want[1])


def test_train_stats_count_replays_and_captures_and_reset_under_the_lock():
    stats = TrainStats()
    stats.count_epoch(10, 0.01, 0.01, replayed=7, captures=1)
    stats.count_epoch(10, 0.005, 0.01, replayed=10)
    stats.count_post_annealing(2)
    assert (stats.steps, stats.plateau_steps, stats.replayed_steps, stats.captures,
            stats.post_annealing_selections) == (20, 10, 17, 1, 2)
    stats.reset()
    assert stats == TrainStats()

    # more threads than cores, each switch-prone: no count is lost
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            for _ in range(2000):
                stats.count_epoch(3, 0.0, None, replayed=2, captures=1)

        threads = [threading.Thread(target=count) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert (stats.steps, stats.replayed_steps, stats.captures) == (96000, 64000, 32000)


# ---------------------------------------------------------------------------
# The trainer on the CPU and on the card
# ---------------------------------------------------------------------------

def _pairs(n=400, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((n, d)), 0) * 0.05
    x = (np.sin(x) + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    return {"data": x[:-1], "data_lag": x[1:]}


def _fit(device, loss_fn, epochs=2, tries=3, batch=32):
    """A deep-TICA fit of `tries` tries on 320 of 399 pairs (10 steps an
    epoch), validation on the rest every epoch."""
    data = _pairs()
    stack = DeepTICAStack([12, 16, 2], {"activation": ["tanh", None]})
    n = len(data["data"])
    orders = [np.random.default_rng(s).permutation(n) for s in range(tries)]
    trainer = Trainer(loss_fn(stack), TrainerConfig(batch_size=batch, max_epochs=epochs,
                                                    optimizer_name="Adam",
                                                    optimizer_kwargs={"lr": 1e-3}),
                      device)
    return trainer.fit_ensemble(stack.init(list(range(tries))), data,
                                np.asarray([o[:320] for o in orders]),
                                np.asarray([o[320:] for o in orders]), list(range(tries)))


def test_a_cholesky_failure_fails_the_fit_at_the_epoch_s_end(device):
    """A training step whose factorization fails raises nothing there: the
    epoch runs to its end, and the read of its losses raises what
    `torch.linalg.cholesky` raises (try 1 of 3 failing from step 2 on)."""
    calls = []

    def failing(stack):
        loss_fn = make_deep_tica_loss(stack, 1e-6, 2)

        def fn(params, batch, generators, beta, train=True):
            loss, aux = loss_fn(params, batch, generators, beta, train)
            if train:
                calls.append(1)
                c0 = torch.eye(2, device=loss.device).repeat(3, 1, 1)
                c0[1] *= -1.0 if len(calls) > 1 else 1.0
                aux = {CHOLESKY_INFO: torch.linalg.cholesky_ex(c0)[1]}
            return loss, aux

        return fn

    with pytest.raises(torch.linalg.LinAlgError,
                       match=r"linalg.cholesky: \(Batch element 1\).*order 1 is not "
                             r"positive-definite"):
        _fit(device, failing)
    # every step of the epoch ran: eagerly, or the eager ones and a capture
    assert len(calls) == (10 if device.type == "cpu" else training.EAGER_STEPS + 1)


def test_counters_read_every_step_after_the_eager_ones_replayed(device):
    """One fit at a constant beta, 2 epochs of 10 steps: on the card every
    step after the first EAGER_STEPS replayed from one capture; on the CPU
    none."""
    TRAIN_STATS.reset()
    _fit(device, lambda stack: make_deep_tica_loss(stack, 1e-6, 2))
    on_card = device.type == "cuda"
    assert (TRAIN_STATS.steps, TRAIN_STATS.replayed_steps, TRAIN_STATS.captures) == \
        (20, 20 - training.EAGER_STEPS if on_card else 0, int(on_card))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _features(n=400, d=12, seed=0):
    return _pairs(n + 1, d, seed)["data"]


CONFIGS = {
    "deep_tica": {
        "dimension": 2, "lag_time": 1, "features_normalization": "mean_std",
        "architecture": {"encoder": {"layers": [16, 16], "activation": ["tanh", "tanh"],
                                     "dropout": [0.1, 0.1]}},
        "training": {"general": {"num_tries": 3, "batch_size": 32, "max_epochs": 2},
                     "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}}},
    },
    "vae": {
        "dimension": 2, "features_normalization": "mean_std",
        "architecture": {"encoder": {"layers": [16, 8], "activation": ["leaky_relu"] * 2,
                                     "dropout": [0.1, 0.1]}},
        "training": {"general": {"num_tries": 2, "batch_size": 32, "max_epochs": 3},
                     "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}},
                     "kl_annealing": {"type": "linear", "start_epoch": 0,
                                      "n_epochs_anneal": 2}},
    },
    "ae": {
        "dimension": 2, "features_normalization": "mean_std",
        "architecture": {"encoder": {"layers": [16, 8], "activation": ["tanh"] * 2}},
        "training": {"general": {"num_tries": 2, "batch_size": 32, "max_epochs": 2},
                     "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}}},
    },
}


def _train(cv, device, monkeypatch, replays=True):
    """`cv`'s calculator trained on the card, with each step's losses and
    Adam's moments read after the step; `replays=False` runs every step
    eagerly. Returns (the calculator, the record)."""
    record = []
    call = training._Steps.__call__

    def recorded(self, beta):
        call(self, beta)
        record.append([self.loss.clone()]
                      + [v.clone() for v in self.opt_state["mu"].values()]
                      + [v.clone() for v in self.opt_state["nu"].values()])

    with monkeypatch.context() as m:
        m.setattr(training._Steps, "__call__", recorded)
        if not replays:
            m.setattr(training, "_replays", lambda dev: False)
        x = _features()
        calc = cv_calculators_map[cv](CONFIGS[cv], device=device)
        calc._set_training_data(x, None, [f"f{i}" for i in range(x.shape[1])])
        TRAIN_STATS.reset()
        assert calc.train()
    return calc, record


@pytest.mark.cuda
@pytest.mark.parametrize("cv,captures", [("deep_tica", 1), ("vae", 3), ("ae", 1)])
def test_replayed_steps_equal_eager_steps_on_the_card(cuda, monkeypatch, cv, captures):
    """The same fit run eagerly on the card and replayed: every step's
    losses, Adam's first and second moments, and each try's final
    parameters within 1e-6 of the largest magnitude (deep-TICA with
    dropout, 3 tries; the VAE's beta changes each epoch, so it captures
    once an epoch; the AE)."""
    eager, eager_steps = _train(cv, cuda, monkeypatch, replays=False)
    assert TRAIN_STATS.replayed_steps == TRAIN_STATS.captures == 0
    graph, graph_steps = _train(cv, cuda, monkeypatch)
    steps = TRAIN_STATS.steps
    assert steps >= 2 * 8 and len(graph_steps) == len(eager_steps) == steps
    assert (TRAIN_STATS.replayed_steps, TRAIN_STATS.captures) == \
        (steps - training.EAGER_STEPS, captures)
    for s, (got, want) in enumerate(zip(graph_steps, eager_steps)):
        assert _gap(got[:1], want[:1]) <= 1e-6, f"step {s}: loss"
        assert _gap(got[1:], want[1:]) <= 1e-6, f"step {s}: Adam's moments"
    for (_, a), (_, b) in zip(graph.try_results, eager.try_results):
        assert _gap(a.params.values(), b.params.values()) <= 1e-6
        assert a.metrics["valid_loss"] == pytest.approx(b.metrics["valid_loss"], rel=1e-6)


@pytest.mark.cuda
def test_steps_after_the_eager_ones_wait_for_nothing(cuda, monkeypatch):
    """Every step after the eager ones, the capture and the replays, under
    torch's sync debug mode "error": none waits for the card."""
    strict = []
    call = training._Steps.__call__

    def checked(self, beta):
        if self.eager_left:
            return call(self, beta)
        torch.cuda.set_sync_debug_mode("error")
        try:
            call(self, beta)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        strict.append(self.replayed)

    monkeypatch.setattr(training._Steps, "__call__", checked)
    TRAIN_STATS.reset()
    _fit(cuda, lambda stack: make_deep_tica_loss(stack, 1e-6, 2))
    assert strict == list(range(1, 20 - training.EAGER_STEPS + 1))


@pytest.mark.cuda
def test_a_loss_that_cannot_be_captured_raises_a_clear_error(cuda):
    def waiting(stack):
        loss_fn = make_deep_tica_loss(stack, 1e-6, 2)

        def fn(params, batch, generators, beta, train=True):
            loss, aux = loss_fn(params, batch, generators, beta, train)
            if float(loss.sum()) > 1e9:   # a host read: the host waits for the card
                raise AssertionError("unreachable")
            return loss, aux

        return fn

    with pytest.raises(RuntimeError, match="cannot be captured in a CUDA graph"):
        _fit(cuda, waiting)
