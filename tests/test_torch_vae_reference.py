"""The port's VAE (`models/networks.py::VAEStack`, `cv/deep.py::VAECalculator`,
`models/training.py`) against the benchmark's plain float64 reference
(`carto_bench/reference_vae.py`) on the CPU, at a small size: the ELBO's
parts and the gradient of every leaf with the same noise and dropout masks,
three steps of `VAECalculator.train()` against the reference's Adam steps,
the KL schedule and the post-annealing selection as the benchmark's cell
sets them, the trainer's counter, and the four `vae.*` spans."""

import copy

import numpy as np
import pytest
import torch

from carto_bench import reference, reference_vae
from carto_bench.harness import Cell
from deep_cartograph_torch.cv.deep import DeepTICACalculator, VAECalculator
from deep_cartograph_torch.models import training
from deep_cartograph_torch.models.networks import VAEStack, seed_generators
from deep_cartograph_torch.models.training import KLAnnealing, TrainStats
from tests.test_cv import base_config
from tests.test_torch_spans import each_inside, inside, of, traced_spans

torch.set_num_threads(2)

N_FEATURES, ENCODER, DECODER, N_CVS, BATCH = 40, [32, 16, 8], [4, 8], 2, 16
LEAKY = ["leaky_relu"] * 3
OPTIONS = {"encoder": {"activation": LEAKY, "dropout": [0.1] * 3, "batchnorm": [False] * 3},
           "decoder": {"activation": LEAKY, "dropout": [0.1, 0.1, None],
                       "batchnorm": [False] * 3}}
PLAN = reference_vae.layer_plan(N_FEATURES, ENCODER, N_CVS, DECODER)
CELL = "lambda80_vae.train_vae"


def features(n_frames=60, seed=5):
    """Distances-like positive columns and sin/cos-like bounded ones."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.4, 3.0, (n_frames, N_FEATURES - 10))
    ang = rng.uniform(-1.0, 1.0, (n_frames, 10))
    return np.concatenate([pos, ang], 1).astype(np.float32)


def stack(norm):
    """The port's stack with the cell's resolved options."""
    return VAEStack(N_CVS, [N_FEATURES] + ENCODER, DECODER + [N_FEATURES], OPTIONS["encoder"],
                    OPTIONS["decoder"], *(norm if norm is not None else (None, None)))


def vae_config(num_tries=1, max_epochs=1, normalization=None):
    """The cell's `cv` block at the test's widths, resolved as its job
    resolves it (`jobs/train_vae.py::calculator_config`)."""
    cell = copy.deepcopy(Cell.find(CELL).config)
    cell["cv"]["architecture"]["encoder"]["layers"] = ENCODER
    cell["cv"]["architecture"]["decoder"]["layers"] = DECODER
    general = cell["cv"]["training"]["general"]
    general.update(num_tries=num_tries, batch_size=BATCH)
    if normalization:
        cell["cv"]["features_normalization"] = normalization
    return Cell.find(CELL).job_module().calculator_config(cell, max_epochs)


@pytest.mark.parametrize("tries", [1, 2])
def test_initial_parameters_are_the_port_s(tries):
    seeds = [43 + t for t in range(tries)]
    got = stack(None).init(seeds)
    ref = reference_vae.initial_params(PLAN, seeds, torch.float32)
    assert set(got) == set(ref)
    for k in got:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("at", [-1.0, 0.0, 2.0])
def test_the_reference_s_leaky_relu_is_torch_s_with_its_gradient(at):
    """Its slope at 0 too: a row whose units dropout zeroed all reaches
    the next layer at exactly 0 while the biases are 0."""
    from deep_cartograph_torch.models.networks import ACTIVATIONS

    x = torch.tensor([at], dtype=torch.float64, requires_grad=True)
    y = ACTIVATIONS["leaky_relu"](x)
    r = reference_vae.activate(x, "leaky_relu")
    assert float(y) == float(r)
    assert float(torch.autograd.grad(y, x)[0]) == float(torch.autograd.grad(r, x)[0])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("normalization", [None, "mean_std"])
@pytest.mark.parametrize("tries", [1, 2])
def test_elbo_parts_and_gradients_match_the_reference(train, normalization, tries):
    """The same noise and masks: the port draws them from its generators,
    the reference from generators of the same seeds in the port's order."""
    x = torch.as_tensor(features())
    norm = None
    if normalization:
        norm = (x.double().mean(0), x.double().std(0, unbiased=False))
    seeds = [43 + t for t in range(tries)]
    net = stack(None if norm is None else tuple(v.float() for v in norm))
    params = {k: v.clone().requires_grad_(True) for k, v in net.init(seeds).items()}
    rows = torch.arange(BATCH * tries).reshape(tries, BATCH)
    recon, kl = net.elbo_parts(params, x[rows], seed_generators(seeds), train=train)
    beta = 0.01
    grads = torch.autograd.grad((recon.mean(-1) + beta * kl.mean(-1)).sum(), list(params.values()))

    # without dropout the port draws eps alone
    rates = {k: OPTIONS[k]["dropout"] if train else [None] * 3 for k in OPTIONS}
    enc_masks, eps, dec_masks = reference_vae.draws(
        BATCH, seeds, N_CVS, ENCODER, rates["encoder"], DECODER + [N_FEATURES],
        rates["decoder"], 1, "cpu")[0]
    ref_params = {k: v.double().requires_grad_(True) for k, v in params.items()}
    r_recon, r_kl = reference_vae.elbo_parts(ref_params, x[rows], norm, OPTIONS, eps,
                                             (enc_masks, dec_masks))
    r_grads = torch.autograd.grad((r_recon.mean(-1) + beta * r_kl.mean(-1)).sum(),
                                  list(ref_params.values()))
    np.testing.assert_allclose(recon.detach().double(), r_recon.detach(), rtol=2e-6)
    np.testing.assert_allclose(kl.detach().double(), r_kl.detach(), rtol=2e-5, atol=1e-7)
    for k, g, r in zip(params, grads, r_grads):
        scale = float(r.abs().max())
        assert float((g.double() - r).abs().max()) <= 1e-5 * max(scale, 1e-3), k


@pytest.mark.parametrize("normalization", [None, "mean_std"])
def test_three_train_steps_match_the_reference_adam(normalization):
    """One epoch of 3 steps (48 training rows of 60, batch 16) through
    `VAECalculator.train()` against the reference's Adam steps in float64
    from the same seed: the losses of each step and the parameters after."""
    x = features()
    cfg = vae_config(normalization=normalization)
    calc = VAECalculator(cfg, device="cpu")
    calc._set_training_data(x, np.zeros(len(x), np.int64), [f"f{i}" for i in range(N_FEATURES)])
    assert calc.train()
    (_, result), = calc.try_results
    assert result.description == "best post-annealing"

    seeds = [cfg["training"]["general"]["seed"] + 1]
    batches = reference.first_batches(len(x), 0.8, BATCH, seeds, 3)
    draws = reference_vae.draws(BATCH, seeds, N_CVS, ENCODER, OPTIONS["encoder"]["dropout"],
                                DECODER + [N_FEATURES], OPTIONS["decoder"]["dropout"], 3, "cpu")
    xt = torch.as_tensor(x)
    norm = None
    if normalization:
        std = xt.double().std(0, unbiased=False)
        norm = (xt.double().mean(0), std)
    ref = reference_vae.adam_steps(xt, norm, reference_vae.initial_params(PLAN, seeds,
                                                                          torch.float32),
                                   batches, draws, OPTIONS, 0.01, 1e-3)
    np.testing.assert_allclose(result.metrics["train_loss"][0],
                               float(ref["losses"].mean()), rtol=1e-5)
    for k, v in ref["params"].items():
        gap = (result.params[k].double() - v[0]).abs().max()
        assert float(gap) <= 1e-3 * 1e-3, k   # a thousandth of a step of lr 1e-3


@pytest.mark.parametrize("epoch, beta", [(0, 0.0), (3000, 0.0), (3001, 5e-6), (4000, 0.005),
                                         (5000, 0.01), (7999, 0.01)])
def test_the_published_linear_schedule(epoch, beta):
    kl = vae_config(max_epochs=8000)["training"]["kl_annealing"]
    published = KLAnnealing(type=kl["type"], start_beta=kl["start_beta"],
                            max_beta=kl["max_beta"], start_epoch=3000,
                            n_epochs_anneal=kl["n_epochs_anneal"])
    assert published.beta(epoch) == pytest.approx(beta, abs=1e-12)


@pytest.mark.parametrize("epoch", [0, 1, 2, 2999])
def test_the_cell_s_calls_lie_on_the_plateau(epoch):
    """The cell's epoch e is the published epoch 5000 + e: beta at
    max_beta from the first, and the post-annealing selection on."""
    calc = VAECalculator(vae_config(max_epochs=3000), device="cpu")
    schedule = calc.kl_annealing_schedule()
    assert schedule.start_epoch == 3000 - 5000 and schedule.end_epoch == 0
    assert schedule.beta(epoch) == 0.01
    assert calc.uses_post_annealing()
    assert calc._trainer_config(10).post_annealing_checkpoint


@pytest.mark.parametrize("tries, epochs", [(1, 1), (2, 2)])
def test_the_trainer_counts_the_vae_s_steps_noise_and_selections(monkeypatch, tries, epochs):
    stats = TrainStats(steps=7, plateau_steps=1)
    monkeypatch.setattr(training, "TRAIN_STATS", stats)
    stats.reset()
    x = features()
    calc = VAECalculator(vae_config(num_tries=tries, max_epochs=epochs), device="cpu")
    calc._set_training_data(x, np.zeros(len(x), np.int64), [f"f{i}" for i in range(N_FEATURES)])
    assert calc.train()
    steps = 3 * epochs
    assert (stats.steps, stats.plateau_steps) == (steps, steps)
    assert stats.post_annealing_selections == tries


def test_deep_tica_counts_steps_without_kl(monkeypatch):
    stats = TrainStats()
    monkeypatch.setattr(training, "TRAIN_STATS", stats)
    x = features()
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 2, "max_epochs": 2, "batch_size": 16})
    calc = DeepTICACalculator(configuration=cfg, device="cpu")
    calc._set_training_data(x, np.zeros(len(x)), [f"f{i}" for i in range(N_FEATURES)])
    assert calc.train()
    steps = 2 * -(-int((len(x) - 1) * 0.8) // 16)
    assert (stats.steps, stats.plateau_steps,
            stats.post_annealing_selections) == (steps, 0, 0)


def test_the_counter_counts_under_its_lock_and_resets():
    import threading

    stats = TrainStats()
    threads = [threading.Thread(target=lambda: [stats.count_epoch(2, 0.01, 0.01)
                                                for _ in range(2000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    stats.count_epoch(5, 0.01, 0.01)
    stats.count_epoch(5, 0.005, 0.01)
    stats.count_epoch(5, 0.0, None)
    stats.count_post_annealing(3)
    assert (stats.steps, stats.plateau_steps,
            stats.post_annealing_selections) == (32015, 32005, 3)
    stats.reset()
    assert stats == TrainStats()


def test_the_vae_spans(tmp_path):
    """`vae.encode`, `vae.sample`, `vae.decode`, `vae.elbo` in that order in
    every step's `trainer.forward` and in the validation."""
    x = features()
    calc = VAECalculator(vae_config(), device="cpu")
    calc._set_training_data(x, np.zeros(len(x), np.int64), [f"f{i}" for i in range(N_FEATURES)])
    trained, spans = traced_spans(calc.train, tmp_path)
    assert trained
    names = ("vae.encode", "vae.sample", "vae.decode", "vae.elbo")
    for name in names:
        assert len(of(spans, name)) == 3 + 1, name
    for parent in of(spans, "trainer.forward") + of(spans, "trainer.validate"):
        within = [s["name"] for s in sorted(spans, key=lambda s: s["a"])
                  if s is not parent and inside(s, parent)]
        assert within == list(names)
    assert each_inside(spans, "vae.elbo", "trainer.fit")
