"""The per-device runner (`parallel.mesh.run_per_device`) and the per-path
default routing (`parallel.mesh.mesh_for(device, path)`), on the CPU.

Every path that launches its devices' work through the runner is held
bit for bit to the same path run as a plain sequential loop in the
caller's thread (`_inline` patched to true), on a mesh that lists the CPU
four times: the filter statistics, FramesToCV, the FES logsumexp (K2's
plain version a shard), TICA's covariances, the streaming HTICA and the
trainer's lanes. The routing is checked with `torch.cuda.device_count`
patched to four cards, which needs no card: four H100s ran no sharded
path faster than one card, so without `use_mesh` a call stays on its
device.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from deep_cartograph_torch.cv.htica_stream import StreamingHTICA
from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.models import training
from deep_cartograph_torch.models.networks import DeepTICAStack
from deep_cartograph_torch.cv.deep import make_deep_tica_loss
from deep_cartograph_torch.ops.build import KernelStats
from deep_cartograph_torch.parallel import mesh as port_mesh
from deep_cartograph_torch.parallel.mesh import Mesh, get_mesh, run_per_device, use_mesh
from deep_cartograph_torch.parallel.sharding import sharded_covariances, sharded_kde_logsumexp
from deep_cartograph_torch.stats import descriptors

torch.set_num_threads(2)

CPU4 = Mesh(("cpu",) * 4)


@pytest.fixture
def sequential(monkeypatch):
    """Within the fixture, `run_per_device` is a plain loop in the caller's
    thread."""

    def use():
        monkeypatch.setattr(port_mesh, "_inline", lambda mesh: True)

    return use


def _both(sequential, fn):
    """fn() with the workers, then as a sequential loop."""
    threaded = fn()
    sequential()
    return threaded, fn()


def _assert_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


def test_entries_run_on_their_devices_worker_in_mesh_order():
    caller = threading.get_ident()
    first = run_per_device(lambda dev, i: (i, str(dev), threading.get_ident()), CPU4, range(4))
    assert [r[:2] for r in first] == [(i, "cpu") for i in range(4)]
    threads = {r[2] for r in first}
    # one worker a device: the CPU listed four times runs on one thread
    assert caller not in threads and len(threads) == 1
    # the worker persists: a second call runs on the same thread
    assert set(run_per_device(lambda dev: threading.get_ident(), CPU4)) == threads


def test_a_mesh_of_one_runs_in_the_callers_thread():
    caller = threading.get_ident()
    assert run_per_device(lambda dev: threading.get_ident(), Mesh(("cpu",))) == [caller]


def test_a_call_from_a_worker_runs_inline():
    def outer(dev, i):
        me = threading.get_ident()
        return all(t == me for t in run_per_device(lambda d: threading.get_ident(), CPU4))

    assert run_per_device(outer, CPU4, range(4)) == [True] * 4


def test_an_entry_that_raises_is_raised_in_the_caller_naming_its_device():
    finished = []

    def fn(dev, i):
        if i == 2:
            raise ValueError("shard 2 failed")
        finished.append(i)
        return i

    with pytest.raises(ValueError, match="shard 2 failed") as info:
        run_per_device(fn, Mesh(("cpu",) * 4), range(4))
    assert "raised on mesh entry 2 (cpu)" in info.value.__notes__
    # every other entry ran to its end; none was rerun elsewhere
    assert sorted(finished) == [0, 1, 3]


def test_every_failed_entry_is_named():
    def fn(dev, i):
        if i >= 1:
            raise RuntimeError(f"entry {i}")

    with pytest.raises(RuntimeError, match="entry 1") as info:
        run_per_device(fn, CPU4, range(4))
    notes = info.value.__notes__
    assert notes[0] == "raised on mesh entry 1 (cpu)"
    assert [n.split(":")[0] for n in notes[1:]] == [
        "mesh entry 2 (cpu) raised too", "mesh entry 3 (cpu) raised too"]


def test_workers_take_the_callers_grad_mode_and_mesh():
    with torch.no_grad():
        assert run_per_device(lambda dev: torch.is_grad_enabled(), CPU4) == [False] * 4
    assert run_per_device(lambda dev: torch.is_grad_enabled(), CPU4) == [True] * 4
    inner = Mesh(("cpu",) * 2)
    with use_mesh(inner):
        assert all(m is inner for m in run_per_device(lambda dev: get_mesh(), CPU4))


def test_kernel_counts_lose_no_update_under_many_threads(monkeypatch):
    """The wrappers count from every card's worker at once."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    stats = KernelStats("counted")

    def count():
        for _ in range(2000):
            stats.count_plain()
            stats.count_launch()

    threads = [threading.Thread(target=count) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stats.plain_calls == stats.launches == 16 * 2000


# ---------------------------------------------------------------------------
# Each path: the workers against a sequential loop, bit for bit
# ---------------------------------------------------------------------------


def test_statistics_on_workers_equal_a_sequential_loop(monkeypatch, sequential):
    # blocks of 3 features over 4 entries: some slices are empty
    monkeypatch.setattr("deep_cartograph_torch.utils.device.SMALL_WORK_ELEMENTS", 0)
    monkeypatch.setattr(descriptors, "BLOCK_ELEMENT_BUDGET", 3 * 400)
    x = np.random.default_rng(3).standard_normal((400, 37)).astype(np.float32)

    def stats():
        with use_mesh(CPU4):
            return (descriptors.shannon_entropy(x, device="cpu"),
                    descriptors.standard_deviation(x, device="cpu"))

    threaded, plain = _both(sequential, stats)
    _assert_equal(threaded, plain)
    _assert_equal(plain, (descriptors.shannon_entropy(x, device="cpu"),
                          descriptors.standard_deviation(x, device="cpu")))


def test_frames_to_cv_on_workers_equals_a_sequential_loop(ca_system, sequential):
    top = Topology.from_pdb(ca_system.pdb_path)
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, 13) for j in range(i + 2, 13)]
    labels += [f"sin-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}" for i in range(1, 10)]
    n_feat = compile_plan(labels, top).n_features
    rng = np.random.default_rng(4)
    projection = LinearProjection(np.zeros(n_feat), np.ones(n_feat),
                                  rng.standard_normal((n_feat, 2)), np.zeros(2), np.ones(2))

    def serve():
        with use_mesh(CPU4):
            pipeline = FramesToCV(projection, top, labels, device="cpu")
            assert pipeline.mesh is CPU4
            return pipeline(ca_system.coords), pipeline(ca_system.coords[:3])

    threaded, plain = _both(sequential, serve)
    _assert_equal(threaded, plain)
    np.testing.assert_allclose(threaded[0], FramesToCV(projection, top, labels, device="cpu")(
        ca_system.coords), atol=1e-5)


def test_fes_logsumexp_on_workers_equals_a_sequential_loop(sequential):
    rng = np.random.default_rng(5)
    grid = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    samples = rng.standard_normal((1003, 2)).astype(np.float32)
    threaded, plain = _both(sequential, lambda: sharded_kde_logsumexp(grid, samples, 20.0, CPU4))
    _assert_equal(threaded, plain)


def test_tica_covariances_on_workers_equal_a_sequential_loop(sequential):
    x = np.random.default_rng(6).standard_normal((1001, 9)).astype(np.float32)
    threaded, plain = _both(sequential, lambda: sharded_covariances(x[:-3], x[3:], CPU4))
    _assert_equal(threaded, plain)


def test_streaming_htica_on_workers_equals_a_sequential_loop(sequential):
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.standard_normal((900, 16)), 0).astype(np.float32)
    x = (x - x.mean(0)) / x.std(0)

    def blocks():
        # a segment break, a block shorter than the lag, uneven blocks
        yield from (x[:300], None, x[300:302], x[302:650], x[650:])

    def fit():
        est = StreamingHTICA(16, 8, 2, 2, lag_time=3, device="cpu", mesh=CPU4)
        est.fit(blocks)
        return est.eigenvalues_, est.weights, est.level1

    threaded, plain = _both(sequential, fit)
    _assert_equal(threaded, plain)


def test_trainer_lanes_on_workers_equal_a_sequential_loop(sequential):
    """Four deep-TICA tries with dropout over the 4-entry mesh, a lane of
    one try a worker: metrics and parameters as the sequential loop's."""
    layers, options = (12, 16, 16, 2), {"activation": ["tanh", "tanh", None],
                                        "dropout": [0.1, 0.1, None]}
    seeds = [21, 22, 23, 24]
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((303, 12)), 0) * 0.1
    x = (np.sin(x) + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    full = {"data": x[:-3], "data_lag": x[3:]}
    orders = [np.random.default_rng(s).permutation(300) for s in seeds]
    train_idx = np.asarray([o[:240] for o in orders], np.int32)
    valid_idx = np.asarray([o[240:] for o in orders], np.int32)
    stack = DeepTICAStack(layers, options)
    params = stack.init(seeds)

    def fit():
        trainer = training.Trainer(
            make_deep_tica_loss(stack, 1e-6, 2),
            training.TrainerConfig(batch_size=64, max_epochs=3, early_stop_patience=50,
                                   optimizer_name="Adam", optimizer_kwargs={"lr": 1e-2}),
            device="cpu")
        with use_mesh(CPU4):
            assert trainer._lanes(4)[0] is CPU4
            results = trainer.fit_ensemble(params, full, train_idx, valid_idx, seeds)
        return [(r.metrics["train_loss"], r.metrics["valid_loss"], r.best_epoch,
                 [r.params[k] for k in sorted(r.params)]) for r in results]

    threaded, plain = _both(sequential, fit)
    _assert_equal(threaded, plain)


# ---------------------------------------------------------------------------
# The per-path default routing
# ---------------------------------------------------------------------------


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda reports four cards; the mesh module makes CUDA devices
    without one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(port_mesh, "resolve_device",
                        lambda device=None: torch.device("cuda" if device is None else device))


def test_with_four_cards_a_call_stays_on_its_device_unless_the_caller_sets_a_mesh(
        four_cards):
    cards = tuple(torch.device("cuda", i) for i in range(4))
    assert get_mesh().devices == cards
    for device in cards + (torch.device("cpu"),):
        assert port_mesh.mesh_for(device).devices == (device,)
    with use_mesh(get_mesh()) as mesh:
        assert port_mesh.mesh_for(cards[0]) is mesh
        # a call on another card than the mesh's first runs there alone
        assert port_mesh.mesh_for(cards[1]).devices == (cards[1],)


def test_with_four_cards_each_entry_point_runs_on_its_device(four_cards, monkeypatch):
    """The routing read where each sharded path takes its mesh: the
    statistics of a large host matrix, TICA's calculator, the trainer's
    lanes and the FES take the call's device alone."""
    monkeypatch.setattr("deep_cartograph_torch.utils.device.SMALL_WORK_ELEMENTS", 0)
    card = torch.device("cuda", 0)
    assert descriptors._feature_mesh(np.zeros((10, 4), np.float32), card).devices == (card,)
    trainer = training.Trainer(lambda *a: None, training.TrainerConfig(), device="cpu")
    trainer.device = card
    mesh, lanes = trainer._lanes(4)
    assert mesh.devices == (card,) and [lane.tries for lane in lanes] == [slice(0, 4)]
