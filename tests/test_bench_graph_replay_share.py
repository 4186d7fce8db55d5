"""The reader of the trainer's replay counter
(`carto_bench/metrics/graph_replay_share.train.py`) on a hand-built
counter: the share it gives over its own call, the counter read by
difference and never reset, and nothing where the program has no such
counter or the call ran no step."""

import pytest

from carto_bench.harness import Context, Trace, Window, load_module, reader_path
from deep_cartograph_torch.models import training
from deep_cartograph_torch.models.training import TrainStats

METRIC = "graph_replay_share.train"


class FakeTrainJob:
    """A train job whose calls count one epoch of `steps` steps on the
    given counter, the first EAGER_STEPS of the fit eager, one capture."""

    def __init__(self, stats, steps=304):
        self.stats, self.steps, self.calls = stats, steps, []

    def call(self, i):
        self.calls.append(i)
        replayed = max(self.steps - training.EAGER_STEPS, 0)
        self.stats.count_epoch(self.steps, 0.0, None, replayed, int(replayed > 0))
        return {"steps": self.steps, "failed": False}


def read(job):
    trace = Trace([], [], 0.0, 1.0, work=[{}])
    return load_module(reader_path(METRIC)).read(Context(job, Window(calls=[{}] * 5),
                                                         trace, None))


def test_replayed_steps_over_steps_of_the_reader_s_own_call(monkeypatch):
    stats = TrainStats(steps=1000, plateau_steps=1000, replayed_steps=7, captures=9,
                       post_annealing_selections=4)
    monkeypatch.setattr(training, "TRAIN_STATS", stats)
    job = FakeTrainJob(stats)
    got = read(job)
    assert job.calls == [6]
    assert got == {"value": pytest.approx(100.0 * 301 / 304), "steps": 304, "captures": 1}
    # read by difference: what the cell's own check counts is left whole
    assert (stats.steps, stats.replayed_steps, stats.captures,
            stats.post_annealing_selections) == (1304, 308, 10, 4)


def test_nothing_without_the_counter_or_a_step(monkeypatch):
    monkeypatch.delattr(training, "TRAIN_STATS")
    job = FakeTrainJob(TrainStats())
    assert read(job) is None and job.calls == []

    class OlderStats:
        """A counter from before the replays: steps only."""
        steps = plateau_steps = post_annealing_selections = 0

    monkeypatch.setattr(training, "TRAIN_STATS", OlderStats(), raising=False)
    job = FakeTrainJob(OlderStats())
    assert read(job) is None and job.calls == []
    stats = TrainStats()
    monkeypatch.setattr(training, "TRAIN_STATS", stats)
    assert read(FakeTrainJob(stats, steps=0)) is None
