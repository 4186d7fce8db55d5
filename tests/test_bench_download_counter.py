"""The reader of the program's download counter
(`carto_bench/metrics/d2h_slot_waits_per_chunk.featurize.py`) on a
hand-built counter: the number it gives, and nothing where the program has
no such counter or sent no chunk down; and the counter's own arithmetic."""

import pytest

from carto_bench.harness import Context, Trace, Window, load_module, reader_path
from deep_cartograph_torch.geom import engine
from deep_cartograph_torch.geom.transport import DownloadStats

METRIC = "d2h_slot_waits_per_chunk.featurize"


class FakeFeaturizeJob:
    """A featurize job whose calls send `per_call` chunks of 1,000 bytes
    down on the given counter, a piece each, the second call's first two
    pieces waited for."""

    mix = {"trace_calls": 2}

    def __init__(self, stats, per_call=49):
        self.stats, self.per_call, self.calls = stats, per_call, []

    def call(self, i):
        self.calls.append(i)
        for c in range(self.per_call):
            self.stats.count_chunk(1000, 1)
            self.stats.count_take(waited=(i == 5 and c < 2))
        return {"frames": 2048 * self.per_call}


def read(job):
    trace = Trace([], [], 0.0, 1.0, work=[{}] * 2)
    return load_module(reader_path(METRIC)).read(Context(job, Window(calls=[{}] * 2),
                                                         trace, None))


def test_waits_a_chunk_over_the_reader_s_own_calls(monkeypatch):
    stats = DownloadStats(chunks=7, bytes=10**9, pieces=8, slot_waits=5)
    monkeypatch.setattr(engine, "DOWNLOAD_STATS", stats)
    job = FakeFeaturizeJob(stats)
    got = read(job)
    # reset first: only the two calls after the window and the traced ones
    assert job.calls == [4, 5]
    assert got == {"value": pytest.approx(2 / 98), "chunks": 98, "pieces": 98,
                   "bytes": 98_000}


def test_nothing_without_the_counter_or_a_chunk(monkeypatch):
    monkeypatch.delattr(engine, "DOWNLOAD_STATS")
    job = FakeFeaturizeJob(DownloadStats())
    assert read(job) is None and job.calls == []
    stats = DownloadStats()
    monkeypatch.setattr(engine, "DOWNLOAD_STATS", stats, raising=False)
    assert read(FakeFeaturizeJob(stats, per_call=0)) is None


def test_the_counter_resets_and_counts_under_its_lock():
    stats = DownloadStats()
    stats.count_chunk(400, 3)
    stats.count_chunk(100, 1)
    for waited in (True, False, True, False):
        stats.count_take(waited)
    assert (stats.chunks, stats.bytes, stats.pieces, stats.slot_waits) == (2, 500, 4, 2)
    stats.reset()
    assert stats == DownloadStats()
