"""The reader of the program's upload counter
(`carto_bench/metrics/upload_bytes_per_frame.serve.py`) on a hand-built
counter: the number it gives, and nothing where the program has no such
counter or staged no frame."""

import pytest

from carto_bench.harness import Context, Trace, Window, load_module, reader_path
from deep_cartograph_torch.geom import kernels
from deep_cartograph_torch.geom.transport import UploadStats

METRIC = "upload_bytes_per_frame.serve"


class FakeServeJob:
    """A serve job whose calls stage frames on the given counter: `per_call`
    frames in chunks of 1,000, 960 bytes of 3,840 a frame sent, one chunk
    of the second call waiting for its slot."""

    mix = {"trace_calls": 3}

    def __init__(self, stats, per_call=2500):
        self.stats, self.per_call, self.calls = stats, per_call, []

    def call(self, i):
        self.calls.append(i)
        self.stats.count_call()
        for a in range(0, self.per_call, 1000):
            n = min(1000, self.per_call - a)
            self.stats.count_chunk(n, 960 * n, 3840 * n, waited=(i == 8 and a == 0))
        return {"frames": self.per_call}


def read(job):
    trace = Trace([], [], 0.0, 1.0, work=[{}] * 2)
    return load_module(reader_path(METRIC)).read(Context(job, Window(calls=[{}] * 5),
                                                         trace, None))


def test_bytes_sent_a_frame_over_the_reader_s_own_calls(monkeypatch):
    stats = UploadStats(calls=4, chunks=9, frames=123, bytes_sent=10**9, bytes_held=7,
                        slot_waits=5)
    monkeypatch.setattr(kernels, "UPLOAD_STATS", stats)
    job = FakeServeJob(stats)
    got = read(job)
    # reset first: only the three calls after the window and the traced ones
    assert job.calls == [7, 8, 9]
    assert got == {"value": pytest.approx(960.0), "held_bytes_per_frame": pytest.approx(3840.0),
                   "frames": 7500, "chunks": 9, "slot_waits": 1}
    assert stats.calls == 3


def test_nothing_without_the_counter_or_a_staged_frame(monkeypatch):
    monkeypatch.delattr(kernels, "UPLOAD_STATS")
    job = FakeServeJob(UploadStats())
    assert read(job) is None and job.calls == []
    stats = UploadStats()
    monkeypatch.setattr(kernels, "UPLOAD_STATS", stats, raising=False)
    assert read(FakeServeJob(stats, per_call=0)) is None


def test_the_counter_resets_and_counts_under_its_lock():
    stats = UploadStats()
    stats.count_call()
    stats.count_chunk(10, 100, 400, waited=True)
    stats.count_chunk(5, 50, 200, waited=False)
    assert (stats.calls, stats.chunks, stats.frames, stats.bytes_sent, stats.bytes_held,
            stats.slot_waits) == (1, 2, 15, 150, 600, 1)
    stats.reset()
    assert stats == UploadStats()
