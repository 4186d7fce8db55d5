"""The benchmark's span arithmetic (`carto_bench/spans.py`) and the readers
of the program's spans, on hand-built traces: the numbers each gives, and
nothing where the program has no such span."""

import json

import pytest

from carto_bench import spans
from carto_bench.harness import Context, Trace, Window, load_module, reader_path

SPAN_METRICS = ["decode_wait_share.featurize", "d2h_wait_share.featurize",
                "upload_wait_share.serve", "step_host_ms.train", "fit_fixed_ms.train"]


def span(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def trace(program_spans, start=100.0, end=1100.0, calls=1):
    """A window of 1,000 us from two harness call spans, with the program's
    spans beside them."""
    harness = [span("bench.call", start, 400), span("bench.call", start + 400, end - start - 400)]
    return Trace([], harness + program_spans, start, end, work=[{}] * calls)


def read(metric, tr, job=None, window=None):
    return load_module(reader_path(metric)).read(Context(job, window or Window(), tr, None))


def test_union_clips_to_the_window_and_counts_overlaps_once():
    s = [span("x", 50, 100), span("x", 120, 30), span("x", 140, 60), span("x", 400, 10),
         span("x", 1050, 100)]
    # [100, 150] + [150, 200] (overlap counted once) + [400, 410] + [1050, 1100]
    assert spans.union_us(s, 100, 1100) == pytest.approx(50 + 50 + 10 + 50)
    assert spans.union_us([], 0, 10) == 0.0


def test_window_share_and_named():
    tr = trace([span("io.next_chunk", 100, 100), span("io.next_chunk", 150, 100),
                span("io.next_chunk", 1090, 50), span("io.next_chunk", 2000, 5)])
    assert spans.window_share(tr, "io.next_chunk") == pytest.approx(100.0 * 160 / 1000)
    assert spans.window_share(tr, "transfer.d2h") is None
    assert len(spans.named(tr, "io.next_chunk")) == 3


@pytest.mark.parametrize("metric, name", [
    ("decode_wait_share.featurize", "io.next_chunk"),
    ("d2h_wait_share.featurize", "transfer.d2h"),
    ("upload_wait_share.serve", "transfer.h2d"),
])
def test_wait_shares(metric, name):
    tr = trace([span(name, 200, 150), span(name, 300, 100), span("other.span", 500, 300)])
    assert read(metric, tr) == pytest.approx(20.0)


def test_step_host_ms_is_the_mean_step_with_its_count():
    tr = trace([span("trainer.fit", 100, 900), span("trainer.step", 200, 100),
                span("trainer.step", 300, 300), span("trainer.step", 5000, 900)])
    assert read("step_host_ms.train", tr) == {"value": pytest.approx(0.2), "n": 2}


def test_fit_fixed_ms_is_fit_less_its_steps_per_call():
    tr = trace([span("trainer.fit", 100, 400), span("trainer.step", 150, 100),
                span("trainer.fit", 600, 450), span("trainer.step", 700, 50),
                span("trainer.step", 800, 50)], calls=2)
    assert read("fit_fixed_ms.train", tr) == pytest.approx((850 - 200) / 2 / 1e3)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_give_nothing_without_the_program_s_spans(metric):
    assert read(metric, trace([])) is None


def chrome_events():
    """Two host threads and a card: spans, launches by correlation id,
    and the kernels, copies and sets they launched."""
    host, other = {"pid": 1, "tid": 10}, {"pid": 1, "tid": 11}
    card = {"pid": 0, "tid": 7}

    def x(cat, name, ts, dur, where, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **where,
                "args": args}

    return [
        x("user_annotation", "serve.call", 0, 100, host),
        x("user_annotation", "serve.project", 40, 20, host),
        x("user_annotation", "bench.other", 0, 100, other),
        x("cuda_runtime", "cudaMemcpyAsync", 5, 3, host, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 45, 2, host, correlation=2),
        x("cuda_driver", "cuLaunchKernel", 50, 2, host, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 45, 2, other, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 150, 2, host, correlation=5),
        x("gpu_memcpy", "Memcpy HtoD", 10, 30, card, correlation=1),
        x("kernel", "gemm", 60, 8, card, correlation=2),
        x("kernel", "elementwise", 70, 4, card, correlation=3),
        x("gpu_memset", "Memset", 75, 1, card, correlation=4),
        x("kernel", "late", 160, 6, card, correlation=5),
        x("kernel", "unlaunched", 170, 9, card, correlation=99),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 60, "pid": 0, "tid": 7},
    ]


def test_device_time_goes_to_the_innermost_span_of_the_launching_thread():
    assert spans.device_us_by_span(chrome_events()) == {
        "serve.call": 30.0, "serve.project": 12.0, "bench.other": 1.0,
        spans.OUTSIDE: 15.0}


class FakeServeJob:
    """What the reader needs of the serve job: its device, mix and calls."""

    device = "cpu"
    mix = {"trace_calls": 3}

    def __init__(self):
        self.calls = []

    def call(self, i):
        self.calls.append(i)
        return {"frames": 1000}


def test_project_device_ns_per_frame(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    module = load_module(reader_path("project_device_ns_per_frame.serve"))
    monkeypatch.setattr(module, "load_events", lambda path: chrome_events())
    job = FakeServeJob()
    window = Window(calls=[{}] * 5)
    tr = trace([], calls=2)
    got = module.read(Context(job, window, tr, None))
    # 12 us of device time under serve.project over 3,000 frames
    assert got == {"value": pytest.approx(4.0), "frames": 3000}
    assert job.calls == [7, 8, 9] and list(tmp_path.iterdir()) == []


def test_project_device_ns_per_frame_without_the_span(monkeypatch):
    module = load_module(reader_path("project_device_ns_per_frame.serve"))
    events = [e for e in chrome_events() if e["name"] != "serve.project"]
    monkeypatch.setattr(module, "load_events", lambda path: events)
    assert module.read(Context(FakeServeJob(), Window(), trace([]), None)) is None


def test_load_events_keeps_complete_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": chrome_events()}))
    assert len(spans.load_events(str(path))) == len(chrome_events()) - 1
