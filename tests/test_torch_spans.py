"""The port's spans (`utils/profiling.py::annotate`) at the layer
boundaries of featurize, serve and the trainer, read from the Chrome trace
of a `torch.profiler` session as the benchmark reads them, on the CPU."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_cartograph_torch.cv.deep import DeepTICACalculator
from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.xtc import write_xtc
from deep_cartograph_torch.utils import profiling
from tests.test_cv import base_config

LABELS = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_11",
          "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_1-@CA_2-@CA_3-@CA_4"]
PACKAGE = Path(__file__).resolve().parents[1] / "deep_cartograph_torch"


def traced_spans(fn, tmp_path):
    """fn() under torch.profiler; (its result, the spans of the exported
    trace: name, start, end, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [{"name": e["name"], "a": float(e["ts"]), "b": float(e["ts"]) + float(e["dur"]),
              "tid": e["tid"]} for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def of(spans, name):
    return [s for s in spans if s["name"] == name]


def inside(inner, outer) -> bool:
    return inner["tid"] == outer["tid"] and outer["a"] <= inner["a"] and inner["b"] <= outer["b"]


def each_inside(spans, name, parent):
    """Every span of `name` lies in some span of `parent`."""
    return bool(of(spans, name)) and all(
        any(inside(s, p) for p in of(spans, parent)) for s in of(spans, name))


def test_annotate_enters_record_function_only_while_profiling(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)

    @profiling.annotate("test.decorated")
    def decorated():
        with profiling.annotate("test.inner"):
            return 7

    assert decorated() == 7 and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert decorated() == 7
    assert entered == ["test.decorated", "test.inner"]
    assert decorated() == 7 and len(entered) == 2


def test_annotate_closes_its_span_on_an_exception(tmp_path):
    def fail():
        with profiling.annotate("test.failing"):
            raise ValueError("inside")

    def run():
        with pytest.raises(ValueError):
            fail()
        with profiling.annotate("test.after"):
            pass

    _, spans = traced_spans(run, tmp_path)
    failing, after = of(spans, "test.failing"), of(spans, "test.after")
    assert len(failing) == 1 and len(after) == 1 and failing[0]["b"] <= after[0]["a"]


def test_only_annotate_enters_record_function():
    """Every span of the port goes through `annotate`: no other module of
    the package calls record_function."""
    users = sorted(str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == [os.path.join("utils", "profiling.py")]


@pytest.mark.parametrize("fmt", ["dcd", "xtc"])
def test_featurize_trajectory_spans(ca_system, tmp_path, fmt):
    featurizer = Featurizer(Topology.from_pdb(ca_system.pdb_path), LABELS, device="cpu")
    path = ca_system.dcd_path
    if fmt == "xtc":
        path = str(tmp_path / "traj.xtc")
        write_xtc(path, ca_system.coords)
    chunk = 16
    out, spans = traced_spans(
        lambda: featurizer.featurize_trajectory(path, frame_chunk=chunk), tmp_path)
    chunks = -(-len(ca_system.coords) // chunk)
    assert out.shape == (len(ca_system.coords), len(LABELS))
    assert len(of(spans, "featurize.trajectory")) == 1
    assert len(of(spans, "transfer.h2d")) == len(of(spans, "features.eval")) == chunks
    # one wait a chunk, and the call that finds the file's end
    assert len(of(spans, "io.next_chunk")) == chunks + 1
    # one copy back a chunk, through the download ring
    assert len(of(spans, "transfer.d2h")) == chunks
    for name in ("io.next_chunk", "transfer.h2d", "features.eval", "transfer.d2h"):
        assert each_inside(spans, name, "featurize.trajectory"), name
    # the reader's span closes before its chunk is handed over
    assert not any(inside(h, w) for h in of(spans, "transfer.h2d")
                   for w in of(spans, "io.next_chunk"))


def test_streaming_featurize_spans(ca_system, tmp_path):
    featurizer = Featurizer(Topology.from_pdb(ca_system.pdb_path), LABELS, device="cpu")
    paths = [ca_system.dcd_path, ca_system.dcd_path]
    out, spans = traced_spans(
        lambda: featurizer.featurize_trajectories(paths, frame_chunk=16), tmp_path)
    chunks = -(-2 * len(ca_system.coords) // 16)
    assert [len(o) for o in out] == [len(ca_system.coords)] * 2
    assert len(of(spans, "transfer.h2d")) == len(of(spans, "transfer.d2h")) == chunks
    assert of(spans, "io.next_chunk") and of(spans, "features.eval")
    assert not any(inside(h, w) for h in of(spans, "transfer.h2d")
                   for w in of(spans, "io.next_chunk"))


def test_frames_to_cv_spans(ca_system, tmp_path):
    n, dim = len(LABELS), 2
    rng = np.random.default_rng(0)
    projection = LinearProjection(np.zeros(n), np.ones(n), rng.normal(size=(n, dim)),
                                  np.zeros(dim), np.ones(dim))
    pipeline = FramesToCV(projection, Topology.from_pdb(ca_system.pdb_path), LABELS,
                          device="cpu")
    calls = 3
    out, spans = traced_spans(
        lambda: [pipeline(ca_system.coords[:20 + k]) for k in range(calls)], tmp_path)
    assert [len(o) for o in out] == [20, 21, 22]
    assert len(of(spans, "serve.call")) == calls
    for name in ("transfer.h2d", "features.eval", "serve.project", "transfer.d2h"):
        assert len(of(spans, name)) == calls and each_inside(spans, name, "serve.call"), name
    for call in of(spans, "serve.call"):
        order = sorted((s for s in spans if s is not call and inside(s, call)),
                       key=lambda s: s["a"])
        assert [s["name"] for s in order] == ["transfer.h2d", "features.eval",
                                              "serve.project", "transfer.d2h"]


def test_deep_tica_train_spans(ca_system, tmp_path):
    features = Featurizer(Topology.from_pdb(ca_system.pdb_path), LABELS,
                          device="cpu").featurize_trajectory(ca_system.dcd_path)
    cfg = base_config()
    cfg["training"]["general"].update({"num_tries": 2, "max_epochs": 1, "batch_size": 16})
    calc = DeepTICACalculator(configuration=cfg, device="cpu")
    calc._set_training_data(features, np.zeros(len(features)), LABELS)
    n_train = int((len(features) - cfg["lag_time"]) * calc.training_validation_lengths[0])
    steps = -(-n_train // calc.batch_size)
    trained, spans = traced_spans(calc.train, tmp_path)
    assert trained
    assert len(of(spans, "cv.train")) == len(of(spans, "trainer.fit")) == 1
    assert len(of(spans, "cv.finalize")) == len(of(spans, "trainer.place")) == 1
    assert len(of(spans, "trainer.step")) == steps
    assert len(of(spans, "trainer.validate")) == 1
    for name in ("trainer.fit", "cv.finalize"):
        assert each_inside(spans, name, "cv.train"), name
    for name in ("trainer.place", "trainer.epoch_setup", "trainer.step", "trainer.validate"):
        assert each_inside(spans, name, "trainer.fit"), name
    assert of(spans, "cv.finalize")[0]["a"] >= of(spans, "trainer.fit")[0]["b"]
    children = ("trainer.forward", "trainer.backward", "trainer.optimizer")
    for step in of(spans, "trainer.step"):
        within = [s["name"] for s in sorted(spans, key=lambda s: s["a"])
                  if s is not step and inside(s, step)]
        assert within == list(children)
