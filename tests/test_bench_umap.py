"""The benchmark's UMAP cell: its manifest entries found by name, the counts
of a fit's operations and bytes against hand counts, the cell's readers on
hand-built contexts, and `correct` on the CPU at a tiny size: the program
passes, its control and each planted fault do not, whether the fault is
planted in the program or in the reference put in its place, with and
without the program's counter."""

import copy

import numpy as np
import pytest
import torch

from carto_bench import counts_umap
from carto_bench.control_faults import readings
from carto_bench.harness import (Cell, Context, Trace, Window, judge, load_module, reader_path,
                                 run_window)
from deep_cartograph_torch.cv import umap_cv
from deep_cartograph_torch.cv.umap_cv import UMAPModel

UMAP_CELL = "lambda80_umap.train_umap"
SEED = 2**31 + 9876   # wider than 32 signed bits, as a run's seed may be
UMAP_METRICS = ["train_mfu.train_umap", "knn_roofline.train_umap",
                "layout_roofline.train_umap", "symmetrize_share.train_umap",
                "idle_share.train_umap"]
PEAKS = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def tiny(workload: str, frames: int = 1000) -> Cell:
    """The cell at 8 residues (31 features) and `frames` frames."""
    cell = Cell.find(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["molecule"]["residues"] = 8
    cell.config["frames"] = frames
    return cell


def test_the_umap_cell_is_found_by_name():
    cell = Cell.find(UMAP_CELL)
    assert cell.chips == cell.config["chips"] == 1 and cell.mix["job"] == "train_umap"
    assert (cell.config["frames"], cell.config["features"]["n_features"]) == (100000, 3235)
    assert cell.config["reduced"] == ["frames"]
    assert {m["name"] for m in cell.per_layer} == set(UMAP_METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "setup_s"}
    assert all(reader_path(m["name"]).is_file() for m in cell.per_layer)
    assert reader_path("idle_share.train_umap").name == "idle_share.py"
    assert set(cell.limits) == {"knn_excess_of_bound", "knn_dist_gap", "graph_edge_mismatch",
                                "graph_weight_gap", "pca_init_scaled_gap", "early_epochs_gap",
                                "last_epoch_gap", "cv_gap", "epochs_off", "nonfinite_rows"}
    for exact in ("graph_edge_mismatch", "epochs_off", "nonfinite_rows"):
        assert cell.limits[exact]["limit"] == 0
    # the float32 bound of the d2 expansion itself
    assert cell.limits["knn_excess_of_bound"]["limit"] == 1.0


def test_the_umap_cell_s_configuration_resolves_as_it_states():
    cell = Cell.find(UMAP_CELL)
    job = cell.job_module()
    cfg = job.calculator_config(cell.config)
    calc = umap_cv.UMAP(cfg, device="cpu")
    assert job.resolved_settings(cell.config, calc) == cell.config["umap_resolved"]
    assert (calc.n_neighbors, calc.min_dist, calc.metric, calc.seed) == (15, 0.1, "euclidean", 42)
    assert (calc.cv_dimension, calc.feats_norm_mode) == (2, "mean_std")
    stated = copy.deepcopy(cell.config)
    stated["umap_resolved"]["n_neighbors"] = 10
    with pytest.raises(RuntimeError, match="n_neighbors"):
        job.resolved_settings(stated, calc)


def test_counts_against_a_hand_count():
    """n = 3 points of d = 2 features, k = 1, c = 2 components, E = 4
    edges, N = 1 negative sample, 2 epochs."""
    assert counts_umap.knn_flops(3, 3, 2) == 2 * 3 * 3 * 2
    # data 3 x 2 floats read, 3 rows x 1 neighbour of a float and an index
    assert counts_umap.knn_bytes(3, 2, 1) == 24 + 24
    assert counts_umap.pca_flops(3, 2) == 24
    # an edge: 7c + 6 = 20, its negative 5c + 6 = 16
    assert counts_umap.layout_epoch_flops(4, 2, 1) == 4 * 36
    # the graph: 4 x (4 + 4 + 4); the embedding read and written: 2 x 3 x 2 x 4
    assert counts_umap.layout_epoch_bytes(3, 4, 2) == 48 + 48
    assert counts_umap.fit_flops(3, 2, 2, 4, 2, 1) == 36 + 24 + 2 * 144
    # the cell's kNN is bound by its operations: 6.5e13 against 1.3 GB
    assert counts_umap.knn_roofline_s(100000, 3235, 15, PEAKS) == pytest.approx(
        2 * 100000 ** 2 * 3235 / 67e12)
    assert counts_umap.knn_roofline_s(10, 3235, 15, PEAKS) == pytest.approx(
        (10 * 3235 * 4 + 10 * 15 * 8) / 3.35e12)


class FakeJob:
    """What the UMAP cell's readers read of its job."""

    settings = {"dimension": 2, "negative_samples": 5, "n_neighbors": 15}
    epochs_per_fit = 300

    def __init__(self, by_span, epochs=300, edges=2_500_000):
        self.x = np.zeros((100000, 3235), np.float32)
        self.record = {"heads": np.zeros(edges)}
        self.profiled = {"by_span": by_span, "epochs": epochs, "edges": edges}
        self.profiled_calls = []

    def profiled_call(self, first_call):
        self.profiled_calls.append(first_call)
        return self.profiled


def context(job, peaks=PEAKS, spans=()):
    window = Window(calls=[{"work": {"steps": 300, "fits": 1}}] * 4, seconds=14.0)
    trace = Trace([], [{"name": "bench.call", "ts": 0.0, "dur": 1000.0}] + list(spans),
                  0.0, 1000.0, work=[{}])
    return Context(job, window, trace, peaks)


def read(metric, ctx):
    return load_module(reader_path(metric)).read(ctx)


def test_the_umap_readers_on_a_hand_built_context():
    job = FakeJob({"umap.knn": 2.0e6, "umap.layout": 300 * 1600.0, "outside any span": 5.0})
    ctx = context(job, spans=[{"name": "umap.symmetrize", "ts": 100.0, "dur": 70.0},
                              {"name": "umap.symmetrize", "ts": 150.0, "dur": 50.0}])
    flops = counts_umap.fit_flops(100000, 3235, 2, 2_500_000, 300, 5)
    assert read("train_mfu.train_umap", ctx) == pytest.approx(100 * flops / 3.5 / 67e12)
    knn = read("knn_roofline.train_umap", ctx)
    assert knn["value"] == pytest.approx(100 * 2 * 1e10 * 3235 / 67e12 / 2.0)
    assert knn["device_ms"] == pytest.approx(2000.0) and knn["value"] < 100
    layout = read("layout_roofline.train_umap", ctx)
    want_us = 1e6 * (2_500_000 * 12 + 2 * 100000 * 2 * 4) / 3.35e12
    assert layout == {"value": pytest.approx(100 * want_us / 1600.0),
                      "us_per_epoch": pytest.approx(1600.0), "edges": 2_500_000}
    # the union of [100, 170] and [150, 200] over a 1,000 us window
    assert read("symmetrize_share.train_umap", ctx) == pytest.approx(10.0)
    # both span readers share the job's one profiled call, after the window's
    # and the trace's calls
    assert job.profiled_calls == [5, 5]


def test_the_umap_readers_give_nothing_on_a_program_without_spans_or_counter():
    bare = context(FakeJob({"outside any span": 9.0e6}, epochs=None))
    for metric in ("knn_roofline.train_umap", "layout_roofline.train_umap",
                   "symmetrize_share.train_umap"):
        assert read(metric, bare) is None, metric
    no_counter = context(FakeJob({"umap.knn": 1.0, "umap.layout": 1.0}, epochs=None))
    assert read("layout_roofline.train_umap", no_counter) is None
    for metric in ("train_mfu.train_umap", "knn_roofline.train_umap"):
        assert read(metric, context(FakeJob({"umap.knn": 1.0}), peaks=None)) is None


def test_the_umap_cell_passes_and_its_control_and_faults_do_not():
    got = readings(tiny(UMAP_CELL), SEED, 0.2, "cpu")
    assert got["program_correct"] and got["calls"] >= 1
    assert got["program"]["epochs_off"] == got["program"]["nonfinite_rows"] == 0
    for side in ("control", "fault_no_repulsion", "fault_k_minus_1", "fault_w_not_union",
                 "fault_half_epochs"):
        assert not got[f"{side}_correct"], side
    assert got["fault_half_epochs"]["epochs_off"] == 150
    assert got["fault_w_not_union"]["graph_edge_mismatch"] > 0


def run_tiny(seed: int, counter: bool = True):
    """A run of the tiny UMAP cell as the harness makes it (a window of
    0.2 s, then the check), on a program with or without the counter:
    `judge`'s (correct, compared) and the calls made."""
    cell = tiny(UMAP_CELL)
    job_module = cell.job_module()
    if not counter:
        job_module.umap_stats = lambda: None
    job = job_module.Job(cell.config, cell.mix, seed, "cpu")
    window = run_window(job, 0.2, lambda: None)
    job.release()
    failed = sum(1 for c in window.calls if c["work"]["failed"])
    correct, compared = judge(job.check(), cell.limits, failed)
    return correct, {c["name"]: c for c in compared}, len(window.calls)


@pytest.mark.parametrize("seed", [SEED + 1, 2**31 + 54321])
@pytest.mark.parametrize("counter", [True, False])
def test_the_umap_cell_is_correct_with_and_without_the_counter(counter, seed):
    correct, compared, calls = run_tiny(seed, counter)
    assert correct and calls >= 1
    assert compared["epochs_off"]["value"] == 0


def plant(monkeypatch, fault):
    """A fault in the program itself."""
    if fault == "no_repulsion":
        real = umap_cv.layout_epoch

        def bare(emb, heads, tails, weights, uniform, negatives, alpha, a, b):
            # each head's negative samples are itself: no push
            return real(emb, heads, tails, weights, uniform,
                        heads[:, None].expand_as(negatives), alpha, a, b)

        monkeypatch.setattr(umap_cv, "layout_epoch", bare)
    elif fault == "k_minus_1":
        real_knn = umap_cv._knn
        monkeypatch.setattr(umap_cv, "_knn", lambda data, queries, k, *rest:
                            real_knn(data, queries, k - 1, *rest))
    elif fault == "w_not_union":
        def w_only(idx, w, n):
            return (np.repeat(np.arange(n), idx.shape[1]), idx.reshape(-1).astype(np.int64),
                    w.reshape(-1).astype(np.float32))

        monkeypatch.setattr(umap_cv, "_symmetrize", w_only)
    else:
        layout = UMAPModel.layout

        def half(self, *args, **kwargs):
            self.n_epochs //= 2
            return layout(self, *args, **kwargs)

        monkeypatch.setattr(UMAPModel, "layout", half)


@pytest.mark.parametrize("fault, failing", [
    ("no_repulsion", "early_epochs_gap"), ("k_minus_1", "knn_excess_of_bound"),
    ("w_not_union", "graph_edge_mismatch"), ("half_epochs", "epochs_off")])
@pytest.mark.parametrize("counter", [True, False])
def test_a_fault_planted_in_the_program_turns_correct_false(monkeypatch, fault, failing,
                                                            counter):
    plant(monkeypatch, fault)
    correct, compared, _ = run_tiny(SEED + 2, counter)
    assert not correct
    assert compared[failing]["value"] > compared[failing]["limit"]


def test_the_job_s_profiled_call_gives_device_time_by_span_and_the_counter_s_epochs():
    """On the CPU the profiler records no device operation: the call is
    made and counted, and the span readers find nothing to read."""
    cell = tiny(UMAP_CELL, 600)
    job = cell.job_module().Job(cell.config, cell.mix, SEED + 3, "cpu")
    profiled = job.profiled_call(1)
    assert profiled["epochs"] == 300 and profiled["edges"] == len(job.record["heads"])
    assert job.profiled_call(2) is profiled and job.calls == 1
    assert not any(k.startswith("umap.") for k in profiled["by_span"])
    assert torch.is_tensor(job.record["init"])
