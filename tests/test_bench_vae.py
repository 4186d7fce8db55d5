"""The benchmark's VAE cell and `lambda80.train`: the manifest entries found
by name, the VAE step's operation count against a hand count, the cell's
readers on hand-built traces, and `correct` on the CPU at a tiny size: the
program passes, its control and each planted fault do not, whether the
fault is planted in the program or in the reference put in its place."""

import copy

import pytest
import torch

from carto_bench import counts_vae
from carto_bench.control_faults import readings
from carto_bench.harness import (Cell, Context, Trace, Window, judge, load_module, reader_path,
                                 run_window)
from deep_cartograph_torch.cv.deep import VAECalculator
from deep_cartograph_torch.models import networks, training

VAE_CELL = "lambda80_vae.train_vae"
SEED = 2**31 + 4321   # wider than 32 signed bits, as a run's seed may be
VAE_METRICS = ["elbo_device_us_per_step.train_vae", "train_mfu.train_vae",
               "host_syncs_per_step.train", "idle_share.train", "step_host_ms.train",
               "fit_fixed_ms.train", "graph_replay_share.train"]
TRAIN_METRICS = ["train_mfu", "host_syncs_per_step.train", "idle_share.train",
                 "step_host_ms.train", "fit_fixed_ms.train", "graph_replay_share.train"]


def tiny(workload: str) -> Cell:
    """The cell at 8 residues (31 features) and 3,000 frames."""
    cell = Cell.find(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["molecule"]["residues"] = 8
    cell.config["frames"] = 3000
    return cell


@pytest.mark.parametrize("workload, job, metrics", [
    (VAE_CELL, "train_vae", VAE_METRICS), ("lambda80.train", "train", TRAIN_METRICS)])
def test_the_new_cells_are_found_by_name(workload, job, metrics):
    cell = Cell.find(workload)
    assert cell.chips == cell.config["chips"] == 1 and cell.mix["job"] == job
    assert cell.config["features"]["n_features"] == 3235
    assert {m["name"] for m in cell.per_layer} == set(metrics)
    assert {m["name"] for m in cell.end_to_end} == {"train_step_ms", "setup_s"}
    assert all(reader_path(m["name"]).is_file() for m in cell.per_layer)
    assert hasattr(cell.job_module(), "Job")
    if job == "train_vae":
        # the loss is left out, its parts compared (PERF.md §2)
        assert set(cell.limits) == {"recon_gap", "kl_gap", "grad_gap", "change_median_gap",
                                    "valid_recon_gap", "valid_kl_gap", "cv_gap",
                                    "beta_off_steps", "calls_without_selection"}
        assert cell.limits["beta_off_steps"]["limit"] == 0
        assert cell.limits["calls_without_selection"]["limit"] == 0
    else:
        # the accepted train cell's numbers, each limit set from this cell's
        # own readings (PERF.md §2)
        assert set(cell.limits) == set(Cell.find("villin35.train").limits)


def test_the_vae_cell_s_configuration_resolves_as_it_states():
    cell = Cell.find(VAE_CELL)
    cfg = cell.job_module().calculator_config(cell.config, 1)
    kl = cfg["training"]["kl_annealing"]
    assert (kl["start_epoch"], kl["n_epochs_anneal"], kl["max_beta"]) == (-2000, 2000, 0.01)
    assert cfg["training"]["general"]["max_epochs"] == 1
    calc = VAECalculator(cfg, device="cpu")
    assert calc.encoder_hidden_layers == [32, 16, 8] and calc.decoder_hidden_layers == [4, 8]
    assert (calc.num_tries, calc.batch_size, calc.feats_norm_mode) == (1, 128, None)


@pytest.mark.parametrize("batch, tries", [(1, 1), (2, 3)])
def test_vae_step_flops_against_a_hand_count(batch, tries):
    """F = 3, encoder [3, 2] with dropout, heads 2 -> 1, decoder [1, 3],
    normalized. A row's forward: 6 (norm) + 20 (dense 12, bias and
    activation 4, dropout 4) + 10 (two heads of 4 + 1) + 4 (sample) + 12
    (dense 6, bias and activation 6) + 9 (reconstruction) + 6 (KL) = 67;
    backward: 2 x 26 products - 12 (the first layer's input gradient) + 35
    (67 - 26 - 6, element-wise once more) = 75; Adam: 12 x 20 parameters."""
    got = counts_vae.vae_step_flops(batch, tries, [3, 2], 1, [1, 3], 1, 0, True)
    assert got == tries * (batch * (67 + 75) + 240)
    assert counts_vae.vae_step_flops(1, 1, [3, 2], 1, [1, 3], 1, 0, False) == 382 - 6


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def kernel(dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def test_elbo_device_time_a_step_by_span_leaves_out_validation():
    per_step = load_module(reader_path("elbo_device_us_per_step.train_vae")).per_step
    events = [span("trainer.forward", 0, 100), span("vae.encode", 0, 10),
              span("vae.sample", 10, 10), span("vae.decode", 20, 10), span("vae.elbo", 30, 10),
              launch(1, 1), launch(11, 2), launch(21, 3), launch(31, 4), launch(50, 5),
              span("trainer.validate", 200, 100), span("vae.encode", 200, 50), launch(210, 6),
              kernel(8, 1), kernel(2, 2), kernel(20, 3), kernel(4, 4), kernel(100, 5),
              kernel(1000, 6)]
    assert per_step(events, 2) == {"value": pytest.approx(17.0), "steps": 2,
                                   "encode_us": 4.0, "sample_us": 1.0, "decode_us": 10.0,
                                   "elbo_us": 2.0}
    # a program without the spans
    assert per_step([e for e in events if not e["name"].startswith("vae.")], 2) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_elbo_reader_gives_each_operation_the_span_device_us_by_span_gives(seed):
    """On a random trace of nested spans over two threads, with launches
    at span edges and outside any span: the reader's attribution equals
    `spans.device_us_by_span`'s for the four `vae.*` spans."""
    import random

    from carto_bench.spans import device_us_by_span

    reader = load_module(reader_path("elbo_device_us_per_step.train_vae"))
    rng = random.Random(seed)
    events, corr = [], 0
    for tid in (1, 2):
        t = 0.0
        for _ in range(40):
            step = rng.uniform(20, 60)
            events.append(span("trainer.step", t, step, tid))
            cuts = sorted(rng.uniform(t, t + step) for _ in range(5))
            for name, a, b in zip(reader.VAE_SPANS, cuts, cuts[1:]):
                events.append(span(name, a, b - a, tid))
            for _ in range(12):
                corr += 1
                at = rng.choice([rng.uniform(t - 1, t + step + 1), rng.choice(cuts)])
                events += [launch(at, corr, tid), kernel(rng.uniform(0.5, 5), corr)]
            t += step + rng.uniform(0, 5)
    events.append(kernel(3.0, corr + 1))   # its launch not in the trace
    want = device_us_by_span(events)
    got = reader.device_us_by_vae_span(events)
    assert got == {name: pytest.approx(want.get(name, 0.0)) for name in reader.VAE_SPANS}
    assert sum(got.values()) > 0


class FakeVAEJob:
    """What the VAE cell's readers read of its job."""

    batch, seeds, n_cvs, device = 128, [43], 2, torch.device("cpu")
    mix = {"trace_calls": 1}
    options = {"encoder": {"dropout": [0.1] * 3}, "decoder": {"dropout": [0.1, 0.1, None]},
               "encoder_layers": [3235, 32, 16, 8], "decoder_layers": [2, 4, 8, 3235]}


def test_the_vae_step_s_share_of_the_peak_and_its_host_time():
    window = Window(calls=[{"work": {"steps": 625}}] * 4, seconds=10.0)
    peaks = {"fp32_flops_per_s": 67e12}
    job = FakeVAEJob()
    flops = counts_vae.vae_step_flops(128, 1, [3235, 32, 16, 8], 2, [2, 4, 8, 3235], 3, 2,
                                      False)
    mfu = load_module(reader_path("train_mfu.train_vae")).read(
        Context(job, window, None, peaks))
    assert mfu == pytest.approx(100.0 * flops / (10.0 / 2500) / 67e12)
    assert 0.01 < mfu < 0.1   # ~77 MFLOP a step at 4 ms
    assert load_module(reader_path("train_mfu.train_vae")).read(
        Context(job, window, None, None)) is None
    steps = [{"name": "trainer.step", "ts": 100.0 + 10 * k, "dur": 4000.0} for k in range(3)]
    trace = Trace([], [{"name": "bench.call", "ts": 100.0, "dur": 900.0}] + steps, 100.0, 1000.0)
    assert load_module(reader_path("step_host_ms.train")).read(
        Context(job, window, trace, None)) == {"value": pytest.approx(4.0), "n": 3}


def test_the_vae_cell_passes_and_its_control_and_faults_do_not():
    cell = tiny(VAE_CELL)
    got = readings(cell, SEED, 0.3, "cpu")
    assert got["program_correct"] and got["calls"] >= 1
    assert got["program"]["beta_off_steps"] == got["program"]["calls_without_selection"] == 0
    for side in ("control", "fault_beta0", "fault_eps0", "fault_half_batch"):
        assert not got[f"{side}_correct"], side
    assert got["fault_beta0"]["beta_off_steps"] == 3


def run_tiny(seed: int, counter: bool = True):
    """A run of the tiny VAE cell as the harness makes it (a window of
    0.3 s, then the check), on a program with or without the trainer's
    counter: `judge`'s (correct, compared) and the calls made."""
    cell = tiny(VAE_CELL)
    job_module = cell.job_module()
    if not counter:
        job_module.train_stats = lambda: None
    job = job_module.Job(cell.config, cell.mix, seed, "cpu")
    window = run_window(job, 0.3, lambda: None)
    job.release()
    failed = sum(1 for c in window.calls if c["work"]["failed"])
    correct, compared = judge(job.check(), cell.limits, failed)
    return correct, {c["name"]: c for c in compared}, len(window.calls)


@pytest.mark.parametrize("counter", [True, False])
def test_the_vae_cell_is_correct_with_and_without_the_counter(counter):
    correct, compared, calls = run_tiny(SEED + 1, counter)
    assert correct and calls >= 1
    assert compared["calls_without_selection"]["value"] == 0


def half_batch(monkeypatch):
    original = VAECalculator.loss_fn

    def half(self, params, batch, generators, beta, train=True):
        if train:
            batch = dict(batch)
            weight = batch["weight"].clone()
            weight[:, weight.shape[1] // 2:] = 0.0
            batch["weight"] = weight
        return original(self, params, batch, generators, beta, train)

    monkeypatch.setattr(VAECalculator, "loss_fn", half)


@pytest.mark.parametrize("fault, failing", [
    ("beta0", "beta_off_steps"), ("eps0", "recon_gap"), ("half_batch", "recon_gap"),
    ("no_selection", "calls_without_selection")])
@pytest.mark.parametrize("counter", [True, False])
def test_a_fault_planted_in_the_program_turns_correct_false(monkeypatch, fault, failing,
                                                            counter):
    if fault == "beta0":
        monkeypatch.setattr(training.KLAnnealing, "beta", lambda self, epoch: 0.0)
    elif fault == "eps0":
        monkeypatch.setattr(networks, "reparam_noise",
                            lambda shape, generators: torch.zeros(tuple(shape)))
    elif fault == "half_batch":
        half_batch(monkeypatch)
    else:
        monkeypatch.setattr(VAECalculator, "uses_post_annealing", lambda self: False)
    correct, compared, _ = run_tiny(SEED + 2, counter)
    assert not correct
    assert compared[failing]["value"] > compared[failing]["limit"]
