"""`correct` at a size a test run holds, on the CPU: every cell's program
passes its limits, its control fails one, and each fault the cell can have,
planted in the program under a run, turns `correct` false."""

import pytest
import torch

from carto_bench.control import readings
from carto_bench.harness import run_cell
from conftest import SEED, tiny

WORKLOADS = ["lambda80.featurize", "lambda80.serve", "villin35.train"]


def over(values: dict, limits: dict) -> list:
    return [k for k in limits if values.get(k, float("inf")) > limits[k]["limit"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(workload):
    cell = tiny(workload)
    got = readings(cell, SEED, 0.3, "cpu")
    assert over(got["program"], cell.limits) == [] and got["program_correct"]
    assert over(got["control"], cell.limits) != [] and not got["control_correct"]
    if "fault_half_batch" in got:
        assert over(got["fault_half_batch"], cell.limits) != []
        assert not got["fault_half_batch_correct"]
        assert got["fault_worst_try"]["best_try_regret"] > cell.limits["best_try_regret"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = run_cell(tiny(workload), SEED + 1, 0.3, False, "cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["compared"]) == set(tiny(workload).limits)


def alter_answer(monkeypatch, cls, method):
    """The first row of every answer moved by 1e-3 where it is produced."""
    original = getattr(cls, method)

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs).clone()
        out[0] += 1e-3
        return out

    monkeypatch.setattr(cls, method, altered)


def test_featurize_answer_altered(monkeypatch):
    from deep_cartograph_torch.geom.engine import ShardedChunkEvaluator

    alter_answer(monkeypatch, ShardedChunkEvaluator, "eval_raw")
    assert not run_cell(tiny("lambda80.featurize"), SEED, 0.3, False, "cpu")["correct"]


def test_serve_answer_altered(monkeypatch):
    from deep_cartograph_torch.deploy import FramesToCV

    alter_answer(monkeypatch, FramesToCV, "eval_raw")
    assert not run_cell(tiny("lambda80.serve"), SEED, 0.3, False, "cpu")["correct"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from deep_cartograph_torch.models.training import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, params, grads, state, lr: None)
    assert not run_cell(tiny("villin35.train"), SEED, 0.3, False, "cpu")["correct"]


def test_train_half_batch_left_out(monkeypatch):
    from deep_cartograph_torch.cv.deep import DeepTICACalculator

    original = DeepTICACalculator.loss_fn

    def half(self, params, batch, generators, beta, train=True):
        if train:
            batch = dict(batch)
            weight = batch["weight"].clone()
            weight[:, weight.shape[1] // 2:] = 0.0
            batch["weight"] = weight
        return original(self, params, batch, generators, beta, train)

    monkeypatch.setattr(DeepTICACalculator, "loss_fn", half)
    assert not run_cell(tiny("villin35.train"), SEED, 0.3, False, "cpu")["correct"]


def test_train_tica_layer_altered(monkeypatch):
    from deep_cartograph_torch.cv.deep import DeepTICACalculator

    original = DeepTICACalculator.finalize_model

    def altered(self):
        original(self)
        self.tica_evecs = self.tica_evecs * 1.01

    monkeypatch.setattr(DeepTICACalculator, "finalize_model", altered)
    assert not run_cell(tiny("villin35.train"), SEED, 0.3, False, "cpu")["correct"]


def test_train_worst_try_chosen(monkeypatch):
    from deep_cartograph_torch.cv.deep import DeepTICACalculator

    original = DeepTICACalculator._validate_result

    def only_worst(self, result):
        return original(self, result) and result.score == max(
            r.score for _, r in self.try_results)

    monkeypatch.setattr(DeepTICACalculator, "_validate_result", only_worst)
    assert not run_cell(tiny("villin35.train"), SEED, 0.3, False, "cpu")["correct"]


@pytest.mark.cuda
def test_cells_on_the_card():
    """Each cell for a short window on the card, where there is one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from carto_bench.harness import Cell

    for workload in WORKLOADS:
        assert run_cell(Cell.find(workload), SEED, 2.0, False, "cuda")["correct"]
