"""Tiny copies of the benchmark's cells, for tests on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from carto_bench.harness import Cell  # noqa: E402

SEED = 2**31 + 12345   # wider than 32 signed bits, as a run's seed may be


def tiny(workload: str) -> Cell:
    """The cell as BENCHMARK.json defines it, at 8 residues and a few
    thousand frames."""
    cell = Cell.find(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    cell.config["molecule"]["residues"] = 8
    cell.config["frames"] = 3000
    if cell.mix["job"] == "serve":
        cell.mix.update(min_frames=20, max_frames=2000, distinct_lengths=8)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
