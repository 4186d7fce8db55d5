"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import math
import re
from pathlib import Path

import pytest

from carto_bench.harness import HERE, MANIFEST, ROOT, Cell, reader_path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST_DATA = json.loads(MANIFEST.read_text())
WORKLOADS = [w["name"] for w in MANIFEST_DATA["workloads"]]


def short_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    m = MANIFEST_DATA
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["carto_bench"]
    assert 1 <= len(m["command"]) <= 32 and all(short_line(w) for w in m["command"])
    assert m["command"][1].startswith("carto_bench/")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits in 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(MANIFEST.read_bytes()) <= 64 * 1024


def test_entries_keys_and_names():
    m = MANIFEST_DATA
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and short_line(c["source"]) and short_line(c["why"])
        assert c["file"].startswith("carto_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and short_line(w["why"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = m["end_to_end"] + m["per_layer"]
    names = [x["name"] for x in metrics]
    assert len(names) == len(set(names)) and len(WORKLOADS) == len(set(WORKLOADS))
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(x["workloads"]) <= set(WORKLOADS)
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert short_line(x["layer"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files_and_reports_enough(workload):
    cell = Cell.find(workload)
    assert cell.chips == cell.config["chips"]
    assert (HERE / "jobs" / f"{cell.mix['job']}.py").is_file()
    e2e = {x["name"] for x in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for x in cell.per_layer:
        assert x["moves"] in e2e
        assert reader_path(x["name"]).is_file()
    assert cell.limits and all(math.isfinite(v["limit"]) for v in cell.limits.values())
    assert hasattr(cell.job_module(), "Job")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        Cell.find("no_such.cell")


def test_every_harness_file_belongs_to_an_entry():
    """Configurations, mixes, limits and readers: each named by an entry."""
    m = MANIFEST_DATA
    named = {Path(c["file"]).name for c in m["configs"]}
    assert {p.name for p in (HERE / "configs").glob("*.json")} == named
    assert {p.stem for p in (HERE / "traffic").glob("*.json")} == {w["traffic"] for w in m["workloads"]}
    assert {p.stem for p in (HERE / "limits").glob("*.json")} == set(WORKLOADS)
    assert ({p.stem for p in (HERE / "metrics").glob("*.py")}
            == {reader_path(x["name"]).stem for x in m["per_layer"]})


def test_a_metric_split_by_cell_shares_its_quantity_s_reader():
    assert reader_path("idle_share.train") == HERE / "metrics" / "idle_share.py"
    assert reader_path("idle_share.featurize") == HERE / "metrics" / "idle_share.py"
    assert reader_path("h2d_gbps.serve") == HERE / "metrics" / "h2d_gbps.serve.py"
