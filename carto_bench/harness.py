"""The run of one cell: find its files by name, set up, measure a window,
read the trace, check the outputs against the reference, print the result.

Everything a cell needs is found by the names in BENCHMARK.json:

    configs[].file                      the configuration
    traffic/<traffic>.json              the mix (its "job" names the job)
    jobs/<job>.py                       the job that drives the program
    limits/<workload>.json              the limit of each compared number
    metrics/<per_layer name>.py         the reader of a per-layer metric, or
    metrics/<name up to its first dot>.py   one reader for the cells' splits
                                            of a quantity (idle_share.train)

so a later change adds a cell, a configuration, a mix or a metric by adding
files and entries.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# Top-level module names no run may load: the JAX package, its upstream
# copy and JAX itself. Compared whole: the port's own name begins with one.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "deep_cartograph_tpu",
                               "deep_cartograph"})
CALL_SPAN = "bench.call"


def forbidden_modules(names) -> List[str]:
    """The top-level names among `names` (module names) that are forbidden,
    compared as whole names."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN_MODULES)


def load_module(path: Path) -> ModuleType:
    """A harness file loaded by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"carto_bench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of the manifest with everything found for it."""

    name: str
    config: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def find(cls, workload: str, manifest: Optional[dict] = None) -> "Cell":
        manifest = manifest or json.loads(MANIFEST.read_text())
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in {MANIFEST.name}")
        w = by_name[workload]
        cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        config = json.loads((ROOT / cfg_entry["file"]).read_text())
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
        e2e = [m for m in manifest["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        per_layer = [m for m in manifest["per_layer"] if workload in m["workloads"]]
        return cls(workload, config, mix, limits, int(w["chips"]), e2e, per_layer)

    def job_module(self) -> ModuleType:
        return load_module(HERE / "jobs" / f"{self.mix['job']}.py")


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: `metrics/<name>.py`, else the
    reader of the quantity the name splits by cell, `metrics/<name up to
    its first dot>.py`."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """Device activity and host spans of a profiled segment, in
    microseconds on one clock."""

    device: List[dict]          # kernels, copies, sets: name, cat, ts, dur, bytes
    spans: List[dict]           # harness and program spans: name, ts, dur
    start: float                # the window: from the first traced call's
    end: float                  # span to the end of the last one's
    work: List[dict] = field(default_factory=list)   # what each traced call did

    @classmethod
    def from_chrome(cls, path: str) -> "Trace":
        events = json.loads(Path(path).read_text())
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        device, spans = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append({"name": e["name"], "cat": cat, "ts": float(e["ts"]),
                               "dur": float(e.get("dur", 0.0)),
                               "bytes": float(e.get("args", {}).get("bytes", 0) or 0)})
            elif cat == "user_annotation":
                spans.append({"name": e["name"], "ts": float(e["ts"]),
                              "dur": float(e.get("dur", 0.0))})
        calls = [s for s in spans if s["name"] == CALL_SPAN]
        if not calls:
            raise RuntimeError(f"the trace holds no {CALL_SPAN} span")
        return cls(device, spans, min(s["ts"] for s in calls),
                   max(s["ts"] + s["dur"] for s in calls))

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[List[float]]:
        """The union of device activity inside the window."""
        out: List[List[float]] = []
        for e in sorted(self.device, key=lambda e: e["ts"]):
            a = max(e["ts"], self.start)
            b = min(e["ts"] + e["dur"], self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self, name_part: str) -> List[dict]:
        return [e for e in self.device if e["cat"] == "kernel" and name_part in e["name"]]

    def copies(self, direction: str) -> List[dict]:
        """Memcpy events of one direction ("HtoD", "DtoH", "DtoD")."""
        return [e for e in self.device if e["cat"] == "gpu_memcpy" and direction in e["name"]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost span the host was in."""
        by_name: Dict[str, float] = {}
        for e in self.device:
            by_name[e["name"][:96]] = by_name.get(e["name"][:96], 0.0) + e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

        def host_at(a: float, b: float) -> str:
            mid = 0.5 * (a + b)
            inside = [s for s in self.spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
            return min(inside, key=lambda s: s["dur"])["name"] if inside else "outside any span"

        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[host_at(a, b), (b - a) / 1e6] for a, b in gaps]}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclass
class Window:
    """The measured calls: (start, end) host seconds and the work each did."""

    calls: List[dict] = field(default_factory=list)
    seconds: float = 0.0

    def total(self, key: str) -> float:
        return sum(c["work"].get(key, 0) for c in self.calls)

    def durations(self) -> List[float]:
        return [c["end"] - c["start"] for c in self.calls]


def run_window(job, seconds: float, sync) -> Window:
    """Closed loop: call the job until `seconds` have passed; the window
    ends with the last call, which always completes."""
    from torch.profiler import record_function

    window = Window()
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        with record_function(CALL_SPAN):
            work = job.call(i)
        sync()
        end = time.perf_counter()
        window.calls.append({"start": start, "end": end, "work": work})
        i += 1
        if end - t0 >= seconds:
            window.seconds = end - t0
            return window


def trace_segment(job, calls: int, sync, first_call: int) -> "Trace":
    """`calls` more calls of the job under torch.profiler (CPU and CUDA
    activity, the harness's spans), read from the exported trace."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    work = []
    with profile(activities=activities) as prof:
        for k in range(calls):
            with record_function(CALL_SPAN):
                work.append(job.call(first_call + k))
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.from_chrome(path)
    finally:
        os.remove(path)
    trace.work = work
    return trace


@dataclass
class Context:
    """What a per-layer metric reader gets."""

    job: object
    window: Window
    trace: Optional[Trace]
    peaks: Optional[dict]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None) -> dict:
    """Set up, measure, read and check one cell on `device`; returns the
    result object (the last line a run prints) and the comparisons."""
    import torch

    from carto_bench.counts import peaks

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    job = cell.job_module().Job(cell.config, cell.mix, seed, device)
    try:
        sync()
        setup_s = time.perf_counter() - t_start
        window = run_window(job, seconds, sync)
        e2e = job.end_to_end(window)
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        device_name = torch.cuda.get_device_name(device) if on_card else "cpu"
        result_device = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
                         "count": cell.chips}
        breakdown = None
        if trace:
            tr = trace_segment(job, int(cell.mix["trace_calls"]), sync, len(window.calls))
            ctx = Context(job, window, tr, peaks(device_name) if on_card else None)
            metrics = {}
            for m in cell.per_layer:
                value = load_module(reader_path(m["name"])).read(ctx)
                if isinstance(value, dict):
                    metrics[m["name"]] = {**value, "unit": m["unit"]}
                elif value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result_device["busy_s"] = tr.busy_us() / 1e6
            result_device["window_s"] = tr.window_us / 1e6
            breakdown = tr.breakdown()
        else:
            for m in cell.end_to_end:
                if m["name"] == "setup_s":
                    continue
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        if on_card:
            result_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
            result_device["power_limit_w"] = power_limit()
        attempted = len(window.calls)
        failed = sum(1 for c in window.calls if c["work"].get("failed"))
        job.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        values = job.check()
    finally:
        job.close()
    correct, compared = judge(values, cell.limits, failed)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    return result


def compare(values: dict, limits: dict) -> List[dict]:
    """Each compared number beside its limit, in the limits file's order; a
    number the check did not produce reads infinite."""
    return [{"name": name, "value": float(values.get(name, math.inf)),
             "limit": float(spec["limit"])} for name, spec in limits.items()]


def judge(values: dict, limits: dict, failed: int = 0):
    """`correct` of a run's compared numbers: no call failed and every
    number within its limit; with the comparisons."""
    compared = compare(values, limits)
    return failed == 0 and all(c["value"] <= c["limit"] for c in compared), compared


def power_limit() -> Optional[float]:
    """The card's power limit in watts (nvidia-smi), or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def card_check(chips: int) -> Optional[str]:
    """Why this machine cannot run a cell of `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "CUDA is not available: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible"
    return None


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = Cell.find(args.workload)
    problem = card_check(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
