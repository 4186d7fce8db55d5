"""Span arithmetic shared by the readers of the program's spans
(`deep_cartograph_torch/utils/profiling.py::annotate`): the union of one
span name's intervals inside the traced window, the spans that start in
it, and the attribution of device operations to the innermost span that
held their launch on the host.

Times are microseconds on the profiler's one clock, as `harness.Trace`
holds them. A program without a span of the name gives nothing: the
readers then return None.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside any span"


def named(trace, name: str) -> List[dict]:
    """The spans of `name` that start inside the traced window."""
    return [s for s in trace.spans
            if s["name"] == name and trace.start <= s["ts"] <= trace.end]


def union_us(spans: List[dict], start: float, end: float) -> float:
    """Length of the union of the spans' intervals clipped to [start, end]."""
    total, reach = 0.0, start
    for s in sorted(spans, key=lambda s: s["ts"]):
        a = max(s["ts"], reach)
        b = min(s["ts"] + s["dur"], end)
        if b > a:
            total += b - a
            reach = b
    return total


def window_share(trace, name: str) -> Optional[float]:
    """Percent of the traced window that the host spent inside a span of
    `name` (the union of its spans, so nested or overlapping ones count
    once), or None where the trace holds no such span."""
    spans = [s for s in trace.spans if s["name"] == name]
    if not spans or trace.window_us <= 0:
        return None
    return 100.0 * union_us(spans, trace.start, trace.end) / trace.window_us


def load_events(path: str) -> List[dict]:
    """The complete ("X") events of an exported Chrome trace."""
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X"]


def device_us_by_span(events: List[dict]) -> Dict[str, float]:
    """Device microseconds of every kernel, copy and set, summed by the
    innermost host span (`user_annotation`) that holds its launch: the CUDA
    runtime or driver call with the same `args.correlation`, on the thread
    that made it. An operation whose launch no span holds, or whose launch
    the trace lacks, counts under OUTSIDE."""
    launches = {}
    spans_by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        cat = e.get("cat", "")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif cat == "user_annotation":
            spans_by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: Dict[str, float] = {}
    for e in events:
        if e.get("cat", "") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = OUTSIDE
        if launch is not None:
            t = float(launch["ts"])
            holding = [s for s in spans_by_thread.get((launch.get("pid"), launch.get("tid")), [])
                       if float(s["ts"]) <= t <= float(s["ts"]) + float(s.get("dur", 0.0))]
            if holding:
                name = min(holding, key=lambda s: float(s.get("dur", 0.0)))["name"]
        out[name] = out.get(name, 0.0) + float(e.get("dur", 0.0))
    return out
