#!/usr/bin/env python3
"""Readings that set a cell's limits, for a job that plants its own faults
(`Job.fault_checks()`): the program's compared numbers, its control's and
each planted fault's, on each seed, at the cell's own size, in one process.

    python3 carto_bench/control_faults.py --workload <name> --seeds 1,2,3 [--seconds 3]

Set-up and a short window as in `control.py`, then the program's numbers
(what a run compares), the control's (`Job.control_check()`) and each
fault's, every set judged by the run's own comparison (`harness.judge`, the
cell's limits): the program's has to come out correct, the control's and
each fault's not. One JSON line a seed; the benchmark's runs never run
this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from carto_bench.harness import Cell, card_check, judge, run_window  # noqa: E402


def readings(cell: Cell, seed: int, seconds: float, device) -> dict:
    import torch

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    job = cell.job_module().Job(cell.config, cell.mix, seed, device)
    try:
        window = run_window(job, seconds, sync) if seconds > 0 else None
        job.prepare_control()
        job.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        failed = sum(1 for c in window.calls if c["work"].get("failed")) if window else 0
        out = {"seed": seed, "calls": len(window.calls) if window else 0, "failed": failed,
               "program": job.check(), "control": job.control_check(), **job.fault_checks()}
        for side in [k for k, v in out.items() if isinstance(v, dict)]:
            out[f"{side}_correct"] = judge(out[side], cell.limits,
                                           failed if side == "program" else 0)[0]
        return out
    finally:
        job.close()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args()
    cell = Cell.find(args.workload)
    problem = card_check(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds, "cuda")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": cell.name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
