"""Device time of the served projection per frame: as many more calls as
the cell traces, under a profiler of this reader's own (the harness's
trace keeps no correlation ids), each kernel, copy and set given to the
innermost span that held its launch (`spans.device_us_by_span`); the
device time of those under the program's `serve.project` span
(normalization, network, TICA layer) over the frames of the calls, in
nanoseconds a frame."""

import os
import tempfile

from carto_bench.spans import device_us_by_span, load_events


def read(ctx):
    import torch
    from torch.profiler import ProfilerActivity, profile

    job = ctx.job
    on_card = torch.device(job.device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    first = len(ctx.window.calls) + len(ctx.trace.work)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    frames = 0
    sync()
    with profile(activities=activities) as prof:
        for k in range(int(job.mix["trace_calls"])):
            frames += job.call(first + k)["frames"]
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        by_span = device_us_by_span(load_events(path))
    finally:
        os.remove(path)
    projected_us = by_span.get("serve.project", 0.0)
    if projected_us <= 0 or frames <= 0:
        return None
    return {"value": 1e3 * projected_us / frames, "frames": frames}
