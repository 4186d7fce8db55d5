"""Device time of the VAE's layers per training step: as many more calls
as the cell traces, under a profiler of this reader's own (the harness's
trace keeps no correlation ids), each kernel, copy and set given to the
`vae.*` span that held its launch (the four spans, encode, sample, decode
and elbo, hold no span of their own, so this is the innermost span, as
`spans.device_us_by_span` takes it; found by bisection, since that scan
of every span for every operation takes minutes over a call's 625
steps); the device time under the four spans over the calls' optimizer
steps, in microseconds a step, with each span's share beside it. Launches inside `trainer.validate`
are left out (the validation's forward is no step's). The backward's
kernels, launched from autograd's own thread, lie under no span. Nothing on
a program without the spans."""

import bisect
import os
import tempfile

from carto_bench.spans import DEVICE_CATS, LAUNCH_CATS, load_events

VAE_SPANS = ("vae.encode", "vae.sample", "vae.decode", "vae.elbo")
VALIDATE_SPAN = "trainer.validate"


def outside_validation(events):
    """The events but the launches made inside a `trainer.validate` span
    on the launching thread."""
    validation = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == VALIDATE_SPAN:
            validation.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))

    def held(e):
        t = float(e["ts"])
        return any(a <= t <= b for a, b in validation.get((e.get("pid"), e.get("tid")), []))

    return [e for e in events if not (e.get("cat") in LAUNCH_CATS and held(e))]


def device_us_by_vae_span(events):
    """Device microseconds of every kernel, copy and set whose launch (the
    CUDA runtime or driver call with the same `args.correlation`) a `vae.*`
    span on the launching thread holds, summed by that span."""
    launches, spans = {}, {}
    for e in events:
        cat = e.get("cat", "")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif cat == "user_annotation" and e["name"] in VAE_SPANS:
            ts = float(e["ts"])
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + float(e.get("dur", 0.0)), e["name"]))
    starts = {}
    for key, held in spans.items():
        held.sort()
        starts[key] = [a for a, _, _ in held]
    out = dict.fromkeys(VAE_SPANS, 0.0)
    for e in events:
        if e.get("cat", "") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        key, t = (launch.get("pid"), launch.get("tid")), float(launch["ts"])
        i = bisect.bisect_right(starts.get(key, []), t) - 1
        # the spans do not overlap, so only the last to start by t and the
        # one before it (ending where it starts) can hold t: the shorter wins
        holding = [spans[key][j] for j in (i - 1, i) if j >= 0 and t <= spans[key][j][1]]
        if holding:
            name = min(holding, key=lambda s: s[1] - s[0])[2]
            out[name] += float(e.get("dur", 0.0))
    return out


def read(ctx):
    import torch
    from torch.profiler import ProfilerActivity, profile

    job = ctx.job
    on_card = torch.device(job.device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    first = len(ctx.window.calls) + len(ctx.trace.work)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    steps = 0
    sync()
    with profile(activities=activities) as prof:
        for k in range(int(job.mix["trace_calls"])):
            steps += job.call(first + k)["steps"]
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_events(path)
    finally:
        os.remove(path)
    return per_step(events, steps)


def per_step(events, steps: int):
    """The device microseconds a step under the `vae.*` spans, with each
    span's beside them (`encode_us`, ...), or None where they hold none."""
    by_span = device_us_by_vae_span(outside_validation(events))
    parts = {name: by_span.get(name, 0.0) / steps for name in VAE_SPANS} if steps else {}
    total = sum(parts.values())
    if total <= 0:
        return None
    return {"value": total, "steps": steps,
            **{f"{name.split('.')[1]}_us": v for name, v in parts.items()}}
