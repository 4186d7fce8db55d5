"""Share of the optimizer steps the trainer replayed from a CUDA graph:
the program's trainer counter (`training.TRAIN_STATS`) read before and
after one more call of the cell, replayed steps over steps, with the steps
and the captures beside it. The counter is read by difference and never
reset: the VAE cell's check reads the same counter over every call.
Nothing on a program whose counter has no `replayed_steps`, or when the
call ran no step."""


def read(ctx):
    from deep_cartograph_torch.models import training

    stats = getattr(training, "TRAIN_STATS", None)
    if stats is None or not hasattr(stats, "replayed_steps"):
        return None
    before = (stats.steps, stats.replayed_steps, stats.captures)
    ctx.job.call(len(ctx.window.calls) + len(ctx.trace.work))
    steps, replayed, captures = (after - first for after, first in
                                 zip((stats.steps, stats.replayed_steps, stats.captures), before))
    if steps <= 0:
        return None
    return {"value": 100.0 * replayed / steps, "steps": steps, "captures": captures}
