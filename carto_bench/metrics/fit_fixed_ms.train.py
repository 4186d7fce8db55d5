"""The trainer's host time outside its steps, per traced call: the sum of
the program's `trainer.fit` spans (`Trainer.fit_ensemble`) less the sum of
its `trainer.step` spans, over the calls traced. It holds the placing of
the dataset, the epochs' batch orders, validation and the selection of
each try's result."""

from carto_bench.spans import named


def read(ctx):
    fits = named(ctx.trace, "trainer.fit")
    if not fits or not ctx.trace.work:
        return None
    steps = named(ctx.trace, "trainer.step")
    fixed_us = sum(s["dur"] for s in fits) - sum(s["dur"] for s in steps)
    return fixed_us / len(ctx.trace.work) / 1e3
