"""Host time of one optimizer step: the mean length of the program's
`trainer.step` spans in the traced call, with their count."""

from carto_bench.spans import named


def read(ctx):
    steps = named(ctx.trace, "trainer.step")
    if not steps:
        return None
    return {"value": sum(s["dur"] for s in steps) / len(steps) / 1e3, "n": len(steps)}
