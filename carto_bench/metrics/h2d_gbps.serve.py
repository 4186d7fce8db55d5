"""GB/s of the host-to-device copies in the traced calls: their bytes over
their device time, from the profiler's Memcpy HtoD records."""


def read(ctx):
    copies = ctx.trace.copies("HtoD")
    seconds = sum(c["dur"] for c in copies) / 1e6
    moved = sum(c["bytes"] for c in copies)
    return moved / seconds / 1e9 if seconds > 0 and moved > 0 else None
