"""GB/s of the device-to-host copies in the traced passes: their bytes
over their device time, from the profiler's Memcpy DtoH records."""


def read(ctx):
    copies = ctx.trace.copies("DtoH")
    seconds = sum(c["dur"] for c in copies) / 1e6
    moved = sum(c["bytes"] for c in copies)
    return moved / seconds / 1e9 if seconds > 0 and moved > 0 else None
