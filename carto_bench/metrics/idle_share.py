"""Share of the traced window in which no kernel, copy or set ran on the
device: 100 (1 - busy / window), from the profiler's trace. The reader of
every cell's split of the quantity (`idle_share.<cell's job>`)."""


def read(ctx):
    window = ctx.trace.window_us
    return 100.0 * (1.0 - ctx.trace.busy_us() / window) if window > 0 else None
