"""Share of the traced passes in which the featurizer waited for the
decoder: the union of the program's `io.next_chunk` spans (the prefetch
reader handing over its next chunk) over the traced window, in percent."""

from carto_bench.spans import window_share


def read(ctx):
    return window_share(ctx.trace, "io.next_chunk")
