"""Share of the traced calls the host spent in the copy of the frames up:
the union of the program's `transfer.h2d` spans over the traced window, in
percent. A pageable copy returns once its bytes are on the card, so the
span holds the copy and its wait for the work queued before it."""

from carto_bench.spans import window_share


def read(ctx):
    return window_share(ctx.trace, "transfer.h2d")
