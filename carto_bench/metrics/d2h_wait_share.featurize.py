"""Share of the traced passes the host spent blocked in the copy of the
features back: the union of the program's `transfer.d2h` spans over the
traced window, in percent."""

from carto_bench.spans import window_share


def read(ctx):
    return window_share(ctx.trace, "transfer.d2h")
