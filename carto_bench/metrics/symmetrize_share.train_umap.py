"""Share of the traced window the host spent in the program's
`umap.symmetrize` span (the fuzzy union on the host with scipy.sparse, the
fit's part that runs on the host alone): the union of its spans over the
window. Nothing on a program without the span."""

from carto_bench.spans import window_share


def read(ctx):
    return window_share(ctx.trace, "umap.symmetrize")
