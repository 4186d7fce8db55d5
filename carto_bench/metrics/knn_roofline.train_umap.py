"""The UMAP kNN's share of its roofline: the least time of the kNN of
every row among the others (`counts_umap.knn_roofline_s`: its products at
the float32 peak or its compulsory bytes at the memory's, counted from the
work, not the tiling) over the device time of the operations launched
under the program's `umap.knn` span, in one more call profiled by the job
(`Job.profiled_call`), with both times beside it. Nothing on a program
without the span."""

from carto_bench import counts_umap


def read(ctx):
    job = ctx.job
    if ctx.peaks is None:
        return None
    first = len(ctx.window.calls) + len(ctx.trace.work)
    device_us = job.profiled_call(first)["by_span"].get("umap.knn", 0.0)
    if device_us <= 0:
        return None
    n, d = job.x.shape
    roofline_s = counts_umap.knn_roofline_s(n, d, int(job.settings["n_neighbors"]), ctx.peaks)
    return {"value": 100.0 * roofline_s * 1e6 / device_us, "device_ms": device_us / 1e3,
            "roofline_ms": roofline_s * 1e3}
