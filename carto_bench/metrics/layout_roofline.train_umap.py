"""The UMAP layout's share of its roofline: an epoch's compulsory bytes
(`counts_umap.layout_epoch_bytes`: the graph read once, the embedding read
and written once) at the memory's peak, over the device time of the
operations launched under the program's `umap.layout` span a layout epoch,
the epochs counted by the program's counter (`umap_cv.UMAP_STATS`) over
one more call profiled by the job (`Job.profiled_call`); the device
microseconds an epoch and the edges beside it. Nothing on a program
without the span or the counter."""

from carto_bench import counts_umap


def read(ctx):
    job = ctx.job
    if ctx.peaks is None:
        return None
    profiled = job.profiled_call(len(ctx.window.calls) + len(ctx.trace.work))
    device_us = profiled["by_span"].get("umap.layout", 0.0)
    if device_us <= 0 or not profiled["epochs"]:
        return None
    us_per_epoch = device_us / profiled["epochs"]
    n = len(job.x)
    roofline_us = 1e6 * counts_umap.layout_epoch_bytes(
        n, profiled["edges"], int(job.settings["dimension"])) / ctx.peaks["hbm_bytes_per_s"]
    return {"value": 100.0 * roofline_us / us_per_epoch, "us_per_epoch": us_per_epoch,
            "edges": profiled["edges"]}
