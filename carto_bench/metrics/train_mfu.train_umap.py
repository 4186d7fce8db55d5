"""The whole UMAP fit's share of the card's float32 peak: a fit's
operations (`counts_umap.fit_flops`: the kNN's products 2 n^2 d, the PCA
start's covariance 2 n d^2, the layout's epochs over the last call's
graph) over the window's time a fit. The program runs float32 with TF32
off."""

from carto_bench import counts_umap


def read(ctx):
    job = ctx.job
    edges = job.record.get("heads")
    if ctx.peaks is None or edges is None:
        return None
    n, d = job.x.shape
    flops = counts_umap.fit_flops(n, d, int(job.settings["dimension"]), len(edges),
                                  job.epochs_per_fit, int(job.settings["negative_samples"]))
    fit_s = ctx.window.seconds / ctx.window.total("fits")
    return 100.0 * flops / fit_s / ctx.peaks["fp32_flops_per_s"]
