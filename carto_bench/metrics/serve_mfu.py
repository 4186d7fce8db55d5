"""The whole serving step's share of the card's float32 peak: the
operations of every frame projected in the window (`counts.serve_flops`:
features, normalization, network, TICA layer) over the window's time. The
program runs float32 with TF32 off, so the peak is the float32 one."""

from carto_bench import counts


def read(ctx):
    if ctx.peaks is None:
        return None
    job = ctx.job
    flops = counts.serve_flops(int(ctx.window.total("frames")), len(job.mol.pairs),
                               len(job.mol.quads), job.layers)
    return 100.0 * flops / ctx.window.seconds / ctx.peaks["fp32_flops_per_s"]
