"""The whole VAE training step's share of the card's float32 peak: the
operations of one step of every try (`counts_vae.vae_step_flops`: forward,
sample, reconstruction and KL, backward, Adam) over the window's time per
step; the cell normalizes no feature. The program runs float32 with TF32
off."""

from carto_bench import counts_vae


def read(ctx):
    if ctx.peaks is None:
        return None
    job = ctx.job
    enc, dec = job.options["encoder"], job.options["decoder"]
    flops = counts_vae.vae_step_flops(
        job.batch, len(job.seeds), job.options["encoder_layers"], job.n_cvs,
        job.options["decoder_layers"], sum(1 for r in enc["dropout"] if r),
        sum(1 for r in dec["dropout"] if r), False)
    step_s = ctx.window.seconds / ctx.window.total("steps")
    return 100.0 * flops / step_s / ctx.peaks["fp32_flops_per_s"]
