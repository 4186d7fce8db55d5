"""The whole training step's share of the card's float32 peak: the
operations of one step of every try (`counts.train_step_flops`: forward
and backward of both lag halves of the batch, covariances, Adam) over the
window's time per step. The program runs float32 with TF32 off."""

from carto_bench import counts


def read(ctx):
    if ctx.peaks is None:
        return None
    job = ctx.job
    general = job.cfg["training"]["general"]
    dropout_layers = sum(1 for r in job.options["dropout"] if r)
    flops = counts.train_step_flops(general["batch_size"], general["num_tries"],
                                    job.layers, dropout_layers)
    step_s = ctx.window.seconds / ctx.window.total("steps")
    return 100.0 * flops / step_s / ctx.peaks["fp32_flops_per_s"]
