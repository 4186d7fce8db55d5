"""K1's share of its roofline in the traced calls: the least time the
card needs for the bytes and operations these inputs need
(`counts.k1_bytes`, `counts.k1_flops`: the CA coordinates read once, the
distances written once) over the profiler's `pair_distances_kernel` time,
against the card's published peaks (`peaks.json`)."""

from carto_bench import counts


def read(ctx):
    kernels = ctx.trace.kernels("pair_distances_kernel")
    seconds = sum(k["dur"] for k in kernels) / 1e6
    if not kernels or seconds <= 0 or ctx.peaks is None:
        return None
    mol = ctx.job.mol
    frames = sum(w["frames"] for w in ctx.trace.work)
    least = max(counts.k1_bytes(frames, len(mol.ca_index), len(mol.pairs))
                / ctx.peaks["hbm_bytes_per_s"],
                counts.k1_flops(frames, len(mol.pairs)) / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least / seconds
