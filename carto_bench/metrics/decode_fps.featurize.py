"""Frames per second of the host decode alone: `io.traj.iter_frame_chunks`
over the cell's DCD at the chunk the featurizer uses, with no device work,
two passes timed by the host clock."""

import time

PASSES = 2


def read(ctx):
    from deep_cartograph_torch.geom.engine import auto_chunk_size
    from deep_cartograph_torch.io.traj import iter_frame_chunks

    job = ctx.job
    chunk = auto_chunk_size(int(job.mix["frame_chunk"]), job.mol.n_atoms, job.mol.n_features)
    frames = 0
    t0 = time.perf_counter()
    for _ in range(PASSES):
        for block in iter_frame_chunks(job.dcd, chunk):
            frames += len(block)
    return frames / (time.perf_counter() - t0)
