"""Slot waits a chunk of the featurize copy back: the program's counter of
its download ring (`geom/engine.py::DOWNLOAD_STATS`, an
`ops/build.py::DownloadStats`) reset, then as many more calls as the cell
traces, and the pieces whose copy had not completed when the host came to
take their slot over the chunks sent down (0: the copies ran under the
next chunk's decode; 1 or more a chunk: the host waited on the link).
Beside it: the chunks, their pieces and their bytes. Nothing on a program
without the counter, or when no chunk came down through the ring."""


def read(ctx):
    from deep_cartograph_torch.geom import engine

    stats = getattr(engine, "DOWNLOAD_STATS", None)
    if stats is None:
        return None
    job = ctx.job
    first = len(ctx.window.calls) + len(ctx.trace.work)
    stats.reset()
    for k in range(int(job.mix["trace_calls"])):
        job.call(first + k)
    if stats.chunks <= 0:
        return None
    return {"value": stats.slot_waits / stats.chunks, "chunks": stats.chunks,
            "pieces": stats.pieces, "bytes": stats.bytes}
