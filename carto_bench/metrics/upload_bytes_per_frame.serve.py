"""Bytes the program sends to the card a frame: its counter of the staged
copy up (`geom/kernels.py::UPLOAD_STATS`, an `ops/build.py::UploadStats`)
reset, then as many more calls as the cell traces, and the bytes sent over
the frames staged. Beside it: the bytes the caller's frames held a frame
(sent = held when no atom was left behind), the chunks and the chunks that
waited for a free slot of the ring (the card, not the host, set the pace).
Nothing on a program without the counter, or when no frame was staged."""


def read(ctx):
    from deep_cartograph_torch.geom import kernels

    stats = getattr(kernels, "UPLOAD_STATS", None)
    if stats is None:
        return None
    job = ctx.job
    first = len(ctx.window.calls) + len(ctx.trace.work)
    stats.reset()
    for k in range(int(job.mix["trace_calls"])):
        job.call(first + k)
    if stats.frames <= 0:
        return None
    return {"value": stats.bytes_sent / stats.frames,
            "held_bytes_per_frame": stats.bytes_held / stats.frames,
            "frames": stats.frames, "chunks": stats.chunks, "slot_waits": stats.slot_waits}
