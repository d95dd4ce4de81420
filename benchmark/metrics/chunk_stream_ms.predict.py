"""Mean time a chunk holds the card's stream (the program's
``chunk_stream``: a CUDA event recorded before the chunk's stream waits
for its slab's copy, one after its output's copy to the host), in ms a
chunk over the traced passes.  Where the launch thread enqueues slower
than the card runs, as in both prediction cells, the stream waits on
each launch and this reads the enqueue, not the kernels: the device's
own time is the trace's (``device_idle``, ``forward_mfu``)."""


def read(ctx):
    total, n = ctx["timer"].get("chunk_stream", (0.0, 0))
    return total / n * 1e3 if n else None
