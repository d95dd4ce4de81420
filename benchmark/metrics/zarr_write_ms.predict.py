"""Mean time of a chunk's append to the prediction store (the program's
``PhaseTimer`` phase ``zarr_write``, on the writer thread: the encode and
the file writes), in ms a chunk over the traced passes."""


def read(ctx):
    total, n = ctx["timer"].get("zarr_write", (0.0, 0))
    return total / n * 1e3 if n else None
