"""Mean CPU time of a chunk's append to the prediction store (the
program's ``PhaseTimer`` phase ``zarr_write``, the writer thread's
``time.thread_time``, ``zarr_write.cpu``), in ms a chunk over the traced
passes: beside ``zarr_write_ms.predict``, the part of the write's wall
the thread ran."""


def read(ctx):
    total, n = ctx["timer"].get("zarr_write.cpu", (0.0, 0))
    return total / n * 1e3 if n else None
