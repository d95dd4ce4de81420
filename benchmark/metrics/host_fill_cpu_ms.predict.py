"""Mean CPU time of a chunk's survey read into its slab (the program's
``PhaseTimer`` phase ``host_fill``, ``host_fill.cpu``: the prefetch
thread's ``time.thread_time`` and that of the decode tasks it hands the
process's decode threads; a blosc store's native decode runs on threads
of its own and is not counted), in ms a chunk over the traced passes:
beside ``host_fill_ms.predict``, how much of the fill's wall some thread
ran for it."""


def read(ctx):
    total, n = ctx["timer"].get("host_fill.cpu", (0.0, 0))
    return total / n * 1e3 if n else None
