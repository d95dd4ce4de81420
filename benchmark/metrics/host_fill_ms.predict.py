"""Mean host time of a chunk's survey read into its slab (the program's
``PhaseTimer`` phase ``host_fill``, on the prefetch threads), in ms a
chunk over the traced passes."""


def read(ctx):
    total, n = ctx["timer"].get("host_fill", (0.0, 0))
    return total / n * 1e3 if n else None
