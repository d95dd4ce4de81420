"""Mean time the launch thread waits for a chunk's slab from the
prefetch threads (the program's ``PhaseTimer`` phase ``wait_prefetch``),
in ms a chunk over the traced passes."""


def read(ctx):
    total, n = ctx["timer"].get("wait_prefetch", (0.0, 0))
    return total / n * 1e3 if n else None
