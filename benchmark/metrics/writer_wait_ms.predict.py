"""Mean time the launch thread waits for a chunk's write to the
prediction store before it hands the writer the next one (the program's
``PhaseTimer`` phase ``wait_writer``), in ms a chunk over the traced
passes."""


def read(ctx):
    total, n = ctx["timer"].get("wait_writer", (0.0, 0))
    return total / n * 1e3 if n else None
