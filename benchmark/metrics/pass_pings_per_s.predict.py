"""Pings of the traced survey passes over their host wall time, which
ends in a device synchronise: the passes' rate, read per layer because
the host's speed spreads a window's rate too widely to bound it."""


def read(ctx):
    if not ctx.get("done") or ctx["wall_s"] <= 0:
        return None
    return ctx["done"] / ctx["wall_s"]
