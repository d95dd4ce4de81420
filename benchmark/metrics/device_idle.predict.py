"""The share of the traced window in which no device operation (kernel,
copy or memset) ran, in %."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
