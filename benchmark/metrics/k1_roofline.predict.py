"""K1 (``ops/gather_db.py``, the CUDA kernel ``gather_db_kernel``): the
least time its bytes need at the card's HBM bandwidth over its kernel
time in the trace, in %.  Bytes: the shipped slab read once and the
useful patches (or the padded grid, in slab mode) written once."""

from benchmark.yardstick.counts import PEAK_HBM_BYTES


def read(ctx):
    n, t = ctx["trace"].kernel_time(lambda s: "gather_db_kernel" in s)
    if not n or t <= 0 or not ctx.get("k1_bytes"):
        return None
    return 100.0 * ctx["k1_bytes"] / PEAK_HBM_BYTES / t
