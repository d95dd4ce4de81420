"""K4 (``ops/closing.py``, the CUDA kernel ``closing_kernel``), once a
train step on the batch's (B, 256, 256) masks: the least time its bytes
need at the card's HBM bandwidth over its kernel time in the trace, in %.
Bytes: the mask and the clip mask read once, the closed mask written
once."""

from benchmark.yardstick.counts import PEAK_HBM_BYTES


def read(ctx):
    n, t = ctx["trace"].kernel_time(lambda s: "closing_kernel" in s)
    if not n or t <= 0 or not ctx.get("k4_bytes"):
        return None
    return 100.0 * ctx["k4_bytes"] / PEAK_HBM_BYTES / t
