"""K3 (``ops/pool.py`` ``relu_pool_skip``, the CUDA kernel
``pool_kernel`` with its ReLU on): the least time its bytes need at the
card's HBM bandwidth over its kernel time in the trace, in %.  Bytes:
the level-0 map read once, the skip and the pooled map written once."""

from benchmark.yardstick.counts import PEAK_HBM_BYTES


def _is_k3(name):
    return "pool_kernel" in name and "true>" in name.replace(" ", "")


def read(ctx):
    n, t = ctx["trace"].kernel_time(_is_k3)
    if not n or t <= 0 or not ctx.get("k3_bytes"):
        return None
    return 100.0 * ctx["k3_bytes"] / PEAK_HBM_BYTES / t
