"""The training steps' FLOPs (three forwards' worth a crop: forward,
input and weight gradients; counted from the crop size) over the traced
window's wall time, as a share of the card's bf16 dense peak."""

from benchmark.yardstick.counts import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.get("flops") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / PEAK_BF16_FLOPS
