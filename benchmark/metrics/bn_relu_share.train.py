"""The train step's BatchNorm + ReLU kernels (``ops/bn_relu.py``, the CUDA
kernels ``bn_relu_*_kernel``, four a layer: statistics, apply, gradient
sums, gradient apply): their device time in the trace over the traced
window's wall, in %.  A program without them reports nothing."""


def read(ctx):
    n, t = ctx["trace"].kernel_time(lambda s: "bn_relu_" in s)
    if not n or ctx["window_s"] <= 0:
        return None
    return 100.0 * t / ctx["window_s"]
