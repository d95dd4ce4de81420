"""The SegFormer train step's attention kernels (the port's
``ops/attention.py``: the flash backend's ``flash_fwd_*`` and
``flash_bwd_*`` kernels): their device time in the trace over the traced
window's wall, in %.  A trace with no such kernel (the CPU, a program
without the op) reports nothing."""


def is_attention(name):
    return "flash_fwd" in name or "flash_bwd" in name


def read(ctx):
    n, t = ctx["trace"].kernel_time(is_attention)
    if not n or ctx["window_s"] <= 0:
        return None
    return 100.0 * t / ctx["window_s"]
