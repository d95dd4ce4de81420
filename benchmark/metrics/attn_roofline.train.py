"""The SegFormer train step's attention kernels (``attn_share.train``'s):
the least time their work needs, the larger of the attention's FLOPs at
the card's bf16 peak and its bytes at its HBM bandwidth, over their
kernel time in the trace, in %.  FLOPs and bytes a step are the
segformer adapter's ``attention_flops`` and ``attention_bytes`` at the
cell's configuration; the traced steps are ``ctx["flops"]`` over the
adapter's ``train_step_flops``.  A trace with no attention kernel reports
nothing."""

import os

from benchmark.yardstick.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

CELL = "train_b16_512.segformer_b2"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _is_attention(name):
    return "flash_fwd" in name or "flash_bwd" in name


def read(ctx):
    n, t = ctx["trace"].kernel_time(_is_attention)
    if not n or t <= 0 or not ctx.get("flops"):
        return None
    from benchmark import run
    _, _, _, cfg = run.cell_files(run.load_bench(ROOT), CELL, ROOT)
    arch = run.load_architecture(cfg, ROOT)
    B, (h, w) = int(cfg["batch_size"]), cfg["patch_size"]
    steps = ctx["flops"] / arch.train_step_flops(cfg, B, h, w)
    least = max(arch.attention_flops(cfg, B, h, w) / PEAK_BF16_FLOPS,
                arch.attention_bytes(cfg, B, h, w) / PEAK_HBM_BYTES)
    return 100.0 * steps * least / t
