"""The share of the U-Net's input pixels that pad (the program's counters
``n_pad_px`` over ``n_fwd_px``: the pad patches of a patch-mode
sub-batch, or a slab window's part outside the chunk's grid), in % over
the traced passes."""


def read(ctx):
    fwd, _ = ctx["timer"].get("n_fwd_px", (0, 0))
    pad, _ = ctx["timer"].get("n_pad_px", (0, 0))
    return 100.0 * pad / fwd if fwd else None
