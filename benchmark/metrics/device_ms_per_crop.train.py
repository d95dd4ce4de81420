"""The device's busy time a crop in the traced training window, in ms:
the seconds in which a device operation (kernel, copy or memset) ran,
over the crops the traced steps trained.  The card alone decides it, so
it stays steady where the host paces ``crops_per_s``; the gap between
the two is the time the card waits on the host.  A trace with no device
activity (a run on the CPU) reports nothing."""


def read(ctx):
    if ctx["busy_s"] <= 0 or not ctx["done"]:
        return None
    return 1000.0 * ctx["busy_s"] / ctx["done"]
