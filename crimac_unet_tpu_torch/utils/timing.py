"""Device-program timing: one shared burst-timing primitive.

The port's counterpart of ``crimac_unet_tpu/utils/timing.py``.  Dispatch
``burst`` calls back to back and synchronize ONCE, so the host's wait
for the device is paid once per burst and not booked on every call.  On
CUDA the fence is ``torch.cuda.synchronize``; callers that time work on
another device pass their own ``sync``.
"""

from __future__ import annotations

import time


def burst_time(fn, *args, reps: int = 3, burst: int = 8, warmup: int = 1,
               sync=None):
    """Best per-call wall time (seconds) of ``fn(*args)`` over ``reps``
    bursts of ``burst`` back-to-back calls, synchronizing once per burst.
    ``sync(out)`` defaults to ``torch.cuda.synchronize()`` when a card is
    present and to nothing on a CPU-only host (CPU ops return done)."""
    import torch

    if sync is None:
        if torch.cuda.is_available():
            def sync(_):
                torch.cuda.synchronize()
        else:
            def sync(_):
                return None
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(burst):
            out = fn(*args)
        sync(out)
        best = min(best, (time.perf_counter() - t0) / burst)
    return best
