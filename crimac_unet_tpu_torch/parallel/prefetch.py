"""Host-to-device batch prefetching on one device.

The port's counterpart of ``crimac_unet_tpu/parallel/prefetch.py``: the
copies of the next ``depth`` batches are in flight while the device runs
the current one.  On a CUDA device each host array goes through pinned
memory with a ``non_blocking`` copy on the current stream, so the copy
neither waits for the host nor stalls the queue; PyTorch's pinned-memory
cache keeps the host buffer until its copy has run.  Multi-device
sharding waits for ROADMAP A3.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def _put(batch: dict, device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def device_prefetch(iterator, device, depth: int = 2):
    """Yield the host batches (dicts of numpy arrays) of ``iterator`` as
    dicts of tensors on ``device``, ``depth`` batches ahead (at least
    one: a depth of 0 would yield nothing)."""
    device = torch.device(device)
    depth = max(1, int(depth))
    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(_put(batch, device))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
