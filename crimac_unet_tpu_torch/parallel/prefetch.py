"""Host-to-device batch prefetching on one device.

The port's counterpart of ``crimac_unet_tpu/parallel/prefetch.py``: the
copies of the next ``depth`` batches are in flight while the device runs
the current one.  On a CUDA device each host array goes through pinned
memory with a ``non_blocking`` copy on the current stream, so the copy
neither waits for the host nor stalls the queue; PyTorch's pinned-memory
cache keeps the host buffer until its copy has run.  Under a data mesh
(parallel/mesh.py) only this rank's rows of each batch are copied: the
crops, or the pooled ``ech_idx`` / ``starts`` coordinates, alike.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .mesh import checked_shard


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


def device_prefetch(iterator, device=None, depth: int = 2, mesh=None):
    """Yield the host batches (dicts of numpy arrays) of ``iterator`` as
    dicts of tensors on ``device`` (cuda when None), ``depth`` batches
    ahead (at least one: a depth of 0 would yield nothing); with a
    ``mesh``, this rank's shard of each batch (``checked_shard``: every
    leading axis must divide by the mesh size)."""
    device = torch.device("cuda" if device is None else device)
    depth = max(1, int(depth))
    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(_put(checked_shard(batch, mesh), device))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
