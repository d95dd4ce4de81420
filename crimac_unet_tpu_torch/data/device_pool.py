"""Device-resident sample pool: training crops gathered on the card.

The port's counterpart of ``crimac_unet_tpu/data/device_pool.py``: the
memmap echograms are uploaded once as padded, stacked canvases (float32
data, int32 labels, a window-sized boundary margin on every side), and
each training or validation step gathers its crops from (echogram, start)
coordinates by torch indexing on the device, so a step ships a few dozen
coordinate bytes instead of ~8 MB of host crops.

Crop semantics equal the host path's (slice + boundary fill as
utils/grids.crop_bounds, non-finite sv scrubbed to 0 as
``Echogram.crop_data``, the window-taller-than-column recentering in
``prepare_center``).  ``pool_bytes`` / ``fits_budget`` gate the pool in
pipeline/train.py.  The zarr pool comes with zarr training (ROADMAP A1b).

    pool = DeviceSamplePool(readers, frequencies, window, device)
    idxs, starts = pool.prepare_batch(host_samples)
    data, labels = gather_crops(pool.data, pool.labels, idxs, starts,
                                pool.window)
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DATA_BOUNDARY_VAL, LABEL_BOUNDARY_VAL


def canvas_dims(readers, window) -> tuple:
    """(E, H, W, Hp, Wp): padded-canvas geometry shared by the budget gate
    (``pool_bytes``) and the pool constructor, so the gate cannot drift
    from the allocation."""
    wh, ww = window
    H = max(r.shape[0] for r in readers)   # memmap (range, ping)
    W = max(r.shape[1] for r in readers)
    return len(readers), H, W, H + 2 * wh, W + 2 * ww


def pool_bytes(readers, frequencies, window) -> int:
    """Device footprint of pooling these readers: padded float32 data
    canvas + int32 labels canvas (both with a window-sized margin)."""
    E, _, _, Hp, Wp = canvas_dims(readers, window)
    cells = E * Hp * Wp
    return cells * len(frequencies) * 4 + cells * 4


def fits_budget(readers, frequencies, window, budget_mb=2048) -> bool:
    return pool_bytes(readers, frequencies, window) <= budget_mb * 2 ** 20


class DeviceSamplePool:
    def __init__(self, readers, frequencies, window, device):
        if not all(r.data_format == "memmap" for r in readers):
            raise NotImplementedError(
                "DeviceSamplePool holds memmap echograms; the zarr sample "
                "pool comes with zarr training (ROADMAP.md queue A, A1b)")
        self.window = tuple(window)
        # caller order, like the host crop path (RandomPatchDataset stacks
        # channels as given)
        self.frequencies = list(frequencies)
        self.readers = list(readers)
        self.index = {id(r): i for i, r in enumerate(readers)}
        wh, ww = self.window

        E, H, W, Hp, Wp = canvas_dims(readers, window)
        C = len(self.frequencies)
        data = np.zeros((E, C, Hp, Wp), np.float32)
        labels = np.full((E, Hp, Wp), LABEL_BOUNDARY_VAL, np.int32)
        for i, r in enumerate(readers):
            h, w = r.shape
            raw = np.stack([np.asarray(m) for m in
                            r.data_memmaps(self.frequencies)])
            data[i, :, wh:wh + h, ww:ww + w] = np.nan_to_num(
                raw, nan=DATA_BOUNDARY_VAL, posinf=DATA_BOUNDARY_VAL,
                neginf=DATA_BOUNDARY_VAL)
            # the canvas outside the data keeps the boundary fills (0 for
            # data, BOUNDARY for labels)
            labels[i, wh:wh + h, ww:ww + w] = np.asarray(r.label_memmap())
        self.data = torch.from_numpy(data).to(device)
        self.labels = torch.from_numpy(labels).to(device)

    def prepare_center(self, reader, center):
        """Host-side: map a sampler (center, reader) to pool coordinates,
        applying the host crop's window-taller-than-column recentering
        (reference dataset.py:259-261)."""
        wh, ww = self.window
        y, x = int(center[0]), int(center[1])
        if reader.shape[0] <= wh:
            y = reader.shape[0] // 2
        # crop upper-left in padded-canvas coordinates (origin convention
        # shared with utils/grids.crop_bounds — (N+1)//2)
        y0 = y - (wh + 1) // 2 + 1 + wh
        x0 = x - (ww + 1) // 2 + 1 + ww
        return self.index[id(reader)], y0, x0

    def prepare_batch(self, samples):
        """[(reader, center), ...] -> (ech_idx (B,), starts (B, 2)) int32."""
        idxs, starts = [], []
        for reader, center in samples:
            e, y0, x0 = self.prepare_center(reader, center)
            idxs.append(e)
            starts.append((y0, x0))
        return (np.asarray(idxs, np.int32),
                np.asarray(starts, np.int32))


def gather_crops(pool_data: torch.Tensor, pool_labels: torch.Tensor,
                 ech_idx: torch.Tensor, starts: torch.Tensor, window):
    """(B,) echogram indices + (B, 2) crop upper-lefts (padded canvas
    coordinates) -> data (B, C, wh, ww) float32 and labels (B, wh, ww)
    int32, by indexing on the pool's device.  Starts are clamped into the
    canvas, as ``jax.lax.dynamic_slice`` clamps them in the JAX package."""
    wh, ww = window
    _, _, Hp, Wp = pool_data.shape
    dev = pool_data.device
    e = ech_idx.to(dev, torch.int64)[:, None, None]
    y0 = starts[:, 0].to(dev, torch.int64).clamp(0, Hp - wh)
    x0 = starts[:, 1].to(dev, torch.int64).clamp(0, Wp - ww)
    rows = (y0[:, None] + torch.arange(wh, device=dev))[:, :, None]
    cols = (x0[:, None] + torch.arange(ww, device=dev))[:, None, :]
    labels = pool_labels[e, rows, cols]
    # a slice between the advanced indices puts their (B, wh, ww) first
    data = pool_data[e, :, rows, cols].permute(0, 3, 1, 2).contiguous()
    return data, labels
