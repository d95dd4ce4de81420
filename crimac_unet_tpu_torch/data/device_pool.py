"""Device-resident sample pools: training crops gathered on the card.

The port's counterpart of ``crimac_unet_tpu/data/device_pool.py``: the
survey data are uploaded once as padded, stacked canvases (float32 data,
int32 labels, a window-sized boundary margin on every side), and each
training or validation step gathers its crops from (echogram, start)
coordinates by torch indexing on the device, so a step ships a few dozen
coordinate bytes instead of ~8 MB of host crops.

* ``DeviceSamplePool`` holds memmap echograms; with metadata channels it
  also holds each echogram's metadata vectors (a few KB), from which
  :func:`gather_meta_crops` computes the (B, M, wh, ww) metadata crops on
  the device.
* ``ZarrSamplePool`` holds zarr surveys, streamed to the canvas
  allocated once on the device in ping chunks (bounded host memory);
  metadata channels are memmap-only and it refuses them.

Crop semantics equal the host path's (slice + boundary fill as
utils/grids.crop_bounds; the memmap scrub of ``Echogram.crop_data``, the
zarr scrub of ``DataReaderZarr.crop_data``; the memmap
window-taller-than-column recentering in ``prepare_center``).
``pool_bytes`` / ``fits_budget`` gate the pools in pipeline/train.py.

    pool = DeviceSamplePool(readers, frequencies, window, device)
    idxs, starts = pool.prepare_batch(host_samples)
    data, labels = gather_crops(pool.data, pool.labels, idxs, starts,
                                pool.window)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import DATA_BOUNDARY_VAL, LABEL_BOUNDARY_VAL

# reference metadata channel order (batch/dataset.py:288-351)
META_ORDER = ("portion_year", "portion_day", "time_diff", "depth_rel",
              "depth_abs_surface", "depth_abs_seabed")


def canvas_dims(readers, window) -> tuple:
    """(E, H, W, Hp, Wp): padded-canvas geometry shared by the budget gate
    (``pool_bytes``) and both pool constructors, so the gate cannot drift
    from the allocation.  Memmap readers are (range, ping), zarr readers
    (ping, range)."""
    wh, ww = window
    if readers[0].data_format == "memmap":
        H = max(r.shape[0] for r in readers)
        W = max(r.shape[1] for r in readers)
    else:
        H = max(r.shape[1] for r in readers)
        W = max(r.shape[0] for r in readers)
    return len(readers), H, W, H + 2 * wh, W + 2 * ww


def pool_bytes(readers, frequencies, window) -> int:
    """Device footprint of pooling these readers: padded float32 data
    canvas + int32 labels canvas (both with a window-sized margin)."""
    E, _, _, Hp, Wp = canvas_dims(readers, window)
    cells = E * Hp * Wp
    return cells * len(frequencies) * 4 + cells * 4


def fits_budget(readers, frequencies, window, budget_mb=2048) -> bool:
    return pool_bytes(readers, frequencies, window) <= budget_mb * 2 ** 20


def meta_vector_arrays(readers, meta_channels, device) -> tuple:
    """Per-echogram metadata vectors on ``device`` for
    :func:`gather_meta_crops`: portion of day, time step and seabed row
    padded to the widest echogram (float32), the portion of year
    (float32) and the ping counts (int32) for the index clamp."""
    E = len(readers)
    W = max(r.shape[1] for r in readers)
    pod = np.zeros((E, W), np.float32)
    tdiff = np.zeros((E, W), np.float32)
    seabed = np.zeros((E, W), np.float32)
    pyear = np.zeros((E,), np.float32)
    npings = np.zeros((E,), np.int32)
    mc = meta_channels
    need_sb = any(mc.get(k) for k in ("depth_rel", "depth_abs_surface",
                                      "depth_abs_seabed"))
    for i, r in enumerate(readers):
        n = r.shape[1]
        npings[i] = n
        if mc.get("portion_year"):
            pyear[i] = r.portion_of_year_scalar
        if mc.get("portion_day"):
            pod[i, :n] = r.portion_of_day_vector
        if mc.get("time_diff"):
            tdiff[i, :n] = r.time_vector_diff
        if need_sb:
            seabed[i, :n] = np.asarray(r.get_seabed(0, n))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (pod, tdiff, seabed, pyear, npings))


def gather_meta_crops(pod, tdiff, seabed, pyear, npings, ech_idx, starts,
                      window, flags) -> torch.Tensor:
    """(B, M, wh, ww) float32 metadata crops computed on the vectors'
    device from pool coordinates, the counterpart of the JAX package's
    ``_gather_meta_crops``: the sampler center is recovered from the
    canvas start (inverting ``prepare_center``, recentering included),
    then ``crop_meta``'s ``arange(c - w//2, c + w//2)`` grid (no +1
    shift: the meta grid sits one pixel off the data crop for even
    windows) and its ping-index clamp.  ``flags`` names the enabled
    families in ``META_ORDER``."""
    wh, ww = window
    dev = pod.device
    e = ech_idx.to(dev, torch.int64)
    s = starts.to(dev, torch.int64)
    n = npings[e].to(torch.int64)
    # prepare_center: start = center - (w+1)//2 + 1 + pad
    yc = s[:, 0] + ((wh + 1) // 2 - 1 - wh)
    xc = s[:, 1] + ((ww + 1) // 2 - 1 - ww)
    r = (torch.arange(wh, device=dev, dtype=torch.float32)[None, :]
         + (yc - wh // 2).to(torch.float32)[:, None])            # (B, wh)
    c = torch.arange(ww, device=dev)[None, :] + (xc - ww // 2)[:, None]
    c = torch.minimum(torch.clamp(c, min=0), (n - 1)[:, None])   # (B, ww)
    B = e.shape[0]
    shape = (B, wh, ww)
    parts = []
    if "portion_year" in flags:
        parts.append(pyear[e][:, None, None].expand(shape))
    if "portion_day" in flags:
        xcc = torch.minimum(torch.clamp(xc, min=0), n - 1)
        ang = (2 * math.pi) * pod[e, xcc]
        parts.append(torch.sin(ang)[:, None, None].expand(shape))
        parts.append(torch.cos(ang)[:, None, None].expand(shape))
    if "time_diff" in flags:
        parts.append(tdiff[e[:, None], c][:, None, :].expand(shape))
    sb = seabed[e[:, None], c][:, None, :]                       # (B, 1, ww)
    rr = r[:, :, None]                                           # (B, wh, 1)
    if "depth_rel" in flags:
        parts.append(rr / sb)
    if "depth_abs_surface" in flags:
        parts.append((rr / wh).expand(shape))
    if "depth_abs_seabed" in flags:
        parts.append((sb - rr) / wh)
    return torch.stack(parts, dim=1).contiguous()


class DeviceSamplePool:
    data_format = "memmap"

    def __init__(self, readers, frequencies, window, device,
                 meta_channels=None):
        if not all(r.data_format == "memmap" for r in readers):
            raise ValueError(
                "DeviceSamplePool holds memmap echograms; use "
                "ZarrSamplePool for zarr surveys")
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
        self.meta_flags = ()
        self.meta_vectors = None
        if meta_channels and any(meta_channels.values()):
            if wh % 2 or ww % 2:
                # crop_meta, the host path this must equal, rejects odd
                # windows
                raise ValueError(
                    f"metadata channels require even patch dims, got "
                    f"{self.window} (see data/meta_channels.crop_meta)")
            self.meta_flags = tuple(k for k in META_ORDER
                                    if meta_channels.get(k))
            self.meta_vectors = meta_vector_arrays(readers, meta_channels,
                                                   device)

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


class ZarrSamplePool:
    """Zarr surveys on the device with the same gather interface.

    Each survey's (freq, ping, range) data are read ``chunk_pings`` pings
    at a time, scrubbed on the host and copied into their place in the
    canvas, which holds the boundary fills everywhere else.  The scrub is
    the host crop's (``nan_to_num`` with ``nan`` only, so +-Inf become
    +-3.4e38); the categorical label overlay is int32 with NaN as
    BOUNDARY."""

    data_format = "zarr"
    meta_flags = ()
    meta_vectors = None

    def __init__(self, readers, frequencies, window, device,
                 meta_channels=None, chunk_pings=2048):
        if not all(r.data_format == "zarr" for r in readers):
            raise ValueError("ZarrSamplePool holds zarr surveys; use "
                             "DeviceSamplePool for memmap echograms")
        if meta_channels and any(meta_channels.values()):
            raise ValueError("metadata channels are memmap-only (reference "
                             "dataset.py:245-252); ZarrSamplePool cannot "
                             "carry them")
        self.window = tuple(window)
        self.frequencies = list(frequencies)
        self.readers = list(readers)
        self.index = {id(r): i for i, r in enumerate(readers)}
        wh, ww = self.window

        E, _, _, Hp, Wp = canvas_dims(readers, window)
        C = len(self.frequencies)
        self.data = torch.zeros((E, C, Hp, Wp), dtype=torch.float32,
                                device=device)
        self.labels = torch.full((E, Hp, Wp), LABEL_BOUNDARY_VAL,
                                 dtype=torch.int32, device=device)
        for i, r in enumerate(readers):
            n_pings, n_range = r.shape
            for s in range(0, n_pings, chunk_pings):
                n = min(chunk_pings, n_pings - s)
                raw = r.get_data_slice(s, n, 0, n_range, self.frequencies)
                data = np.nan_to_num(
                    np.asarray(raw, np.float32).swapaxes(1, 2),
                    nan=DATA_BOUNDARY_VAL)
                labels = np.nan_to_num(r.get_label_slice(s, n, 0, n_range).T,
                                       nan=LABEL_BOUNDARY_VAL)
                self.data[i, :, wh:wh + n_range, ww + s:ww + s + n].copy_(
                    torch.from_numpy(data))
                self.labels[i, wh:wh + n_range, ww + s:ww + s + n].copy_(
                    torch.from_numpy(labels.astype(np.int32)))

    def prepare_center(self, reader, center):
        """Zarr crops never recenter (reference get_crop_zarr clips and
        pads instead, dataset.py:358-407)."""
        wh, ww = self.window
        y0 = int(center[0]) - (wh + 1) // 2 + 1 + wh
        x0 = int(center[1]) - (ww + 1) // 2 + 1 + ww
        return self.index[id(reader)], y0, x0

    prepare_batch = DeviceSamplePool.prepare_batch


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
