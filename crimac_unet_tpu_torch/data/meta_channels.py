"""Metadata channel extraction for memmap echograms.

The port's copy of the JAX package's jax-free
``crimac_unet_tpu/data/meta_channels.py``.

The six channel families of the reference (batch/dataset.py:288-351),
appended to the acoustic channels when ``meta_channels`` is configured:

  portion_year      (1) survey-time scalar, constant per echogram
  portion_day       (2) sin/cos of time-of-day at the patch center ping
  time_diff         (1) per-ping time-step vector broadcast over rows
  depth_rel         (1) row / seabed_row(col)
  depth_abs_surface (1) row / window_height
  depth_abs_seabed  (1) (seabed_row(col) - row) / window_height

Row/column index conventions match the reference exactly, including its
use of ``arange(center - w//2, center + w//2)`` WITHOUT the +1 shift used by
the data crop, and index clamping to [0, last].

The reference only supports metadata for memmap readers (its zarr crop path
never returns meta); we keep that contract.
"""

from __future__ import annotations

import numpy as np

META_CHANNEL_WEIGHTS = {
    "portion_year": 1,
    "portion_day": 2,
    "depth_rel": 1,
    "depth_abs_surface": 1,
    "depth_abs_seabed": 1,
    "time_diff": 1,
}

META_CHANNEL_KEYS = set(META_CHANNEL_WEIGHTS)


def get_in_channels(meta_channels) -> int:
    """Number of metadata input channels (reference pipeline.py:413-425).

    Validates first: a partial dict (e.g. ``meta_channels:
    {portion_year: 1}``) used to die with a bare ``KeyError`` from the
    train wiring before ``validate_meta_channels`` ever ran on that
    path."""
    if not meta_channels:
        return 0
    validate_meta_channels(meta_channels)
    return int(sum(int(meta_channels[k]) * w
                   for k, w in META_CHANNEL_WEIGHTS.items()))


def validate_meta_channels(meta_channels) -> None:
    if not meta_channels:
        return
    if not hasattr(meta_channels, "keys"):
        raise ValueError(
            f"meta_channels must be a mapping of the six channel-family "
            f"flags (or empty), got {type(meta_channels).__name__}")
    # the reference accepts 0/1 ints in the YAML (it only multiplies /
    # truth-tests them) — reject anything else, but don't break
    # reference-era configs that worked upstream
    if not all(isinstance(v, (bool, int)) and v in (0, 1)
               for v in meta_channels.values()):
        raise ValueError("meta_channels values must be booleans (0/1)")
    if set(meta_channels.keys()) != META_CHANNEL_KEYS:
        raise ValueError(
            f"meta_channels keys must be {sorted(META_CHANNEL_KEYS)}")


def crop_meta(echogram, center, window, meta_channels) -> np.ndarray:
    """(M, H, W) metadata channels for one patch
    (reference batch/dataset.py:288-351)."""
    if echogram.data_format != "memmap":
        raise ValueError("metadata channels are memmap-only (reference "
                         "dataset.py:245-252)")
    wh, ww = window
    if wh % 2 or ww % 2:
        # the reference meta grid arange(c - w//2, c + w//2) yields w-1
        # elements for odd w (np.stack then fails on mismatched shapes)
        # while the pooled device path always fills the window — fail
        # loudly instead of crashing opaquely / diverging silently
        raise ValueError(
            f"metadata channels require even patch dims, got {window} "
            "(reference dataset.py:288-351 arange grid law)")
    # same water-column recenter as crop_data/crop_labels: the reference
    # mutates the SHARED center_location in place before its meta block
    # (dataset.py:260-261), so meta rows must describe the recentered
    # crop, not the sampler's raw center
    center = list(center)
    if echogram.shape[0] <= wh:
        center[0] = echogram.shape[0] // 2
    meta = []

    if meta_channels.get("portion_year"):
        meta.append(np.full((wh, ww), echogram.portion_of_year_scalar))

    if meta_channels.get("portion_day"):
        idx = int(center[1])
        if idx < 0:
            idx = 0
        if idx >= echogram.portion_of_day_vector.size:
            idx = -1
        pd = echogram.portion_of_day_vector[idx]
        meta.append(np.full((wh, ww), np.sin(2 * np.pi * pd)))
        meta.append(np.full((wh, ww), np.cos(2 * np.pi * pd)))

    if meta_channels.get("time_diff"):
        crop_idx = np.arange(center[1] - ww // 2, center[1] + ww // 2)
        crop_idx[crop_idx < 0] = 0
        crop_idx[crop_idx >= echogram.time_vector_diff.size] = -1
        row = echogram.time_vector_diff[crop_idx]
        meta.append(row.reshape(1, -1) * np.ones((wh, 1)))

    if any(meta_channels.get(k) for k in
           ("depth_rel", "depth_abs_surface", "depth_abs_seabed")):
        seabed = echogram.get_seabed(0, echogram.shape[1])
        rows = np.arange(center[0] - wh // 2, center[0] + wh // 2)
        cols = np.arange(center[1] - ww // 2, center[1] + ww // 2)
        cols[cols < 0] = 0
        cols[cols >= seabed.size] = -1

        if meta_channels.get("depth_rel"):
            meta.append(rows.reshape(-1, 1) / seabed[cols].reshape(1, -1))
        if meta_channels.get("depth_abs_surface"):
            meta.append(rows.reshape(-1, 1) * np.ones((1, ww)) / wh)
        if meta_channels.get("depth_abs_seabed"):
            meta.append((seabed[cols].reshape(1, -1)
                         - rows.reshape(-1, 1)) / wh)

    if not meta:
        return np.zeros((0, wh, ww), np.float32)
    return np.stack(meta).astype(np.float32)
