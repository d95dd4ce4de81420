"""Shared primitives of the gridded predict and eval pipelines.

Quantization laws (h2d dB codes, d2h probability codes), the device-side
bit-unpack for packed predicate masks, the host label conversion of
quantized-transfer eval, the HWC slab filler, the reference grid-extent
law and the static-grid and metadata grid helpers — used by
pipeline/predict.py, pipeline/eval_gridded.py and pipeline/runner.py.  Same
laws as the JAX package's
``crimac_unet_tpu/pipeline/infer_common.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (BACKGROUND, LABEL_IGNORE_VAL, LABEL_UNUSED_SPECIES,
                         OTHER, RAW_OTHER, RAW_SANDEEL, SANDEEL)
from ..data.blosc_codec import CVT_F32_BF16
from ..ops.data_ops import DB_U8_SCALE
from ..ops.patches import grid_dims


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _unpack_bits(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Device-side inverse of ``np.packbits(mask, axis=1)`` (big-endian
    bit order): (H, ceil(n/8)) uint8 -> (H, n_cols) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_cols] != 0


# output_dtype='uint8' d2h codes: code -> float16(code / 255), the value
# written to the prediction store.  One 256-entry table keeps the
# dequantization a single fancy-index on the host drain path.
_U8_PROB_DEQUANT = (np.arange(256, dtype=np.float32)
                    / np.float32(255.0)).astype(np.float16)


def _quantize_prob_u8(probs: torch.Tensor) -> torch.Tensor:
    """The output_dtype='uint8' quantization law: codes ``round(p * 255)``
    (half to even, as ``jnp.round``) — softmax outputs are finite in
    [0, 1], so the round-then-cast is exact and masked pixels (0.0) map
    to code 0; dequant = code / 255 (``_U8_PROB_DEQUANT``)."""
    return torch.round(probs * 255.0).to(torch.uint8)


def _quantize_db_u8(x):
    """Host-side dB transform + clip + 8-bit quantization
    (transfer_dtype='uint8' serving mode).

    Matches the device chain scrub -> db_with_limits exactly for
    non-finite sv: scrub to 0 FIRST (doing it after the log would let +inf
    slip through the clip as 0 dB full-signal), then dB(1e-10) = -100 ->
    clipped -75 -> code 0.  One documented divergence: NEGATIVE sv yields
    NaN through the exact chain's log10; uint8 codes cannot carry NaN, so
    negatives clamp to code 0 (-75 dB) instead (DIVERGENCES.md)."""
    x = np.where(np.isfinite(x), x, np.float32(0.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        d = (10.0 * np.log10(x + 1e-10)).astype(np.float32, copy=False)
    np.clip(d, -75.0, 0.0, out=d)        # negatives' NaN survives clip ...
    d = np.where(np.isfinite(d), d, -75.0)  # ... scrub it to the floor
    d += 75.0
    d *= DB_U8_SCALE
    d += 0.5                             # round-half-up via the trunc cast
    return d.astype(np.uint8)


def _convert_labels_host(labels):
    """Host mirror of the device label conversion of the float32 eval path
    (gathered labels cast to int32 by truncation, then
    ``convert_label_indexing(..., mark_unused_species=True)``), shipped as
    int8 under a quantized transfer: raw codes {0, 27, 1} -> {0, 1, 2},
    other positive codes -> LABEL_UNUSED_SPECIES, the rest ->
    LABEL_IGNORE_VAL; fractional codes truncate (27.5 -> SANDEEL, -0.5 ->
    BACKGROUND); non-finite values map to LABEL_IGNORE_VAL."""
    if np.issubdtype(labels.dtype, np.floating):
        labels = np.where(np.isfinite(labels), labels,
                          float(LABEL_IGNORE_VAL))
    li = labels.astype(np.int32)  # device-equal truncation
    out = np.full(li.shape, LABEL_IGNORE_VAL, np.int8)
    out[li == 0] = BACKGROUND
    out[li == RAW_SANDEEL] = SANDEEL
    out[li == RAW_OTHER] = OTHER
    unused = (li > 0) & (li != RAW_SANDEEL) & (li != RAW_OTHER)
    out[unused] = LABEL_UNUSED_SPECIES
    return out


def _fill_hwc_slab(reader, frequencies, data_slab, slab_x0, slab_x1,
                   slab_y1, row_off, x_off):
    """Read survey columns [slab_x0, slab_x1) x rows [0, slab_y1) for all
    ``frequencies`` and write them into ``data_slab`` (an (Hs, Wp, C)
    HWC-layout host array) at (row_off, x_off).  A ``np.uint16`` slab
    receives bfloat16 bit patterns (zarr surveys only: the codec's
    converting decode)."""
    w = slab_x1 - slab_x0
    if w <= 0:
        return
    if reader.data_format == "zarr":
        # one decode + scatter straight into the HWC slab (no
        # intermediate (C, ping, range) buffer, no transpose pass)
        reader.read_data_into(
            slab_x0, w, 0, slab_y1, frequencies, data_slab,
            np.s_[row_off:row_off + slab_y1, x_off:x_off + w, :],
            cvt=CVT_F32_BF16 if data_slab.dtype == np.uint16 else 0)
        return
    # per-channel strided assignment: one pass, no stacked temporary
    for c, m in enumerate(reader.data_memmaps(frequencies)):
        data_slab[row_off:row_off + slab_y1, x_off:x_off + w, c] = \
            m[:slab_y1, slab_x0:slab_x1]


def grid_center_cols(x0_data, ww):
    """Patch-center ping coordinates from crop-origin ping coordinates: the
    inverse of the reference crop law on the ping axis for both window
    parities (origin = center - (ww+1)//2 + 1, so center = origin - 1 +
    (ww+1)//2)."""
    return np.asarray(x0_data) - 1 + (ww + 1) // 2


def _grid_extent_rows(n_range: int, seabed, known, wh: int, o: int) -> int:
    """Reference grid height (patch-grid rows) for one seabed vector: range
    capped at max seabed + 50, pings WITHOUT a seabed estimate counting as
    full water column (gridded.py:121-163)."""
    sb_eff = np.where(known, seabed, n_range)
    end_range = int(min(max(sb_eff.max() + 50, 1), n_range))
    return grid_dims(0, end_range, wh, o)


def grid_height_for_reader(reader, wh: int, o: int,
                           start_ping: int = 0) -> int:
    """Reference grid height (patch-grid rows) for one reader, by the
    extent law of evaluate_reader and predict_reader.  Callers evaluating
    several readers under ``static_grid`` take the max over readers and
    pass it as ``fixed_R``; ``start_ping`` restricts the seabed scan to
    the pings a prediction starting there covers."""
    if reader.data_format == "zarr":
        n_pings, n_range = reader.shape
    else:
        n_range, n_pings = reader.shape
    sb = np.asarray(reader.get_seabed(0, n_pings)).astype(np.int64)
    has = np.asarray(reader.seabed_known(0, n_pings))
    return _grid_extent_rows(n_range, sb[start_ping:], has[start_ping:],
                             wh, o)
