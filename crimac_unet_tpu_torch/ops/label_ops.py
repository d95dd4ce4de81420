"""Label sentinel algebra as batched torch tensor ops.

The reference applies these per patch in DataLoader workers
(crimac_unet/batch/label_transforms/*); the JAX package
(``crimac_unet_tpu/ops/label_ops.py``) and the port apply them to whole
sub-batches on the device.  Semantics are held bit-equal to the JAX
package in tests/test_torch_label_ops.py.

Layout: labels (B, H, W) int32, data (B, C, H, W) or, with
``channels_last``, (B, H, W, C) float32 raw sv; H = range rows, W = pings.
"""

from __future__ import annotations

import torch

from ..constants import (BACKGROUND, LABEL_BOUNDARY_VAL, LABEL_IGNORE_VAL,
                         LABEL_OVERLAP_VAL, LABEL_REFINE_BOUNDARY_VAL,
                         LABEL_SEABED_MASK_VAL, LABEL_UNUSED_SPECIES, OTHER,
                         RAW_OTHER, RAW_SANDEEL, SANDEEL)
from .closing import binary_closing
from .morphology import DISC_7X7  # noqa: F401 — the JAX module's name

BIG_ROW = 10 ** 8  # "no seabed in this column" sentinel for seabed vectors

# refine_label_boundary's raw-sv acceptance band (reference
# refine_label_boundary.py:24: 200 kHz sv inside (lo, hi) keeps the label);
# the host-side predicate of quantized-transfer eval uses the same pair
REFINE_THRESHOLD_LO = 1e-7
REFINE_THRESHOLD_HI = 1e-4


def convert_label_indexing(labels: torch.Tensor,
                           mark_unused_species: bool = False
                           ) -> torch.Tensor:
    """Raw species codes {0, 27, 1} -> {0, 1, 2}; everything else IGNORE
    (or UNUSED_SPECIES for positive non-target codes when requested)
    (reference convert_label_indexing.py:24-47)."""
    out = torch.full_like(labels, LABEL_IGNORE_VAL)
    out = torch.where(labels == 0, BACKGROUND, out)
    out = torch.where(labels == RAW_SANDEEL, SANDEEL, out)
    out = torch.where(labels == RAW_OTHER, OTHER, out)
    if mark_unused_species:
        unused = (labels > 0) & (labels != RAW_OTHER) & (labels != RAW_SANDEEL)
        out = torch.where(unused, LABEL_UNUSED_SPECIES, out)
    return out


def _first_true(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` of a bool array: torch's argmax takes no bool, and
    returns the first maximal index as XLA does."""
    return torch.argmax(flags.to(torch.uint8), dim=-1)


def _valid_bbox_mask(valid: torch.Tensor) -> torch.Tensor:
    """Per-sample bounding-box mask of the True region of ``valid``
    (B, H, W): ``np.argwhere(...).min/max`` cropping
    (refine_label_boundary.py:85-96) without dynamic shapes."""
    B, H, W = valid.shape
    rows_any = valid.any(dim=2)  # (B, H)
    cols_any = valid.any(dim=1)  # (B, W)
    y0 = _first_true(rows_any)
    y1 = H - _first_true(rows_any.flip(1))
    x0 = _first_true(cols_any)
    x1 = W - _first_true(cols_any.flip(1))
    rows = torch.arange(H, device=valid.device)[None, :, None]
    cols = torch.arange(W, device=valid.device)[None, None, :]
    return ((rows >= y0[:, None, None]) & (rows < y1[:, None, None])
            & (cols >= x0[:, None, None]) & (cols < x1[:, None, None]))


def refine_label_boundary(data: torch.Tensor, labels: torch.Tensor,
                          threshold_freq_idx: int = -1,
                          threshold_lo: float = REFINE_THRESHOLD_LO,
                          threshold_hi: float = REFINE_THRESHOLD_HI,
                          channels_last: bool = False,
                          threshold_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Inside labelled regions, mark pixels whose high-frequency sv falls
    outside (lo, hi) (after 7x7-disc binary closing of the in-threshold
    mask) as LABEL_REFINE_BOUNDARY_VAL (reference
    refine_label_boundary.py:24-104).

    The closing (ops/closing.py: the K4 kernel on a CUDA tensor) is
    confined to each patch's non-boundary bbox; patches that are entirely
    boundary pass through unchanged (the reference's empty-patch guard,
    :78-84).  ``threshold_mask`` (B, H, W bool), when given, replaces the
    ``lo < data[threshold_freq] < hi`` term: quantized-transfer eval
    computes it on the host from the exact float32 sv."""
    valid = labels != LABEL_BOUNDARY_VAL
    any_valid = valid.any(dim=2).any(dim=1)[:, None, None]

    crop_mask = _valid_bbox_mask(valid)
    if threshold_mask is None:
        d = data[..., threshold_freq_idx] if channels_last \
            else data[:, threshold_freq_idx]
        # the thresholds in the data's dtype, as JAX's weakly typed
        # Python floats compare; filled on the device (no host copy, so
        # the train step has no host sync)
        lo = torch.full((), threshold_lo, dtype=d.dtype, device=d.device)
        hi = torch.full((), threshold_hi, dtype=d.dtype, device=d.device)
        threshold_mask = (d > lo) & (d < hi)
    mask_threshold = (labels > 0) & threshold_mask
    closed = binary_closing(mask_threshold.contiguous(),
                            crop_mask.contiguous())

    relabel = (~closed) & (labels > 0) & crop_mask
    out = torch.where(relabel, LABEL_REFINE_BOUNDARY_VAL, labels)
    # the reference's own dead re-assert (refine_label_boundary.py:103),
    # kept for parity: relabel needs labels > 0, so IGNORE is untouched
    out = torch.where(labels == LABEL_IGNORE_VAL, LABEL_IGNORE_VAL, out)
    return torch.where(any_valid, out, labels)


def mask_label_seabed(labels: torch.Tensor, seabed_row: torch.Tensor
                      ) -> torch.Tensor:
    """BACKGROUND pixels at/below the padded seabed line -> SEABED sentinel
    (reference mask_label_seabed.py:24-68).  ``seabed_row`` (B, W): patch
    row of the first below-seabed pixel per ping column, pad and patch
    offset included; BIG_ROW where there is none."""
    B, H, W = labels.shape
    rows = torch.arange(H, device=labels.device)[None, :, None]
    below = rows >= seabed_row[:, None, :]
    return torch.where(below & (labels == BACKGROUND),
                       LABEL_SEABED_MASK_VAL, labels)


def mask_label_overlap(labels: torch.Tensor, overlap: int) -> torch.Tensor:
    """Frame of ``overlap`` pixels -> OVERLAP sentinel; BOUNDARY wins
    (reference mask_label_overlap.py:23-48)."""
    if overlap == 0:
        return labels
    B, H, W = labels.shape
    rows = torch.arange(H, device=labels.device)[None, :, None]
    cols = torch.arange(W, device=labels.device)[None, None, :]
    interior = ((rows >= overlap) & (rows < H - overlap)
                & (cols >= overlap) & (cols < W - overlap))
    out = torch.where(interior, labels, LABEL_OVERLAP_VAL)
    return torch.where(labels == LABEL_BOUNDARY_VAL, LABEL_BOUNDARY_VAL, out)


def set_label_ignore_val(labels: torch.Tensor) -> torch.Tensor:
    """Collapse {OVERLAP, REFINE, BOUNDARY, UNUSED} -> IGNORE and
    SEABED -> BACKGROUND before metric computation
    (reference pipeline.py:222-239)."""
    out = torch.where((labels == LABEL_OVERLAP_VAL)
                      | (labels == LABEL_REFINE_BOUNDARY_VAL)
                      | (labels == LABEL_BOUNDARY_VAL)
                      | (labels == LABEL_UNUSED_SPECIES),
                      LABEL_IGNORE_VAL, labels)
    return torch.where(out == LABEL_SEABED_MASK_VAL, BACKGROUND, out)
