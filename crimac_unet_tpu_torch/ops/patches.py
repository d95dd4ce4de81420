"""Sliding-window patch grid construction (host numpy).

Grid semantics match reference batch/samplers/gridded.py:22-95: upper-left
corners at ``start - (overlap+1) + k*stride`` (stride = patch - 2*overlap),
and the +1 data-coordinate shift of ``patch_coord_to_data_coord``
(utils/np.py:378) makes patch k's *interior* tile exactly
``[start + k*stride, start + (k+1)*stride)``.  The patches themselves are
gathered on the device by ``ops.gather_db``.
"""

from __future__ import annotations

import numpy as np


def grid_dims(start: int, end: int, patch: int, overlap: int) -> int:
    """Number of grid positions along one axis
    (== len(np.arange(start-(o+1), end-(o+1), patch-2*o)))."""
    stride = patch - 2 * overlap
    return int(-(-(end - start) // stride))


def grid_centers(start: int, end: int, patch: int, overlap: int) -> np.ndarray:
    """Reference-identical center coordinates along one axis
    (gridded.py:40-47)."""
    ys_upper_left = np.arange(start - (overlap + 1), end - (overlap + 1),
                              patch - 2 * overlap)
    return ys_upper_left + patch // 2


def make_grid_starts(R: int, C: int, stride_y: int, stride_x: int,
                     overlap: int, pad_top: int, pad_left: int):
    """Upper-left coords (in padded-slab coordinates) for an R x C patch grid
    in row-major order (y outer, x inner).

    Patch (i, j) covers slab region starting at
    (i*stride_y - overlap + pad_top, j*stride_x - overlap + pad_left).
    """
    ys = np.arange(R) * stride_y - overlap + pad_top
    xs = np.arange(C) * stride_x - overlap + pad_left
    y0s = np.repeat(ys, C)
    x0s = np.tile(xs, R)
    return y0s.astype(np.int32), x0s.astype(np.int32)
