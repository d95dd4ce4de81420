"""Sliding-window patch grid construction (host numpy).

Grid semantics match reference batch/samplers/gridded.py:22-95: upper-left
corners at ``start - (overlap+1) + k*stride`` (stride = patch - 2*overlap),
and the +1 data-coordinate shift of ``patch_coord_to_data_coord``
(utils/np.py:378) makes patch k's *interior* tile exactly
``[start + k*stride, start + (k+1)*stride)``.  The inference patches
themselves are gathered on the device by ``ops.gather_db``;
``extract_patches_2d`` / ``_3d`` are the JAX package's general gathers
as torch indexing, ``pad_slab_2d`` / ``_3d`` its host pads.
"""

from __future__ import annotations

import numpy as np
import torch


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


def window_starts(starts, dim: int, size: int, device) -> torch.Tensor:
    """Window starts along one axis as ``jax.lax.dynamic_slice`` takes
    them: a negative start counts from the end, then every start is
    clamped so the window lies inside the axis."""
    s = torch.as_tensor(starts, device=device).to(torch.int64)
    return torch.where(s < 0, s + dim, s).clamp(0, dim - size)


def _window_index(y0s, x0s, H, W, wh, ww, device):
    """(N, wh, 1) rows and (N, 1, ww) columns of N windows."""
    y0 = window_starts(y0s, H, wh, device)
    x0 = window_starts(x0s, W, ww, device)
    rows = (y0[:, None] + torch.arange(wh, device=device))[:, :, None]
    cols = (x0[:, None] + torch.arange(ww, device=device))[:, None, :]
    return rows, cols


def extract_patches_2d(slab: torch.Tensor, y0s, x0s, wh: int,
                       ww: int) -> torch.Tensor:
    """Gather N patches of (wh, ww) from a 2-D slab at upper-left coords
    (y0s, x0s).  Starts must be in range (the host pads the slab); others
    are taken as ``jax.lax.dynamic_slice`` takes them (``window_starts``).
    Returns (N, wh, ww)."""
    rows, cols = _window_index(y0s, x0s, *slab.shape, wh, ww, slab.device)
    return slab[rows, cols]


def extract_patches_3d(slab: torch.Tensor, y0s, x0s, wh: int,
                       ww: int) -> torch.Tensor:
    """(C, H, W) slab -> (N, C, wh, ww) patches."""
    rows, cols = _window_index(y0s, x0s, *slab.shape[1:], wh, ww,
                               slab.device)
    # a slice before the advanced indices leaves their (N, wh, ww) last
    return slab[:, rows, cols].permute(1, 0, 2, 3).contiguous()


def pad_slab_2d(slab: np.ndarray, pad_top: int, pad_bottom: int,
                pad_left: int, pad_right: int, fill) -> np.ndarray:
    return np.pad(slab, ((pad_top, pad_bottom), (pad_left, pad_right)),
                  constant_values=fill)


def pad_slab_3d(slab: np.ndarray, pad_top: int, pad_bottom: int,
                pad_left: int, pad_right: int, fill) -> np.ndarray:
    return np.pad(slab, ((0, 0), (pad_top, pad_bottom),
                         (pad_left, pad_right)), constant_values=fill)
