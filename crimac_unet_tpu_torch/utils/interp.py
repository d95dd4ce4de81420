"""Grid interpolation and rotation primitives.

Counterpart of the reference's legacy multi-dim sampling helpers
(utils/np.py:40-344): index-grid construction, nearest and linear
interpolation in 1/2/3-D with boundary fill, and rotation matrices.  The
modern crop path uses slice+pad crops (utils/grids.py); these exist for API
completeness (the reference's samplers and older pipelines used them).
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm, norm


def get_grid(siz) -> np.ndarray:
    """Centered coordinate grid: axis i spans -((N+1)//2)+1 .. N//2
    (reference utils/np.py:40-47 ``getGrid``)."""
    space = [np.linspace(-((N + 1) // 2) + 1, N // 2, N) for N in siz]
    mesh = np.meshgrid(*space, indexing="ij")
    mesh = [np.expand_dims(ax.ravel(), 0) for ax in mesh]
    return np.concatenate(mesh).reshape([len(siz)] + list(siz))


def coordinate_map(cube) -> np.ndarray:
    """Coordinates of set voxels (reference utils/np.py:49-64)."""
    space = [np.linspace(0, s - 1, s, dtype="uint16") for s in cube.shape]
    grid = np.meshgrid(*space, indexing="ij")
    sel = [x[cube.astype(bool)] for x in grid]
    return np.concatenate([np.expand_dims(m.flatten(), 0) for m in sel],
                          axis=0)


def nearest_interpolation(input_array, inds, boundary_val=0,
                          out_shape=None):
    """Nearest-neighbour sampling at (possibly fractional) index grids with
    out-of-range fill (reference utils/np.py:85-92 + per-dim impls)."""
    input_array = np.asarray(input_array)
    nd = input_array.ndim
    idx = [np.round(np.asarray(inds[d]).ravel()).astype(int)
           for d in range(nd)]
    oob = np.zeros(idx[0].shape, dtype=bool)
    for d in range(nd):
        oob |= (idx[d] < 0) | (idx[d] >= input_array.shape[d])
        idx[d] = np.clip(idx[d], 0, input_array.shape[d] - 1)
    out = input_array[tuple(idx)].astype(np.float64)
    out[oob] = boundary_val
    if out_shape is not None:
        out = out.reshape(out_shape)
    return out


def linear_interpolation(input_array, inds, boundary_val=0, out_shape=None):
    """Multilinear sampling with out-of-range fill
    (reference utils/np.py:78-83 + per-dim impls)."""
    input_array = np.asarray(input_array, dtype=np.float64)
    nd = input_array.ndim
    pos = [np.asarray(inds[d]).ravel().astype(np.float64)
           for d in range(nd)]
    oob = np.zeros(pos[0].shape, dtype=bool)
    lo, frac = [], []
    for d in range(nd):
        oob |= (pos[d] < 0) | (pos[d] > input_array.shape[d] - 1)
        p = np.clip(pos[d], 0, input_array.shape[d] - 1)
        l = np.floor(p).astype(int)
        l = np.minimum(l, input_array.shape[d] - 2) \
            if input_array.shape[d] > 1 else l * 0
        lo.append(l)
        frac.append(p - l)

    out = np.zeros(pos[0].shape, dtype=np.float64)
    for corner in range(2 ** nd):
        idx, w = [], np.ones(pos[0].shape)
        for d in range(nd):
            hi = (corner >> d) & 1
            if input_array.shape[d] > 1:
                idx.append(lo[d] + hi)
                w = w * (frac[d] if hi else (1 - frac[d]))
            else:
                idx.append(lo[d])
                if hi:
                    w = w * 0
        out += w * input_array[tuple(idx)]
    out[oob] = boundary_val
    if out_shape is not None:
        out = out.reshape(out_shape)
    return out


def rotation_matrix_2d(theta) -> np.ndarray:
    """(reference utils/np.py:194-200)"""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def rotation_matrix_3d(axis, theta) -> np.ndarray:
    """Rodrigues rotation via matrix exponential
    (reference utils/np.py:287-291)."""
    axis = np.asarray(axis, dtype=np.float64)
    return expm(np.cross(np.eye(3), axis / norm(axis) * theta))
