"""Regridding of echograms and predictions onto fixed ping-rate / range
grids.

Counterpart of reference data_preprocessing/regridding.py:35-362, which used
Iris ``AreaWeighted``/``Nearest`` cube regridding.  Iris is not available
here; for rectilinear 1-D x 1-D grids area-weighted regridding is separable,
so this implements exact 1-D overlap-weighted averaging per axis (with
missing-data tolerance like ``mdtol=1``) and nearest-neighbour regridding,
plus the energy-conservation sanity check.
"""

from __future__ import annotations

import numpy as np


def _edges(centers: np.ndarray) -> np.ndarray:
    """Cell edges from cell centers (iris guess_bounds contract)."""
    centers = np.asarray(centers, dtype=np.float64)
    if centers.size < 2:
        # iris guess_bounds also refuses: a single center defines no
        # cell width (the old mid[0] read crashed with IndexError)
        raise ValueError(
            "area regridding needs >= 2 cell centers per axis, got "
            f"{centers.size}")
    mid = (centers[1:] + centers[:-1]) / 2
    first = centers[0] - (mid[0] - centers[0])
    last = centers[-1] + (centers[-1] - mid[-1])
    return np.concatenate([[first], mid, [last]])


def _monotonic_keep(time_vector: np.ndarray) -> np.ndarray:
    """Indices of the pings kept after iterating the reference's
    negative-time-step drop (regridding.py:72-74) to a fixed point.

    The reference drops only the single ping AFTER each negative diff;
    a multi-ping backward clock jump leaves the axis still
    non-monotonic, which silently forces the dense overlap fallback
    (~20 GB at survey scale) and garbage weights.  One pass is identical
    to the reference for the single-dip inputs it handled; iterating
    converges (each round strictly shrinks) for the rest."""
    t = np.asarray(time_vector, dtype=np.float64)
    keep = np.arange(t.size)
    while t.size > 1:
        bad = np.argwhere(t[1:] - t[:-1] < 0)
        if not len(bad):
            break
        sel = np.setdiff1d(np.arange(t.size), (bad + 1).ravel())
        keep = keep[sel]
        t = t[sel]
    return keep


def _overlap_matrix(src_centers, dst_centers):
    """(n_dst, n_src) overlap lengths between source and target cells."""
    se = _edges(src_centers)
    de = _edges(dst_centers)
    lo = np.maximum(de[:-1, None], se[None, :-1])
    hi = np.minimum(de[1:, None], se[None, 1:])
    return np.clip(hi - lo, 0.0, None)


def _overlap_weights(src_centers, dst_centers):
    """Overlap weights as a sparse (n_dst, n_src) matrix.

    The overlap structure is banded — each target cell overlaps a handful
    of contiguous source cells — so the weights are built with
    searchsorted in O(nnz) instead of materializing the dense
    (n_dst, n_src) matrix (which is ~20 GB for a 50k-ping time-axis
    regrid).  Falls back to the dense matrix for non-monotonic center
    vectors (never produced by echogram grids)."""
    from scipy import sparse
    se = _edges(src_centers)
    de = _edges(dst_centers)
    if np.any(np.diff(se) <= 0) or np.any(np.diff(de) <= 0):
        return sparse.csr_matrix(_overlap_matrix(src_centers, dst_centers))
    n_src = len(src_centers)
    n_dst = len(dst_centers)
    j0 = np.clip(np.searchsorted(se, de[:-1], side="right") - 1, 0,
                 n_src - 1)
    j1 = np.clip(np.searchsorted(se, de[1:], side="left"), j0 + 1, n_src)
    K = int((j1 - j0).max())
    cols = j0[:, None] + np.arange(K)[None, :]
    valid = cols < j1[:, None]
    cols = np.clip(cols, 0, n_src - 1)
    lo = np.maximum(de[:-1, None], se[cols])
    hi = np.minimum(de[1:, None], se[cols + 1])
    w = np.clip(hi - lo, 0.0, None) * valid
    rows = np.repeat(np.arange(n_dst), K)
    return sparse.csr_matrix((w.ravel(), (rows, cols.ravel())),
                             shape=(n_dst, n_src))


def area_weighted_regrid_1d(data, src_centers, dst_centers, axis=0):
    """Overlap-weighted mean along one axis; nan source cells are excluded
    from the average (all-nan target cells become nan), matching
    AreaWeighted(mdtol=1)."""
    data = np.asarray(data, dtype=np.float64)
    W = _overlap_weights(src_centers, dst_centers)
    moved = np.moveaxis(data, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    finite = np.isfinite(flat)
    vals = np.where(finite, flat, 0.0)
    num = W @ vals
    den = W @ finite.astype(np.float64)
    out = np.divide(num, den, out=np.full_like(num, np.nan), where=den > 0)
    out = out.reshape((W.shape[0],) + moved.shape[1:])
    return np.moveaxis(out, 0, axis)


def nearest_regrid_1d(data, src_centers, dst_centers, axis=0):
    """Nearest-center regrid in O(n log n) time and O(n) memory: the old
    dense |dst - src| matrix was 20 GB at the 50k-ping survey scale the
    area path of this module already avoids."""
    src = np.asarray(src_centers, dtype=np.float64)
    dst = np.asarray(dst_centers, dtype=np.float64)
    order = np.argsort(src, kind="stable")
    # collapse duplicate centers to their FIRST original occurrence and
    # break distance ties to the left — both matching argmin's
    # first-minimum convention
    uniq, first = np.unique(src[order], return_index=True)
    mid = (uniq[:-1] + uniq[1:]) / 2.0
    idx = order[first[np.searchsorted(mid, dst, side="left")]]
    return np.take(data, idx, axis=axis)


def regrid_data(data, src_range, src_time, dst_range, dst_time,
                method="area"):
    """2-D (range, ping) regrid, separable per axis
    (reference regridding.py:35-57)."""
    f = area_weighted_regrid_1d if method == "area" else nearest_regrid_1d
    out = f(data, src_range, dst_range, axis=0)
    return f(out, src_time, dst_time, axis=1)


def ping_rate_to_time_difference(ping_rate) -> float:
    """pings/s -> time difference in (MATLAB ordinal) days
    (reference regridding.py:146-148)."""
    return float(ping_rate) ** -1 / (24 * 60 * 60)


def regrid_prediction(pred, echogram, pred_range_diff=None,
                      pred_ping_rate=None):
    """Nearest-regrid a prediction map back onto the original echogram grid
    (reference regridding.py:60-96)."""
    time_vector = np.asarray(echogram.time_vector, dtype=np.float64)
    range_vector = np.asarray(echogram.range_vector, dtype=np.float64)
    # drop pings with negative time steps (regridding.py:72-74, iterated
    # to monotonicity) — and the matching PREDICTION columns when pred
    # shares the echogram's ping grid, or every column after a dropped
    # ping shifts by one
    n0 = time_vector.size
    keep = _monotonic_keep(time_vector)
    time_vector = time_vector[keep]
    if pred_ping_rate is None and pred.shape[1] == n0:
        pred = pred[:, keep]

    pred_time = time_vector
    pred_range = range_vector
    if pred_ping_rate is not None:
        pred_time = np.arange(time_vector[0], time_vector[-1],
                              ping_rate_to_time_difference(pred_ping_rate))
    if pred_range_diff is not None:
        pred_range = np.arange(range_vector[0], range_vector[-1],
                               pred_range_diff)
    return regrid_data(pred, pred_range, pred_time, range_vector,
                       time_vector, method="nearest")


def fix_pings_and_regrid(echogram, ping_rate=1.0, range_diff=None):
    """Regrid one echogram (all frequencies + labels + seabed) onto a fixed
    ping rate and optional range step (reference regridding.py:150-217).

    Returns (data (H', W', C), labels (H', W'), new_range, new_time).
    Data is regridded area-weighted; labels nearest.
    """
    time_vector = np.asarray(echogram.time_vector, dtype=np.float64)
    range_vector = np.asarray(echogram.range_vector, dtype=np.float64)
    keep = _monotonic_keep(time_vector)
    time_vector = time_vector[keep]

    new_time = np.arange(time_vector[0], time_vector[-1],
                         ping_rate_to_time_difference(ping_rate))
    new_range = (np.arange(range_vector[0], range_vector[-1], range_diff)
                 if range_diff is not None else range_vector)
    # degenerate targets (echogram shorter than one step): keep the
    # original axis — _edges cannot define a single cell's width
    if new_time.size < 2:
        new_time = time_vector
    if new_range.size < 2:
        new_range = range_vector

    data = echogram.data_numpy()[:, keep, :]
    labels = echogram.label_numpy()[:, keep]

    out = np.stack([regrid_data(data[:, :, c], range_vector, time_vector,
                                new_range, new_time, "area")
                    for c in range(data.shape[2])], axis=-1)
    new_labels = regrid_data(labels.astype(np.float64), range_vector,
                             time_vector, new_range, new_time, "nearest")
    return out, new_labels.astype(labels.dtype), new_range, new_time


def sanity_check(original, regridded, rel_tol=0.05) -> bool:
    """Energy conservation: total sv mass must be preserved up to rel_tol
    (reference regridding.py:344-362)."""
    e0 = np.nansum(original)
    e1 = np.nansum(regridded) * (original.size / max(regridded.size, 1))
    if e0 == 0:
        return e1 == 0
    return abs(e1 - e0) / abs(e0) < rel_tol
