"""Zarr store rechunking.

Counterpart of reference data_preprocessing/rechunk_zarr.py:11-70 and
utils/rechunk_zarr.py:9-48 (which used the ``rechunker`` package).
Implemented directly on zarrlite: stream-copy each array into a new store
with target chunking, windowed so memory stays bounded.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .zarrlite import ZArray, ZGroup

# reference target chunking: {frequency/category: 1, ping: 1000, range: 1000}
DEFAULT_CHUNK = {"frequency": 1, "category": 1, "ping_time": 1000,
                 "range": 1000}


def _target_chunks(arr: ZArray, chunk_spec: dict):
    dims = arr.dims or [f"dim{i}" for i in range(arr.ndim)]
    return tuple(min(int(chunk_spec.get(d, s)), int(s))
                 for d, s in zip(dims, arr.shape))


def rechunk_array(src: ZArray, dst_path, chunks, window_elems=64 << 20):
    """Copy one array with new chunking, windowed along axis 0."""
    dst = ZArray.create(dst_path, src.shape, chunks, src.dtype,
                        compressor=src.compressor,
                        fill_value=src.fill_value,
                        attrs=src.attrs, overwrite=True)
    if src.shape[0] == 0:
        return dst
    per_row = max(1, int(np.prod(src.shape[1:])))
    # round the window down to whole destination chunks: a straddling
    # window makes every boundary chunk pay the read-modify-write
    # (decompress + recompress) path twice
    step = max(chunks[0],
               int(window_elems // per_row) // chunks[0] * chunks[0])
    for i in range(0, src.shape[0], step):
        sel = (slice(i, min(i + step, src.shape[0])),) + \
            (slice(None),) * (src.ndim - 1)
        dst[sel] = src[sel]
    return dst


def rechunk_store(src_path, dst_path, chunk_spec=None):
    """Rechunk a whole zarr group directory."""
    chunk_spec = chunk_spec or DEFAULT_CHUNK
    src = ZGroup.open(src_path)
    if os.path.isdir(dst_path):
        shutil.rmtree(dst_path)
    dst = ZGroup.create(dst_path, attrs=src.attrs)
    for name in src.array_names():
        arr = src[name]
        if arr.dtype == np.dtype(object):
            # vlen-utf8 string coordinates (real-xarray stores): zarrlite
            # reads but does not re-encode them — copy the array verbatim
            # (source chunking kept; rechunking a 1-D coordinate is moot)
            shutil.copytree(arr.path, os.path.join(str(dst_path), name))
            continue
        rechunk_array(arr, os.path.join(str(dst_path), name),
                      _target_chunks(arr, chunk_spec))
    # the reference consolidates its rechunk outputs
    # (rechunk_zarr.py:51, utils/rechunk_zarr.py:48)
    dst.consolidate()
    return dst
