"""A plain zarr v2 store reader and writer: JSON metadata, C-order chunk
files named ``i.j.k``, zlib or no compression.

The benchmark writes its input surveys with it and reads back the
prediction stores the program writes, without the program's code.  Blosc
chunks are refused: the card's host has no libblosc, so the program writes
zlib there, and a Blosc store would mean the run is not the one measured.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from itertools import product

import numpy as np


def _fill_json(v, dtype):
    if v is None:
        return None
    if np.issubdtype(dtype, np.floating) and math.isnan(float(v)):
        return "NaN"
    return v.item() if hasattr(v, "item") else v


def write_group(path, attrs=None) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump(dict(attrs or {}), f)
    return path


def write_array(group, name, value, chunks=None, compress=True,
                fill_value=None, dims=None, workers=4) -> None:
    """Write the whole numpy array ``value`` as ``group/name``; chunks
    default to the array's shape.  zlib level 1, as the program writes
    new stores when no Blosc backend loads."""
    value = np.ascontiguousarray(value)
    chunks = tuple(value.shape if chunks is None else chunks)
    path = os.path.join(group, name)
    os.makedirs(path, exist_ok=True)
    meta = {"zarr_format": 2, "shape": list(value.shape),
            "chunks": list(chunks), "dtype": value.dtype.str,
            "compressor": {"id": "zlib", "level": 1} if compress else None,
            "fill_value": _fill_json(fill_value, value.dtype),
            "order": "C", "filters": None}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(path, ".zattrs"), "w") as f:
        json.dump({"_ARRAY_DIMENSIONS": list(dims)} if dims else {}, f)
    grid = [range(-(-s // c)) for s, c in zip(value.shape, chunks)]

    def one(cidx):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(cidx, chunks, value.shape))
        block = np.full(chunks, 0 if fill_value is None else fill_value,
                        value.dtype)
        block[tuple(slice(0, s.stop - s.start) for s in sl)] = value[sl]
        buf = block.tobytes()
        if compress:
            buf = zlib.compress(buf, 1)
        with open(os.path.join(path, ".".join(map(str, cidx))), "wb") as f:
            f.write(buf)

    # zlib releases the GIL: compress the chunks on a few threads
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(one, product(*grid)))


class PlainArray:
    """Read-only zarr v2 array: ``arr[slices]`` with basic slices."""

    def __init__(self, path):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{path}: only plain C-order arrays")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zlib":
            raise ValueError(f"{path}: compressor {comp} is not zlib")
        self.compressed = comp is not None
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        fv = meta.get("fill_value")
        self.fill = np.nan if fv == "NaN" else (0 if fv is None else fv)

    def _chunk(self, cidx):
        fname = os.path.join(self.path, ".".join(map(str, cidx)))
        if not os.path.isfile(fname):
            return np.full(self.chunks, self.fill, self.dtype)
        with open(fname, "rb") as f:
            raw = f.read()
        if self.compressed:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    def __getitem__(self, sel):
        if not isinstance(sel, tuple):
            sel = (sel,)
        sel = sel + (slice(None),) * (len(self.shape) - len(sel))
        bounds = [s.indices(n)[:2] for s, n in zip(sel, self.shape)]
        out = np.empty([b - a for a, b in bounds], self.dtype)
        ranges = [range(a // c, -(-b // c)) for (a, b), c
                  in zip(bounds, self.chunks)]
        for cidx in product(*ranges):
            src, dst = [], []
            for i, c, (a, b) in zip(cidx, self.chunks, bounds):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = self._chunk(cidx)[tuple(src)]
        return out
