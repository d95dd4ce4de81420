"""Zarr survey reader.

The port's copy of the JAX package's ``crimac_unet_tpu/data/
zarr_reader.py`` (the predict and eval surface).  One object per survey:
opens the zarr triplet ``<survey>_sv.zarr`` / ``_labels.zarr`` /
``_bottom.zarr`` + objects CSV via zarrlite, with the accessor contract of
the reference ``DataReaderZarr`` (crimac_unet/data/data_reader.py:510-1146):

  * ``shape`` is (n_pings, n_range) — note the axis swap vs the memmap
    reader (reference batch/dataset.py:141-144)
  * ``get_data_slice``  -> (freq, ping, range) float
  * ``get_label_slice`` -> (ping, range) categorical overlay of the binary
    category masks (later categories win; reference data_reader.py:786-793)
  * ``get_seabed`` / ``get_seabed_mask`` from the bottom mask

The objects CSV is read with the ``csv`` module (no pandas): the objects
table is a dict of equal-length numpy columns, with the JAX reader's
columns, validity and seabed-distance rules and its cached
``<name>_objects_parsed.csv`` (pandas' ``to_csv`` layout, index column
first).  The training accessors read the STOX transects CSV with the
``csv`` module too, and crop in patch orientation with boundary fill.
The LSSS parquet rasterizer is not ported yet (ROADMAP.md queue A4).
"""

from __future__ import annotations

import csv
import os
import threading
from glob import glob
from pathlib import Path

import numpy as np

from ..constants import DATA_BOUNDARY_VAL, LABEL_BOUNDARY_VAL
from ..utils.grids import crop_bounds
from .zarrlite import ZGroup, decode_cf_time

# streaming-read budget for the seabed scan (elements per read ~= 64 MB of
# float32); module-level so tests can shrink it to verify chunking
_SEABED_READ_ELEMS = 16 * 2 ** 20

# LSSS spells the depth columns without the trailing 'h'
_OBJECT_RENAMES = {"upperdept": "upperdepth", "lowerdept": "lowerdepth",
                   "upperdeptindex": "upperdepthindex",
                   "lowerdeptindex": "lowerdepthindex"}


def _open_group(path) -> ZGroup:
    """Open a survey store, preferring the consolidated-metadata fast
    path (one JSON read per store instead of 2-3 per array). Safe to
    prefer: both our writers and real xarray only leave ``.zmetadata``
    behind when a run of writes completed, so a present snapshot is
    current."""
    try:
        return ZGroup.open_consolidated(path)
    except (FileNotFoundError, ValueError):
        # no snapshot, or a malformed/foreign one — the per-array
        # metadata files are authoritative either way
        return ZGroup.open(path)


def _csv_column(cells: list) -> np.ndarray:
    """One CSV column as pandas' ``read_csv`` types it: bool for
    True/False, int64 for integers, float64 for numbers with empty cells
    as NaN, else strings."""
    if cells and all(c in ("True", "False") for c in cells):
        return np.array([c == "True" for c in cells], bool)
    try:
        return np.array([int(c) for c in cells], np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells],
                        np.float64)
    except ValueError:
        return np.array(cells, object)


def read_objects_csv(path, index_col=False) -> dict:
    """An objects CSV as {column: numpy array} (``index_col``: drop the
    leading index column of a pandas-written file)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    skip = 1 if index_col else 0
    return {name: _csv_column([r[j] for r in body])
            for j, name in enumerate(header) if j >= skip}


def _csv_cell(v) -> str:
    """One value as pandas' ``to_csv`` writes it (NaN as empty)."""
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return ""
    return str(v)


def write_objects_csv(path, table: dict, index=False) -> None:
    """{column: numpy array} -> CSV in pandas' ``to_csv`` layout (header
    row even for zero rows; ``index`` adds the unnamed index column)."""
    names = list(table)
    n = len(table[names[0]]) if names else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            w.writerow(([str(i)] if index else [])
                       + [_csv_cell(table[k][i]) for k in names])


class DataReaderZarr:
    data_format = "zarr"

    def __init__(self, path):
        self.sv_path = os.path.abspath(str(path))
        self.name = os.path.split(self.sv_path)[-1].replace("_sv.zarr", "")
        self.path = os.path.split(self.sv_path)[0]
        self.annotation_path = os.path.join(self.path,
                                            f"{self.name}_labels.zarr")
        self.seabed_path = os.path.join(self.path, f"{self.name}_bottom.zarr")
        self.objects_df_path = os.path.join(self.path,
                                            f"{self.name}_labels.parquet.csv")
        if not os.path.isdir(self.sv_path):
            raise FileNotFoundError(f"No Sv data found at {self.sv_path}")

        self.ds = _open_group(self.sv_path)
        self.sv = self.ds["sv"]
        self.frequencies = self.ds["frequency"][:].astype(np.int64)
        self.range_vector = self.ds["range"][:]
        # production stores are written by real xarray, which CF-encodes
        # time coordinates (int64/float64 + units attr) and strings
        # (vlen-utf8); stores written by this repo carry raw <M8[ns] and
        # |S64 — decode_cf_time handles both
        pt = self.ds["ping_time"]
        self.time_vector = decode_cf_time(pt[:], pt.attrs)
        self.heave = (self.ds["heave"][:] if "heave" in self.ds else None)
        self.raw_file = (self.ds["raw_file"][:] if "raw_file" in self.ds
                         else None)
        self.year = int(str(self.time_vector[0].astype("M8[Y]")))
        self.shape = (self.sv.shape[1], self.sv.shape[2])  # (pings, range)

        self.annotation = None
        self.fish_categories = []
        if os.path.isdir(self.annotation_path):
            self.annotation = _open_group(self.annotation_path)
            self.labels = self.annotation["annotation"]
            self.categories = self.annotation["category"][:].astype(np.int64)
            self.fish_categories = [int(c) for c in self.categories if c != -1]

        self.seabed = None
        if os.path.isdir(self.seabed_path):
            self.seabed = _open_group(self.seabed_path)

        self.valid_pings = None
        self.objects_df = None
        self._seabed_vec = None  # full-survey seabed cache (fast path)
        self._seabed_has = None
        self._seabed_scan_lock = threading.Lock()
        # the valid-pings and objects caches: prefetch threads share a
        # reader, and two of them must not build one cache at once
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------- indices
    def get_ping_index(self, ping_time) -> int:
        """Closest ping index to a datetime64
        (reference data_reader.py:600-608)."""
        return int(np.abs(self.time_vector - ping_time).argmin())

    def get_range_index(self, rng) -> int:
        return int(np.abs(self.range_vector - rng).argmin())

    def get_valid_pings(self) -> np.ndarray:
        """(n, 2) int32 [start, end] ping ranges of the STOX transects
        (``<survey dir>/STOX/<survey>_transects.csv``, the survey dir two
        levels above the store's), the full survey ``[[0, n_pings]]``
        without the CSV (reference data_reader.py:577-598).  The CSV's
        cells go to ``np.datetime64`` as strings, as pandas hands them
        over."""
        if self.valid_pings is None:
            with self._cache_lock:
                if self.valid_pings is None:
                    self.valid_pings = self._read_valid_pings()
        return self.valid_pings

    def _read_valid_pings(self) -> np.ndarray:
        parents = Path(self.path).parents
        csv_dir = parents[1] if len(parents) > 1 else Path(self.path)
        csv_path = os.path.join(csv_dir, "STOX",
                                self.name.replace("S", "") + "_transects.csv")
        if not os.path.isfile(csv_path):
            return np.array([[0, self.shape[0]]], dtype=np.int32)
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        starts = [self.get_ping_index(np.datetime64(r["StartDateTime"]))
                  for r in rows]
        ends = [self.get_ping_index(np.datetime64(r["StopDateTime"]))
                for r in rows]
        return np.array([starts, ends], dtype=np.int32).T

    # -------------------------------------------------------------- slices
    def _range_slice(self, idx_range, n_range):
        if idx_range is None:
            return slice(None, n_range)
        if n_range is None:
            return slice(idx_range, None)
        return slice(idx_range, idx_range + n_range)

    def _freq_indices(self, frequencies) -> list:
        if frequencies is None:
            return list(range(len(self.frequencies)))
        if np.isscalar(frequencies):
            frequencies = [frequencies]
        freq_idx = [self._freq_index(f) for f in frequencies]
        if not freq_idx:
            raise ValueError("frequencies is empty — nothing to read")
        return freq_idx

    def get_data_slice(self, idx_ping, n_pings=None, idx_range=None,
                       n_range=None, frequencies=None):
        """(freq, ping, range) slab (reference data_reader.py:699-752)."""
        freq_idx = self._freq_indices(frequencies)
        ping_sl = slice(idx_ping, None if n_pings is None
                        else idx_ping + n_pings)
        rng_sl = self._range_slice(idx_range, n_range)
        if freq_idx == list(range(freq_idx[0], freq_idx[0] + len(freq_idx))):
            # contiguous frequencies (the standard 4-band read): one region
            # read -> one native batch-decompress over all chunks
            return self.sv[freq_idx[0]:freq_idx[0] + len(freq_idx),
                           ping_sl, rng_sl]
        return np.stack([self.sv[f, ping_sl, rng_sl] for f in freq_idx],
                        axis=0)

    def read_data_into(self, idx_ping, n_pings, idx_range, n_range,
                       frequencies, dst, dst_index, cvt=0) -> None:
        """Read the (freq, ping, range) region transposed to
        (range, ping, freq) DIRECTLY into ``dst[dst_index]`` — the HWC
        inference slab hot path.  Blosc stores decode+scatter in one
        native pass (zarrlite.read_into; ``cvt`` selects its converting
        float32 -> bfloat16-bits decode into a uint16 ``dst``); anything
        else falls back to ``get_data_slice`` + transpose."""
        freq_idx = self._freq_indices(frequencies)
        ping_sl = slice(idx_ping, None if n_pings is None
                        else idx_ping + n_pings)
        rng_sl = self._range_slice(idx_range, n_range)
        if freq_idx == list(range(freq_idx[0],
                                  freq_idx[0] + len(freq_idx))):
            self.sv.read_into(
                (slice(freq_idx[0], freq_idx[0] + len(freq_idx)),
                 ping_sl, rng_sl), dst, dst_index, axes=(2, 1, 0), cvt=cvt)
            return
        from .blosc_codec import f32_to_bf16_bits
        raw = self.get_data_slice(idx_ping, n_pings, idx_range, n_range,
                                  frequencies).transpose(2, 1, 0)
        dst[dst_index] = f32_to_bf16_bits(raw) if cvt else raw

    def _freq_index(self, f) -> int:
        matches = np.where((self.frequencies == f)
                           | (self.frequencies == f * 1000))[0]
        if len(matches) == 0:
            raise ValueError(f"frequency {f} not in {self.frequencies}")
        return int(matches[0])

    def get_label_slice(self, idx_ping, n_pings=None, idx_range=None,
                        n_range=None, categories=None):
        """Overlay the per-category binary masks into one categorical
        (ping, range) mask; later categories win on overlap
        (reference data_reader.py:754-807)."""
        if categories is None:
            categories = self.fish_categories
        ping_sl = slice(idx_ping, None if n_pings is None
                        else idx_ping + n_pings)
        rng_sl = self._range_slice(idx_range, n_range)
        if self.annotation is None:
            # degraded unannotated-survey mode (production prediction
            # mounts often ship only <name>_sv.zarr): every pixel reads
            # BACKGROUND, so the predict write mask keeps everything the
            # sv/seabed tests allow, and nothing label-derived is excluded
            if not getattr(self, "_warned_no_labels", False):
                print(f"WARNING: {self.name}: no _labels.zarr — treating "
                      "the survey as unannotated (all background)")
                self._warned_no_labels = True
            n_p = len(range(*ping_sl.indices(self.shape[0])))
            n_r = len(range(*rng_sl.indices(self.shape[1])))
            return np.zeros((n_p, n_r), np.float32)

        cat_list = [int(c) for c in self.categories]
        # one region read over ALL categories -> a single (batched,
        # natively decompressed) pass over the chunk files instead of one
        # read per category
        masks = self.labels[:, ping_sl, rng_sl]
        # zero template with the store's nan geometry: category -1 when
        # present (the production convention), else any category (all are
        # written with identical extents by the preprocessing chain)
        tmpl = cat_list.index(-1) if -1 in cat_list else 0
        out = masks[tmpl] * 0
        for cat in categories:
            mask = masks[cat_list.index(int(cat))]
            out = np.where(mask > 0, float(cat), out)
        return out

    def get_seabed_mask(self, idx_ping, n_pings=None, idx_range=None,
                        n_range=None, seabed_pad=0):
        """(ping, range) 0/1 mask of below-seabed pixels; ``seabed_pad``
        shifts the mask down (reference data_reader.py:810-851)."""
        ping_sl = slice(idx_ping, None if n_pings is None
                        else idx_ping + n_pings)
        if idx_range is None:
            idx_range = 0
        rng_sl = self._range_slice(idx_range, n_range)
        if self.seabed is None:
            raise ValueError(
                f"{self.name}: no {self.name}_bottom.zarr store — "
                "seabed masks are unavailable for this survey")
        seabed_slice = np.nan_to_num(
            self.seabed["bottom_range"][ping_sl, rng_sl], nan=0.0)
        if seabed_pad < 0:
            # the reference's pad shift (data_reader.py:841-846) silently
            # mangles negative pads; refuse instead of reproducing garbage
            raise ValueError(
                f"seabed_pad must be >= 0 (got {seabed_pad}): negative "
                "pads are unsupported by the reference mask-shift "
                "formulation")
        if seabed_pad != 0:
            pad = np.zeros_like(seabed_slice)
            pad[:, seabed_pad:] = seabed_slice[:, :-seabed_pad]
            return pad
        return seabed_slice

    def get_seabed(self, idx_ping, n_pings=1):
        """Per-ping first below-seabed row index
        (reference data_reader.py:853-870), cached for the full survey.

        The per-ping vector is computed in ping-chunked streaming reads —
        the full bottom mask of a real survey (10^5-10^6 pings x ~4k range
        float32) is 1.6-16 GB and must never be materialized at once; only
        the (n_pings,) int vector is kept."""
        if self._seabed_vec is None:
            # double-checked lock: prefetch threads hit a fresh reader
            # concurrently — without it each duplicated the scan, and the
            # vec/has pair could be observed half-published
            with self._seabed_scan_lock:
                if self._seabed_vec is None:
                    self._seabed_scan()
        if n_pings is None:
            return self._seabed_vec[idx_ping:]
        return self._seabed_vec[idx_ping:idx_ping + n_pings]

    def _seabed_scan(self) -> None:
        """Fill the full-survey seabed caches (holding _seabed_scan_lock).
        ``_seabed_has`` is assigned BEFORE ``_seabed_vec`` — consumers
        gate on vec being present, so the pair is never seen half-set."""
        if self.seabed is None:
            # degraded no-bottom-store mode: every ping reports "no
            # seabed" (consumers map seabed_known=False to BIG_ROW — no
            # seabed masking anywhere)
            print(f"WARNING: {self.name}: no _bottom.zarr — treating "
                  "the survey as seabed-free")
            self._seabed_has = np.zeros(self.shape[0], dtype=bool)
            self._seabed_vec = np.zeros(self.shape[0], dtype=int)
            return
        total, width = self.shape
        vec = np.empty(total, dtype=int)
        has = np.empty(total, dtype=bool)
        bot = self.seabed["bottom_range"]
        # ~64 MB float32 per read, aligned to the store's ping chunking
        step = max(1, _SEABED_READ_ELEMS // max(1, width))
        store_chunk = bot.chunks[0]
        step = max(store_chunk, (step // store_chunk) * store_chunk)
        for s in range(0, total, step):
            m = np.nan_to_num(bot[s:s + step, :], nan=0.0)
            vec[s:s + len(m)] = m.argmax(axis=1)
            has[s:s + len(m)] = m.max(axis=1) > 0  # pings w/o seabed
        self._seabed_has = has
        self._seabed_vec = vec

    def seabed_known(self, idx_ping=0, n_pings=None) -> np.ndarray:
        """Per-ping "has a seabed estimate" vector (same slicing as
        ``get_seabed``): False marks pings whose bottom store carries no
        positive sample (or the whole survey in degraded no-bottom-store
        mode) — consumers treat those as full water column instead of a
        spurious row-0 seabed."""
        if self._seabed_vec is None:
            self.get_seabed(0, 1)  # triggers the locked full scan
        if n_pings is None:
            return self._seabed_has[idx_ping:]
        return self._seabed_has[idx_ping:idx_ping + n_pings]

    # -------------------------------------------------------------- objects
    def get_objects_file(self) -> dict:
        """Objects table ({column: numpy array}) with seabed distance +
        validity, cached to ``<name>_objects_parsed.csv``
        (reference data_reader.py:637-697)."""
        if self.objects_df is None:
            with self._cache_lock:
                if self.objects_df is None:
                    self.objects_df = self._read_objects()
        return self.objects_df

    def _read_objects(self) -> dict:
        parsed = os.path.join(self.path, self.name + "_objects_parsed.csv")
        if os.path.isfile(parsed):
            return read_objects_csv(parsed, index_col=True)
        if not os.path.isfile(self.objects_df_path):
            raise FileNotFoundError(
                f"Cannot compute objects dataframe from {self.objects_df_path}")
        df = {_OBJECT_RENAMES.get(k, k): v
              for k, v in read_objects_csv(self.objects_df_path).items()}
        n = len(df["category"])
        start, end = df["startpingindex"], df["endpingindex"]
        # recomputed when absent or all NaN (pandas' isna().all(), True
        # for zero rows)
        given = df.get("distance_to_seabed")
        if given is None or n == 0 or (given.dtype.kind == "f"
                                       and np.isnan(given).all()):
            dist = np.full(n, np.nan, dtype=np.float32)
            valid = np.zeros(n, dtype=bool)
            for i in range(n):
                if start[i] > end[i] or df["category"][i] == -1:
                    continue
                if self.seabed is not None:
                    center = int(start[i]) + int((end[i] - start[i]) / 2)
                    dist[i] = (self.get_seabed(center)[0]
                               - df["lowerdepthindex"][i])
                valid[i] = True
            df["distance_to_seabed"] = dist
            df["valid_object"] = valid
        if "valid_object" not in df:
            # objects CSV shipped its own distance_to_seabed (skipping the
            # recompute branch above) — derive validity the same way
            df["valid_object"] = (start <= end) & (df["category"] != -1)
        # atomic cache publish: a concurrent process reading a
        # half-written CSV would silently change its sampling distribution
        # (unique temp name — two writers sharing one .tmp would interleave)
        import tempfile
        fd, tmp = tempfile.mkstemp(dir=self.path,
                                   suffix=".objects_parsed.tmp.csv")
        os.close(fd)
        write_objects_csv(tmp, df, index=True)
        os.replace(tmp, parsed)
        return df

    def get_fish_schools(self, category="all") -> dict:
        """Valid-school rows for the requested categories
        (reference data_reader.py:622-635)."""
        df = self.get_objects_file()
        if category == "all":
            category = self.fish_categories
        if not isinstance(category, (list, np.ndarray)):
            category = [category]
        keep = np.isin(df["category"], category) \
            & df["valid_object"].astype(bool)
        return {k: v[keep] for k, v in df.items()}

    def get_object_bounding_boxes(self):
        """(n, 4) [y0, y1, x0, x1] bboxes in (range, ping) index space, for
        the extended-label eval masks (reference extend_label_masks.py:66)."""
        df = self.get_fish_schools("all")
        cols = ("upperdepthindex", "lowerdepthindex", "startpingindex",
                "endpingindex")
        return np.stack([df[c] for c in cols], axis=1).astype(int) \
            .reshape(-1, 4)

    @property
    def objects(self):
        """Reference-style object dicts for grid modes region/trace
        (reference gridded.py:62-63)."""
        df = self.get_fish_schools("all")
        return [{"fish_type_index": int(cat), "bounding_box": [int(v)
                 for v in box]}
                for cat, box in zip(df["category"],
                                    self.get_object_bounding_boxes())]

    # ----------------------------------------------------------------- crop
    def _crop_region(self, center, window):
        """Crop bounds in (range, ping) and the part inside the survey."""
        (y0, x0), (y1, x1) = crop_bounds(center, window)
        n_pings, n_range = self.shape
        return (y0, x0), (max(y0, 0), min(y1, n_range),
                          max(x0, 0), min(x1, n_pings))

    def crop_data(self, center, window, frequencies):
        """(C, range, ping) float32 crop in patch orientation, boundary
        fill outside the survey; NaN becomes the boundary value, +-Inf
        the float32 extremes (``nan_to_num`` with ``nan`` only)
        (reference batch/dataset.py:358-407)."""
        (y0, x0), (cy0, cy1, cx0, cx1) = self._crop_region(center, window)
        out = np.full((len(frequencies), window[0], window[1]),
                      DATA_BOUNDARY_VAL, dtype=np.float32)
        if cy1 > cy0 and cx1 > cx0:
            slab = self.get_data_slice(cx0, cx1 - cx0, cy0, cy1 - cy0,
                                       frequencies)
            out[:, cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
                np.nan_to_num(slab.swapaxes(1, 2), nan=DATA_BOUNDARY_VAL)
        return out

    def crop_labels(self, center, window):
        """(range, ping) int16 label crop, boundary fill outside the
        survey and where the labels are NaN."""
        (y0, x0), (cy0, cy1, cx0, cx1) = self._crop_region(center, window)
        out = np.full(tuple(window), LABEL_BOUNDARY_VAL, dtype=np.float32)
        if cy1 > cy0 and cx1 > cx0:
            slab = self.get_label_slice(cx0, cx1 - cx0, cy0, cy1 - cy0)
            out[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
                np.nan_to_num(slab.T, nan=LABEL_BOUNDARY_VAL)
        return out.astype(np.int16)


def get_zarr_readers(years="all", frequencies=np.array([18, 38, 120, 200]),
                     minimum_shape=256, path_to_zarr_files=None,
                     require_categories=True):
    """Discover surveys under the production layout
    ``<root>/<year>/*/ACOUSTIC/GRIDDED/*sv.zarr``
    (reference data_reader.py:1123-1146).

    ``require_categories=False`` (the predict/eval discovery path) lets
    surveys with no annotation store pass the sandeel+other category
    filter — the degraded prediction-only mode for production mounts
    shipping just ``_sv.zarr``."""
    from .. import paths
    if path_to_zarr_files is None:
        path_to_zarr_files = paths.path_to_zarr_files()

    if years == "all":
        files = sorted(glob(os.path.join(path_to_zarr_files, "**",
                                         "*sv.zarr"), recursive=True))
    else:
        if not isinstance(years, (list, tuple, np.ndarray)):
            raise TypeError(f"years must be a list of year numbers or "
                            f"'all', got {years!r}")
        files = []
        for year in years:
            files += sorted(glob(os.path.join(
                path_to_zarr_files, str(year), "*", "ACOUSTIC", "GRIDDED",
                "*sv.zarr")))
    if len(files) == 0:
        raise FileNotFoundError(
            f"No survey data found at {path_to_zarr_files}")
    readers = [DataReaderZarr(f) for f in files]
    readers = [r for r in readers
               if all(any((r.frequencies == f) | (r.frequencies == f * 1000))
                      for f in frequencies)]
    # the reference requires both sandeel+other categories
    # (data_reader.py:1144); see require_categories in the docstring
    readers = [r for r in readers
               if (not require_categories and r.annotation is None)
               or all(cat in r.fish_categories for cat in (27, 1))]
    # small-survey filter (parity with get_echograms' minimum_shape)
    readers = [r for r in readers if min(r.shape) > minimum_shape]
    if len(readers) == 0:
        raise ValueError(
            f"No surveys at {path_to_zarr_files} pass the frequency/"
            f"category/minimum_shape={minimum_shape} filters")
    return readers
