"""Memmap echogram reader.

One object per echogram directory: pickled metadata + one ``np.memmap`` per
frequency + label memmaps, exactly the on-disk contract of the reference
``Echogram`` (crimac_unet/data/data_reader.py:44-507):

    <dir>/frequencies.pkl range_vector.pkl time_vector.pkl heave.pkl
          data_dtype.pkl label_dtype.pkl shape.pkl objects.pkl
          data_for_freq_<f>.dat      (shape = (n_range, n_pings))
          labels.dat / labels_heave.dat
          seabed.npy                 (cached seabed estimate)

``shape`` is (H=range, W=pings); the zarr reader's shape is (pings, range)
(reference dataset.py:141-144) — callers must honour ``data_format``.

The prediction path reads whole slabs through ``data_memmaps``; training
reads one crop at a time through ``crop_data`` / ``crop_labels``;
``visualize`` renders it through :mod:`..utils.plotting` (matplotlib).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..constants import DATA_BOUNDARY_VAL, LABEL_BOUNDARY_VAL
from ..utils.grids import crop_bounds, extract_crop_2d
from .seabed import estimate_seabed_memmap


def _load_pickle(folder, name):
    with open(os.path.join(folder, name) + ".pkl", "rb") as f:
        return pickle.load(f, encoding="latin1")


# Process-wide LRU of open data memmaps, keyed (echogram path, frequency).
# Each np.memmap pins an open fd; bounding the cache across ALL Echogram
# instances keeps a many-thousand-echogram survey under the default fd
# ulimit (1024) while still de-duplicating the per-crop remap churn.
import collections as _collections
import threading as _threading

_MEMMAP_LRU: "_collections.OrderedDict" = _collections.OrderedDict()
_MEMMAP_LRU_MAX = 512
# data_memmaps is called from the predict/eval prefetch threads;
# OrderedDict reorder + evict is not atomic under concurrent mutation
_MEMMAP_LRU_LOCK = _threading.Lock()
# the label block tables (Echogram.labels_any), built once by whichever
# sampler thread asks first
_BLOCKS_LOCK = _threading.Lock()
# side of a label block, and the columns a block table is built from at once
_BLOCK = 16
_BLOCK_COLS = 256 * _BLOCK


def _fish(labels) -> np.ndarray:
    """Where a label read as ``crop_labels`` reads it (int16) is neither
    0 nor the boundary fill."""
    v = np.asarray(labels).astype(np.int16)
    return (v != 0) & (v != LABEL_BOUNDARY_VAL)


def _block_table(labels) -> np.ndarray:
    """Summed-area table of the ``_BLOCK``-square blocks of a (H, W)
    label array that hold a :func:`_fish` pixel (the last row and column
    of blocks cut short by the array's edge)."""
    H, W = labels.shape
    hb, wb = -(-H // _BLOCK), -(-W // _BLOCK)
    blocks = np.zeros((hb, wb), np.int32)
    for x in range(0, W, _BLOCK_COLS):
        part = np.zeros((hb * _BLOCK, _BLOCK_COLS), bool)
        cols = min(_BLOCK_COLS, W - x)
        part[:H, :cols] = _fish(labels[:, x:x + cols])
        n = -(-cols // _BLOCK)
        blocks[:, x // _BLOCK:x // _BLOCK + n] = part.reshape(
            hb, _BLOCK, -1, _BLOCK).any(axis=(1, 3))[:, :n]
    table = np.zeros((hb + 1, wb + 1), np.int32)
    table[1:, 1:] = blocks.cumsum(0).cumsum(1)
    return table


def _matlab_time_to_datetime(t: float):
    from datetime import datetime, timedelta
    days = t % 1
    return (datetime.fromordinal(int(t)) + timedelta(days=days)
            - timedelta(days=366))


def _portion_of_year_scalar(time_vector) -> float:
    """(reference data_reader.py:71-73,:80-81)"""
    t = _matlab_time_to_datetime(float(np.atleast_1d(time_vector)[0]))
    return t.month / 12 + t.day / 366 + t.hour / 366 / 24


def _timevector_to_diff(time_vector) -> np.ndarray:
    """Per-ping time-step vector normalized to ~[-1, 1]
    (reference data_reader.py:56-62)."""
    tv = np.atleast_1d(np.asarray(time_vector, dtype=np.float64))
    if tv.size < 3:
        return np.zeros_like(tv)
    return np.concatenate((
        [tv[1] - tv[0]],
        (tv[2:] - tv[:-2]) / 2,
        [tv[-1] - tv[-2]],
    )) / 6e-6 - 1


class Echogram:
    """Reader for one memmap echogram directory
    (reference data/data_reader.py:44-113)."""

    data_format = "memmap"

    def __init__(self, path):
        self.path = str(path)
        self.name = os.path.split(self.path)[-1]
        self.frequencies = (np.array(_load_pickle(self.path, "frequencies"))
                            .squeeze().astype(int))
        self.range_vector = np.array(
            _load_pickle(self.path, "range_vector")).squeeze()
        self.time_vector = np.array(
            _load_pickle(self.path, "time_vector")).squeeze()
        self.heave = np.asarray(_load_pickle(self.path, "heave")).squeeze()
        self.data_dtype = _load_pickle(self.path, "data_dtype")
        self.label_dtype = _load_pickle(self.path, "label_dtype")
        self.shape = tuple(_load_pickle(self.path, "shape"))
        self.objects = _load_pickle(self.path, "objects")
        self.n_objects = len(self.objects)
        # Echogram dir names carry the survey year at chars 9:13,
        # e.g. "2017843-D20170427-T062615" (reference data_reader.py:73)
        self.year = int(self.name[9:13])
        self._seabed = None
        self._blocks = None   # labels_any's block table, built on first use

        # metadata-channel source vectors (reference data_reader.py:56-100)
        self.portion_of_day_vector = self.time_vector % 1
        self.portion_of_year_scalar = _portion_of_year_scalar(
            self.time_vector)
        self.time_vector_diff = _timevector_to_diff(self.time_vector)

        self.label_types_in_echogram = np.unique(
            [o["fish_type_index"] for o in self.objects]
        ) if self.objects else np.array([])

        self.object_ids_with_label: dict = {}
        bboxes = []
        for object_id, obj in enumerate(self.objects):
            self.object_ids_with_label.setdefault(
                obj["fish_type_index"], []).append(object_id)
            bboxes.append(obj["bounding_box"])
        self.object_bounding_boxes = (
            np.array(bboxes).astype(int) if bboxes
            else np.zeros((0, 4), dtype=int))

    # ------------------------------------------------------------ raw data
    def data_memmaps(self, frequencies=None):
        """One read-only memmap per requested frequency
        (reference data_reader.py:352-364).  Cached in a process-wide
        LRU (bounded at ``_MEMMAP_LRU_MAX`` open maps across ALL
        Echogram instances, so a many-thousand-echogram survey cannot
        exhaust the fd ulimit): the hot sampling path calls this per
        crop, and re-mmapping the same immutable files thousands of
        times per run is pure syscall churn.
        """
        if frequencies is None:
            frequencies = self.frequencies[:]
        if np.isscalar(frequencies):
            frequencies = [frequencies]
        out = []
        for f in frequencies:
            f = int(f)
            key = (self.path, f)
            with _MEMMAP_LRU_LOCK:
                m = _MEMMAP_LRU.get(key)
                if m is not None:
                    _MEMMAP_LRU.move_to_end(key)
            if m is None:
                m = np.memmap(
                    os.path.join(self.path, f"data_for_freq_{f}.dat"),
                    dtype=self.data_dtype, mode="r", shape=self.shape)
                with _MEMMAP_LRU_LOCK:
                    _MEMMAP_LRU[key] = m
                    if len(_MEMMAP_LRU) > _MEMMAP_LRU_MAX:
                        _MEMMAP_LRU.pop(next(iter(_MEMMAP_LRU)))
            out.append(m)
        return out

    def data_numpy(self, frequencies=None):
        """(H, W, C) float32 array of the full echogram
        (reference data_reader.py:366-373)."""
        maps = self.data_memmaps(frequencies)
        return np.stack([np.asarray(m) for m in maps],
                        axis=-1).astype("float32")

    def label_memmap(self, heave=True):
        """Label memmap; ``heave=True`` selects the heave-reverted labels
        that align with the (uncorrected) sv data, generating the file
        lazily on first access (reference data_reader.py:375-391).
        Cached in the same process-wide LRU as the data memmaps — the
        rejection samplers call this per candidate crop (up to 200x per
        sample), and re-mmapping the immutable file each time is pure
        syscall churn (review finding r3)."""
        kind = "labels_heave" if heave else "labels"
        key = (self.path, kind)
        with _MEMMAP_LRU_LOCK:
            m = _MEMMAP_LRU.get(key)
            if m is not None:
                _MEMMAP_LRU.move_to_end(key)
                return m
        if heave:
            heave_path = os.path.join(self.path, "labels_heave.dat")
            if not os.path.isfile(heave_path):
                from .preprocess import write_heave_reverted_labels
                write_heave_reverted_labels(self)
            m = np.memmap(heave_path, dtype=self.label_dtype, mode="r",
                          shape=self.shape)
        else:
            m = np.memmap(os.path.join(self.path, "labels.dat"),
                          dtype=self.label_dtype, mode="r",
                          shape=self.shape)
        with _MEMMAP_LRU_LOCK:
            _MEMMAP_LRU[key] = m
            if len(_MEMMAP_LRU) > _MEMMAP_LRU_MAX:
                _MEMMAP_LRU.pop(next(iter(_MEMMAP_LRU)))
        return m

    def label_numpy(self, heave=True):
        return np.array(self.label_memmap(heave))

    def get_object_bounding_boxes(self):
        return self.object_bounding_boxes.copy()

    # -------------------------------------------------------------- seabed
    def get_seabed(self, idx_ping=None, n_pings=1, save_to_file=True,
                   ignore_saved=False):
        """Per-ping seabed row index, cached to ``seabed.npy``
        (reference data_reader.py:433-507; estimation algorithm in
        crimac_unet_tpu.data.seabed)."""
        if self._seabed is None or ignore_saved:
            cache = os.path.join(self.path, "seabed.npy")
            if os.path.isfile(cache) and not ignore_saved:
                self._seabed = np.load(cache)
            else:
                self._seabed = estimate_seabed_memmap(self)
                if save_to_file:
                    # atomic save: lazy generation can race across threads
                    import tempfile
                    fd, tmp = tempfile.mkstemp(dir=self.path,
                                               suffix=".seabed.tmp.npy")
                    os.close(fd)
                    np.save(tmp, self._seabed)
                    os.replace(tmp, cache)
        if idx_ping is None:
            return self._seabed
        return self._seabed[idx_ping:idx_ping + n_pings]

    def seabed_known(self, idx_ping=0, n_pings=None) -> np.ndarray:
        """Memmap counterpart of ``DataReaderZarr.seabed_known``: the
        gradient estimator always produces a row per ping, so every ping
        has a seabed estimate."""
        total = self.shape[1]
        n = (total - idx_ping) if n_pings is None else n_pings
        return np.ones(max(n, 0), dtype=bool)

    def get_seabed_mask(self, idx_ping=0, n_pings=None, idx_range=None,
                        n_range=None, seabed_pad=0):
        """(n_range, n_pings) 0/1 mask, 1 below the (padded) seabed line
        (reference data_reader.py:407-431)."""
        if n_pings is None:
            n_pings = self.shape[1]
        seabed = self.get_seabed(idx_ping, n_pings).astype(int) + seabed_pad
        if idx_range is None:
            idx_range = 0
        if n_range is None:
            n_range = self.shape[0]
        seabed = seabed - idx_range
        seabed = np.clip(seabed, 0, None)
        rows = np.arange(n_range)[:, None]
        return (rows >= seabed[None, :]).astype(np.float64)

    # ---------------------------------------------------------------- crop
    def crop_data(self, center, window, frequencies):
        """(C, H, W) float32 crop with out-of-bounds filled with
        DATA_BOUNDARY_VAL and non-finite values zeroed
        (reference batch/dataset.py:254-285)."""
        center = list(center)
        if self.shape[0] <= window[0]:
            center[0] = self.shape[0] // 2  # window spans the water column
        chans = []
        for m in self.data_memmaps(frequencies):
            crop = extract_crop_2d(m, center, window,
                                   DATA_BOUNDARY_VAL).astype(np.float32)
            np.nan_to_num(crop, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
            chans.append(crop)
        return np.stack(chans, axis=0)

    def visualize(self, **kwargs):
        """Render this echogram (reference data_reader.py:117-350)."""
        from ..utils.plotting import visualize_echogram
        return visualize_echogram(self, **kwargs)

    def crop_labels(self, center, window):
        center = list(center)
        if self.shape[0] <= window[0]:
            center[0] = self.shape[0] // 2
        return extract_crop_2d(self.label_memmap(), center, window,
                               LABEL_BOUNDARY_VAL).astype(np.int16)

    def labels_any(self, center, window) -> bool:
        """Whether ``crop_labels(center, window)`` holds a label other
        than 0 and the boundary fill, read without cutting the crop: the
        whole label blocks inside the window from a summed-area table
        (built once an echogram), the strips around them from the
        labels.  The rejection test of the Background sampler, which
        draws up to 200 candidate windows a sample."""
        center = list(center)
        if self.shape[0] <= window[0]:
            center[0] = self.shape[0] // 2
        (y0, x0), (y1, x1) = crop_bounds(center, window)
        H, W = self.shape
        y0, x0, y1, x1 = max(int(y0), 0), max(int(x0), 0), \
            min(int(y1), H), min(int(x1), W)
        if y1 <= y0 or x1 <= x0:
            return False
        # the whole blocks inside [y0, y1) x [x0, x1): a block cut short
        # by the array's edge is whole where the window reaches that edge
        by0, bx0 = -(-y0 // _BLOCK), -(-x0 // _BLOCK)
        by1 = -(-y1 // _BLOCK) if y1 == H else y1 // _BLOCK
        bx1 = -(-x1 // _BLOCK) if x1 == W else x1 // _BLOCK
        labels = self.label_memmap()
        if by1 <= by0 or bx1 <= bx0:
            return bool(_fish(labels[y0:y1, x0:x1]).any())
        t = self._label_blocks()
        if t[by1, bx1] - t[by0, bx1] - t[by1, bx0] + t[by0, bx0]:
            return True
        ry0, rx0 = by0 * _BLOCK, bx0 * _BLOCK
        ry1, rx1 = min(by1 * _BLOCK, H), min(bx1 * _BLOCK, W)
        strips = ((y0, ry0, x0, x1), (ry1, y1, x0, x1),
                  (ry0, ry1, x0, rx0), (ry0, ry1, rx1, x1))
        return any(bool(_fish(labels[a:b, c:d]).any())
                   for a, b, c, d in strips if b > a and d > c)

    def _label_blocks(self):
        if self._blocks is None:
            with _BLOCKS_LOCK:
                if self._blocks is None:
                    self._blocks = _block_table(self.label_memmap())
        return self._blocks


def get_echograms(years="all", path_to_echograms=None,
                  frequencies=(18, 38, 120, 200), minimum_shape=256,
                  excluded_names=None):
    """Discover and filter echogram dirs (reference data_reader.py:1149-1187)."""
    from .. import paths
    from .exclusions import load_exclusion_file
    if path_to_echograms is None:
        path_to_echograms = paths.path_to_echograms()
    if excluded_names is None:
        excluded_names = load_exclusion_file(path_to_echograms)
    names = sorted(n for n in os.listdir(path_to_echograms) if "." not in n)
    echs = [Echogram(os.path.join(path_to_echograms, n)) for n in names]

    echs = [e for e in echs
            if all(f in e.frequencies for f in frequencies)
            and e.shape[0] > minimum_shape and e.shape[1] > minimum_shape
            and e.shape[1] == e.time_vector.shape[0]
            and e.name not in excluded_names
            and e.shape[1] == np.atleast_1d(e.heave).shape[0]]

    if years == "all":
        return echs
    if not isinstance(years, (list, tuple, np.ndarray)):
        years = [years]
    return [e for e in echs if e.year in years]
