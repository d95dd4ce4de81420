"""Plain readers of the benchmark's input surveys, for the reference:
the raw files both sides read, opened without the program's code."""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..yardstick.zarr_plain import PlainArray


class ZarrSurvey:
    """A zarr survey triplet ``<name>_{sv,labels,bottom}.zarr``."""

    def __init__(self, sv_path):
        base = sv_path[:-len("_sv.zarr")]
        self._sv = PlainArray(os.path.join(sv_path, "sv"))
        self._ann = PlainArray(os.path.join(base + "_labels.zarr",
                                            "annotation"))
        self.categories = [int(c) for c in PlainArray(os.path.join(
            base + "_labels.zarr", "category"))[:]]
        _, self.n_pings, self.n_range = self._sv.shape
        bottom = np.nan_to_num(PlainArray(os.path.join(
            base + "_bottom.zarr", "bottom_range"))[:], nan=0.0)
        self.seabed = bottom.argmax(axis=1)
        self.known = bottom.max(axis=1) > 0

    def sv(self, x0, x1, y1):
        """(y1, x1 - x0, C) raw sv of range rows [0, y1)."""
        return self._sv[:, x0:x1, :y1].transpose(2, 1, 0)

    def labels(self, s, e, rows):
        """(rows, e - s) category map: the last listed fish category wins
        where masks overlap, NaN where the category -1 mask is NaN."""
        masks = self._ann[:, s:e, :rows]
        tmpl = self.categories.index(-1) if -1 in self.categories else 0
        out = masks[tmpl] * 0
        for i, c in enumerate(self.categories):
            if c != -1:
                out = np.where(masks[i] > 0, float(c), out)
        return out.T


class MemmSurvey:
    """One memmap echogram directory."""

    def __init__(self, folder):
        def load(name):
            with open(os.path.join(folder, name + ".pkl"), "rb") as f:
                return pickle.load(f)
        self.n_range, self.n_pings = load("shape")
        freqs = [int(f) for f in np.asarray(load("frequencies")).ravel()]
        self._data = [np.memmap(os.path.join(folder,
                                             f"data_for_freq_{f}.dat"),
                                np.float32, "r",
                                shape=(self.n_range, self.n_pings))
                      for f in sorted(freqs)]
        self._labels = np.memmap(os.path.join(folder, "labels_heave.dat"),
                                 np.int16, "r",
                                 shape=(self.n_range, self.n_pings))
        self.seabed = np.load(os.path.join(folder, "seabed.npy"))
        self.known = np.ones(self.n_pings, bool)

    def sv(self, x0, x1, y1):
        return np.stack([m[:y1, x0:x1] for m in self._data], axis=-1)

    def labels(self, s, e, rows):
        return np.asarray(self._labels[:rows, s:e], np.float32)
