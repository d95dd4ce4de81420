"""Korona/LSSS region exports -> heave-compensated label masks.

Counterpart of reference
data_preprocessing/generate_maskfromJson_python.py:27-154: parse an LSSS
"Korona" JSON ping list, rasterize its depth ranges onto the echogram grid
using per-ping transducer depths (HDF5), and revert the heave correction so
the mask aligns with the uncorrected sv data.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np


def lsss_time_to_datetime(t) -> datetime:
    """LSSS ISO timestamps, e.g. '2017-04-27T06:26:15.123Z'."""
    if isinstance(t, datetime):
        return t
    return datetime.fromisoformat(str(t).replace("Z", "+00:00")).replace(
        tzinfo=None)


def get_korona_list_from_json(path_json_korona) -> list:
    """Load + time-parse + monotonicity-check the Korona ping list
    (reference generate_maskfromJson_python.py:27-41)."""
    with open(path_json_korona) as f:
        korona = json.load(f)
    for ping in korona:
        ping["time"] = lsss_time_to_datetime(ping["time"])
    for i in range(len(korona) - 1):
        # validation of an EXTERNAL file: must survive python -O
        if korona[i]["time"] > korona[i + 1]["time"] or \
                korona[i]["pingNumber"] > korona[i + 1]["pingNumber"]:
            raise ValueError(
                "korona JSON pings are not sorted by time/pingNumber")
    return korona


def get_transducer_depths(echogram, root_depths=None) -> np.ndarray:
    """Per-ping transducer depths from ``<name>.h5``
    (reference generate_maskfromJson_python.py:44-55)."""
    import h5py

    if root_depths is None:
        from .. import paths
        root_depths = paths.path_to_korona_transducer_depths()
    file_path = os.path.join(str(root_depths), echogram.name + ".h5")
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"{file_path} does not exist")
    with h5py.File(file_path, "r") as f:
        key = list(f["transducer"])[0]
        return np.array(f["transducer"][key])


def compensate_heave(echogram, labels: np.ndarray) -> np.ndarray:
    """Revert the heave correction on a label mask
    (reference generate_maskfromJson_python.py:58-78) — delegates to the
    shared shift in data/preprocess.py so the two heave paths cannot
    diverge."""
    from .preprocess import heave_shift_labels
    return heave_shift_labels(labels, echogram.range_vector,
                              echogram.heave)


def get_korona_labels(echogram, korona_list, transducer_depths=None
                      ) -> np.ndarray:
    """Rasterize Korona depth ranges into a heave-compensated (H, W) mask
    (reference generate_maskfromJson_python.py:81-127)."""
    from .memmap_reader import _matlab_time_to_datetime

    range_vector = np.asarray(echogram.range_vector)
    time_vector = np.array([_matlab_time_to_datetime(t)
                            for t in np.asarray(echogram.time_vector)])
    shape_ech = echogram.shape

    pings = [p for p in korona_list
             if time_vector[0] <= p["time"] <= time_vector[-1]]

    labels = np.zeros(shape=shape_ech, dtype=np.int16)
    if transducer_depths is None:
        transducer_depths = get_transducer_depths(echogram)
    # accept both the h5 layout ((n_pings, 1)) and the 1-D vectors
    # ek60.extract_transducer_depths produces
    transducer_depths = np.asarray(transducer_depths, dtype=np.float64)
    if transducer_depths.ndim == 1:
        transducer_depths = transducer_depths[:, None]

    for ping in pings:
        n_x = int(np.argmax(ping["time"] <= time_vector))
        if not 0 <= n_x < shape_ech[1]:
            raise ValueError(
                f"korona ping time maps outside the echogram "
                f"({n_x} vs {shape_ech[1]} pings)")
        for minmax in ping["depthRanges"]:
            offset = transducer_depths[n_x, 0]
            if minmax["min"] < offset:
                raise ValueError(
                    f"korona region min depth {minmax['min']} above the "
                    f"transducer depth {offset}")
            # argmax of an all-False comparison is 0, which would
            # silently DROP regions extending below the echogram's last
            # range cell — clip them to the bottom instead
            def first_true_or(end, cond):
                return int(np.argmax(cond)) if cond.any() else end
            n_y_min = first_true_or(len(range_vector),
                                    minmax["min"] - offset < range_vector)
            n_y_max = first_true_or(len(range_vector),
                                    minmax["max"] - offset < range_vector)
            labels[n_y_min:n_y_max, n_x] = 1

    return compensate_heave(echogram, labels)
