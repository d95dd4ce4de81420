"""The benchmark's input surveys, made from a seed.

``make_synthetic_echogram`` is a frozen copy of
``crimac_unet_tpu_torch/data/fixtures.py`` ``make_synthetic_echogram`` at
commit d20381e, unchanged.  ``write_memmap_echogram``,
``make_survey_dir`` and ``make_zarr_survey`` follow that file's functions
of the same names (and ``data/preprocess.py``
``echograms_to_zarr_survey``, ``data/mat_to_memmap.py``
``objects_from_label_image``) at the same commit, writing the same
on-disk layouts with plain numpy, pickle and :mod:`.zarr_plain`:

* a memmap echogram directory: pickled metadata, one float32
  ``data_for_freq_<f>.dat`` per frequency, int16 ``labels.dat``; besides,
  ``seabed.npy`` (the generated seabed line, the reader's cached seabed
  estimate) and ``labels_heave.dat`` (the heave-reverted labels, which
  the reader otherwise derives; the generated heave of at most 0.05 m
  against a 0.18 m range step shifts no row), so that both the program
  and the reference read the same seabed and labels;
* a zarr survey triplet ``S<year>843_{sv,labels,bottom}.zarr``, zlib
  chunks of 1024 pings over the whole range, as the converter writes it
  where no Blosc backend loads.  The objects CSV is not written:
  prediction does not read it.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np

from . import zarr_plain

DEFAULT_FREQUENCIES = (18, 38, 120, 200)
RANGE_STEP = 0.18


def make_synthetic_echogram(H, W, rng, frequencies=DEFAULT_FREQUENCIES,
                            n_schools=3, unused_species=False,
                            seabed_frac=0.8):
    """Generate ``(data (H,W,C) float32, labels (H,W) int16, heave (W,),
    seabed (W,))`` arrays."""
    C = len(frequencies)
    data = rng.lognormal(mean=np.log(1e-8), sigma=0.5,
                         size=(H, W, C)).astype(np.float32)

    # Wavy seabed line with a strong return below it
    base = int(H * seabed_frac)
    seabed = (base + 3 * np.sin(np.arange(W) / 37.0)
              + rng.randint(-1, 2, size=W)).astype(int)
    seabed = np.clip(seabed, 8, H - 2)
    rows = np.arange(H)[:, None]
    below = rows >= seabed[None, :]
    data[below] = rng.lognormal(np.log(1e-2), 0.3,
                                size=(below.sum(), C)).astype(np.float32)
    # sharp seabed edge: one very bright row at the line (with ping jitter so
    # the column-max z-score used in seabed repair is non-degenerate)
    edge = rows == seabed[None, :]
    data[edge] = (0.05 * rng.uniform(0.8, 1.2, size=(int(edge.sum()), 1))
                  ).astype(np.float32)

    labels = np.zeros((H, W), dtype=np.int16)
    cats = [27, 1] + ([6] if unused_species else [])
    # always include two near-seabed schools (sandeel + other) so the
    # SchoolSeabed samplers have candidates — categories pinned, NOT
    # drawn from the k%len(cats) cycle, which for some n_schools left
    # the seabed pair without a sandeel or without an 'other'
    for k in range(n_schools + 2):
        if k == n_schools:
            cat = 27
        elif k == n_schools + 1:
            cat = 1
        else:
            cat = cats[k % len(cats)]
        ry = max(2, rng.randint(H // 30, max(H // 10, H // 30 + 1)))
        rx = max(3, rng.randint(W // 25, max(W // 8, W // 25 + 1)))
        if k >= n_schools:
            cy = max(2, base - ry - 3)  # hugging the seabed line
        else:
            cy = rng.randint(int(0.15 * H),
                             max(int(0.6 * H), int(0.15 * H) + 1))
        cx = rng.randint(int(0.1 * W), max(int(0.9 * W), int(0.1 * W) + 1))
        # the ellipse within its bounding box only: the same mask, filled
        # in the same row-major order, as over the whole grid, at a cost
        # that does not grow with the echogram (a 50 000-ping survey
        # carries 200 schools)
        y0, y1 = max(cy - ry, 0), min(cy + ry + 1, H)
        x0, x1 = max(cx - rx, 0), min(cx + rx + 1, W)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        ellipse = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        ellipse &= ~below[y0:y1, x0:x1]
        labels[y0:y1, x0:x1][ellipse] = cat
        # School backscatter inside the refine threshold window at 200 kHz
        for c in range(C):
            data[y0:y1, x0:x1, c][ellipse] = rng.lognormal(
                np.log(3e-6), 0.4, size=int(ellipse.sum()))

    heave = rng.uniform(-0.05, 0.05, size=W)
    return data, labels, heave, seabed


def objects_from_label_image(label_img):
    """Connected components per fish type -> the reference's 'objects'
    dicts (``data/mat_to_memmap.py`` at d20381e)."""
    from scipy import ndimage
    objects = []
    for fish_type_ind in np.unique(label_img):
        if fish_type_ind == 0:
            continue
        labeled_img, n_components = ndimage.label(label_img == fish_type_ind)
        slices = ndimage.find_objects(labeled_img)
        for i in range(1, n_components + 1):
            sl = slices[i - 1]
            local = np.argwhere(labeled_img[sl] == i)
            idx = local + np.array([sl[0].start, sl[1].start])
            bbox = [int(idx[:, 0].min()), int(idx[:, 0].max()),
                    int(idx[:, 1].min()), int(idx[:, 1].max())]
            area = (bbox[1] - bbox[0] + 1) * (bbox[3] - bbox[2] + 1)
            objects.append({
                "fish_type_index": int(fish_type_ind),
                "indexes": idx,
                "n_pixels": int(idx.shape[0]),
                "bounding_box": bbox,
                "labeled_as_segmentation": area != idx.shape[0],
            })
    return objects


def _pickle(folder, name, obj):
    with open(os.path.join(folder, name) + ".pkl", "wb") as f:
        pickle.dump(obj, f, protocol=2)


def _echogram_name(year, i):
    d = datetime.date(year, 4, 27) + datetime.timedelta(days=i)
    return f"{year}843-D{d:%Y%m%d}-T0626{i % 60:02d}"


def _matlab_times(name, W):
    """One ping a second from the date and time in the echogram's name,
    as MATLAB ordinal-date floats."""
    datestr = name.split("-D")[1][:8]
    timestr = name.split("-T")[1][:6]
    day = datetime.date(int(datestr[:4]), int(datestr[4:6]),
                        int(datestr[6:8]))
    secs = (int(timestr[:2]) * 3600 + int(timestr[2:4]) * 60
            + int(timestr[4:6]))
    t0 = float(day.toordinal() + 366) + secs / 86400.0
    return t0 + np.arange(W, dtype=np.float64) / 86400.0


def heave_shift_rows(heave, range_step=RANGE_STEP):
    return np.round(np.asarray(heave) / range_step).astype(np.int64)


def write_memmap_echogram(path, name, data, labels, heave, seabed,
                          frequencies=DEFAULT_FREQUENCIES):
    """One memmap echogram directory (module docstring)."""
    H, W, C = data.shape
    if np.any(heave_shift_rows(heave)):
        raise ValueError("the generated heave shifts label rows; the "
                         "labels_heave.dat written here assumes none")
    folder = os.path.join(str(path), name)
    os.makedirs(folder, exist_ok=True)
    _pickle(folder, "frequencies", np.asarray(frequencies, dtype=float))
    _pickle(folder, "range_vector",
            np.arange(H, dtype=np.float64) * RANGE_STEP)
    _pickle(folder, "time_vector", _matlab_times(name, W))
    _pickle(folder, "heave", np.asarray(heave, dtype=np.float64))
    _pickle(folder, "data_dtype", "float32")
    _pickle(folder, "label_dtype", "int16")
    _pickle(folder, "shape", (H, W))
    _pickle(folder, "objects", objects_from_label_image(labels))
    for c, f in enumerate(frequencies):
        np.ascontiguousarray(data[:, :, c]).tofile(
            os.path.join(folder, f"data_for_freq_{int(f)}.dat"))
    labels = np.ascontiguousarray(labels, dtype=np.int16)
    labels.tofile(os.path.join(folder, "labels.dat"))
    labels.tofile(os.path.join(folder, "labels_heave.dat"))
    np.save(os.path.join(folder, "seabed.npy"),
            np.asarray(seabed, dtype=np.int64))
    return folder


def make_survey_dir(path, year, n_echograms, H, W, seed,
                    frequencies=DEFAULT_FREQUENCIES, n_schools=3):
    """A directory of memmap echograms of one survey year; returns their
    directories."""
    rng = np.random.RandomState(seed)
    dirs = []
    for i in range(n_echograms):
        name = _echogram_name(year, i)
        data, labels, heave, seabed = make_synthetic_echogram(
            H, W, rng, frequencies, n_schools=n_schools)
        dirs.append(write_memmap_echogram(path, name, data, labels, heave,
                                          seabed, frequencies))
    return dirs


def make_zarr_survey(path, year, H, W, seed,
                     frequencies=DEFAULT_FREQUENCIES, n_schools=3):
    """A zarr survey triplet of one echogram, nested as the production
    tree ``<path>/<year>/S<year>843/ACOUSTIC/GRIDDED/``; returns the
    ``_sv.zarr`` path."""
    rng = np.random.RandomState(seed)
    data, labels, heave, seabed = make_synthetic_echogram(
        H, W, rng, frequencies, n_schools=n_schools)
    name = f"S{year}843"
    out = os.path.join(str(path), str(year), name, "ACOUSTIC", "GRIDDED")
    ping_time = _ping_times_ns(_echogram_name(year, 0), W)
    rng_vec = np.arange(H, dtype=np.float64) * RANGE_STEP
    chunk = (1, 1024, H)

    sv = zarr_plain.write_group(os.path.join(out, f"{name}_sv.zarr"),
                                {"description": "sv data"})
    zarr_plain.write_array(sv, "sv", np.transpose(data, (2, 1, 0)), chunk,
                           fill_value=np.float32(np.nan),
                           dims=["frequency", "ping_time", "range"])
    del data
    zarr_plain.write_array(sv, "frequency",
                           np.asarray(frequencies, np.float32),
                           compress=False, dims=["frequency"])
    zarr_plain.write_array(sv, "range", rng_vec, compress=False,
                           dims=["range"])
    zarr_plain.write_array(sv, "ping_time", ping_time, compress=False,
                           dims=["ping_time"])
    zarr_plain.write_array(sv, "heave", np.asarray(heave, np.float64),
                           compress=False, dims=["ping_time"])

    cats = [-1, 1, 27]
    lab = zarr_plain.write_group(os.path.join(out, f"{name}_labels.zarr"),
                                 {"description": "annotation masks"})
    masks = np.stack([(labels == c).T.astype(np.float32) for c in cats])
    zarr_plain.write_array(lab, "annotation", masks, chunk,
                           fill_value=np.float32(np.nan),
                           dims=["category", "ping_time", "range"])
    del masks
    zarr_plain.write_array(lab, "category", np.asarray(cats, np.int64),
                           compress=False, dims=["category"])

    bot = zarr_plain.write_group(os.path.join(out, f"{name}_bottom.zarr"),
                                 {"description": "seabed mask"})
    below = np.arange(H)[None, :] >= np.asarray(seabed)[:, None]
    zarr_plain.write_array(bot, "bottom_range",
                           np.where(below, 1.0, np.nan).astype(np.float32),
                           chunk[1:], fill_value=np.float32(np.nan),
                           dims=["ping_time", "range"])
    for grp in (lab, bot):
        zarr_plain.write_array(grp, "ping_time", ping_time, compress=False,
                               dims=["ping_time"])
        zarr_plain.write_array(grp, "range", rng_vec, compress=False,
                               dims=["range"])
    return os.path.join(out, f"{name}_sv.zarr")


def _ping_times_ns(name, W):
    """One ping a second from the date and time in the name, as
    datetime64[ns] (the times ``_matlab_times`` encodes)."""
    d, t = name.split("-D")[1][:8], name.split("-T")[1][:6]
    t0 = np.datetime64(f"{d[:4]}-{d[4:6]}-{d[6:]}T{t[:2]}:{t[2:4]}:{t[4:]}",
                       "ns")
    return t0 + np.arange(W).astype("m8[s]").astype("m8[ns]")
