"""Synthetic echogram fixtures for tests and on-card smoke runs.

The reference has no test data generators (SURVEY.md §4); these build
tiny but structurally faithful surveys from a seed in both on-disk
formats, as the JAX package's ``crimac_unet_tpu/data/fixtures.py`` does:

  * memmap echogram dirs matching the pickled-metadata + .dat contract
    (reference data/data_reader.py:84-113)
  * zarr survey triplets via :func:`echograms_to_zarr_survey`

Synthetic content: lognormal background noise, a strong seabed return along
a wavy seabed line, and elliptical fish schools (sandeel=27, other=1, plus an
optional unused species) whose 200 kHz response sits inside the
refine-label-boundary threshold window [1e-7, 1e-4]
(reference batch/label_transforms/refine_label_boundary.py:24-47).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..constants import DEFAULT_FREQUENCIES
# the school objects are built by the production converter, so the
# fixtures carry exactly the fields the real .mat onboarding produces
from .mat_to_memmap import objects_from_label_image


def _save_pickle(folder, name, obj):
    with open(os.path.join(folder, name) + ".pkl", "wb") as f:
        pickle.dump(obj, f, protocol=2)


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


def write_memmap_echogram(path, name, data, labels, heave,
                          frequencies=DEFAULT_FREQUENCIES,
                          range_step=0.18):
    """Write one memmap echogram dir with the reference on-disk contract.

    ``name`` must follow the reference naming convention
    ``<survey>-D<yyyymmdd>-T<hhmmss>`` (e.g. ``2017843-D20170427-T062615``):
    the date+time tokens seed the ping time vector, and the year lives at
    chars 9:13 (reference data_reader.py:73)."""
    if ("-D" not in name or "-T" not in name
            or len(name) < 13 or not name[9:13].isdigit()):
        # the positional contract matters: Echogram reads the year at
        # chars 9:13, so a wrong-length survey prefix silently yields a
        # garbage year that get_echograms' year filter then drops
        raise ValueError(
            f"echogram name {name!r} must follow the reference "
            f"'<survey>-D<yyyymmdd>-T<hhmmss>' convention (7-char "
            "survey code; the year lives at chars 9:13)")
    H, W, C = data.shape
    folder = os.path.join(str(path), name)
    os.makedirs(folder, exist_ok=True)

    _save_pickle(folder, "frequencies", np.asarray(frequencies, dtype=float))
    _save_pickle(folder, "range_vector",
                 np.arange(H, dtype=np.float64) * range_step)
    # MATLAB ordinal-date floats (reference data_reader.py:64-67); one
    # ping/s, starting at the date+time ENCODED IN THE NAME (so multiple
    # echograms of one survey get monotonic, non-overlapping ping_time —
    # the old hard-coded day made every echogram share timestamps, which
    # broke time-window matching across the concatenated survey axis)
    import datetime as _dt
    datestr = name.split("-D")[1][:8]
    timestr = name.split("-T")[1][:6]
    day = _dt.date(int(datestr[:4]), int(datestr[4:6]), int(datestr[6:8]))
    secs = (int(timestr[:2]) * 3600 + int(timestr[2:4]) * 60
            + int(timestr[4:6]))
    t0 = float(day.toordinal() + 366) + secs / 86400.0
    _save_pickle(folder, "time_vector",
                 t0 + np.arange(W, dtype=np.float64) / 86400.0)
    _save_pickle(folder, "heave", np.asarray(heave, dtype=np.float64))
    _save_pickle(folder, "data_dtype", "float32")
    _save_pickle(folder, "label_dtype", "int16")
    _save_pickle(folder, "shape", (H, W))
    _save_pickle(folder, "objects", objects_from_label_image(labels))

    for c, f in enumerate(frequencies):
        fp = np.memmap(os.path.join(folder, f"data_for_freq_{int(f)}.dat"),
                       dtype="float32", mode="w+", shape=(H, W))
        fp[:] = data[:, :, c]
        del fp
    fp = np.memmap(os.path.join(folder, "labels.dat"), dtype="int16",
                   mode="w+", shape=(H, W))
    fp[:] = labels
    del fp
    return folder


def make_survey_dir(path, year=2017, n_echograms=2, H=120, W=300, seed=0,
                    frequencies=DEFAULT_FREQUENCIES, n_schools=3,
                    unused_species=False):
    """Create a directory of synthetic memmap echograms for one survey year.

    Returns the list of echogram dir paths.  Echogram names follow the
    reference convention with the year at chars 9:13
    (reference data_reader.py:73)."""
    rng = np.random.RandomState(seed)
    dirs = []
    for i in range(n_echograms):
        import datetime as _dt
        d = _dt.date(year, 4, 27) + _dt.timedelta(days=i)
        name = f"{year}843-D{d:%Y%m%d}-T0626{i % 60:02d}"
        data, labels, heave, _ = make_synthetic_echogram(
            H, W, rng, frequencies, n_schools=n_schools,
            unused_species=unused_species)
        dirs.append(write_memmap_echogram(path, name, data, labels, heave,
                                          frequencies))
    return dirs


def make_zarr_survey(path, year=2017, n_echograms=2, H=120, W=300, seed=0,
                     frequencies=DEFAULT_FREQUENCIES, n_schools=3,
                     unused_species=False, layout="flat"):
    """Create a synthetic zarr survey triplet.

    ``layout='nested'`` reproduces the production directory layout
    ``<root>/<year>/S<survey>/ACOUSTIC/GRIDDED/<survey>_sv.zarr``
    (reference data_reader.py:1129-1133); ``'flat'`` writes directly to
    ``path``.  Returns the path to the ``_sv.zarr`` store.
    """
    import tempfile

    from .memmap_reader import Echogram
    from .preprocess import echograms_to_zarr_survey

    survey_name = f"S{year}843"
    if layout == "nested":
        out_dir = os.path.join(str(path), str(year), survey_name,
                               "ACOUSTIC", "GRIDDED")
    else:
        out_dir = str(path)

    with tempfile.TemporaryDirectory() as tmp:
        dirs = make_survey_dir(tmp, year, n_echograms, H, W, seed,
                               frequencies, n_schools, unused_species)
        echs = [Echogram(d) for d in dirs]
        cats = [-1, 1, 27] + ([6] if unused_species else [])
        echograms_to_zarr_survey(echs, out_dir, survey_name, categories=cats)
    return os.path.join(out_dir, f"{survey_name}_sv.zarr")


def write_raw_trio(reader, root):
    """Write a memmap echogram as the EK60 files of one cruise directory:
    ``<root>/ACOUSTIC/EK60/EK60_RAWDATA/<name>.raw`` and ``.bot``, and
    ``<root>/ACOUSTIC/LSSS/INTERPRETATION/<name>.snap`` (the layout
    ``ek60.convert_survey_raw`` walks).

    The RAW0 power samples invert the echogram's linear sv (int16 power,
    so a step of 10*log10(2)/256 dB), at the ping times of its
    ``time_vector`` and its heave, transducer at the surface.  The
    ``.snap`` holds one rectangle per school object, half a cell outside
    its bounding box, with the object's category, so the rasterized label
    image is nonzero exactly inside the boxes.  The ``.bot`` puts the
    bottom at the last range sample, so the ``percentile(bottom, 98) +
    15 m`` crop keeps every row.  Returns the ``.raw`` path."""
    from . import ek60

    rv = np.asarray(reader.range_vector, dtype=np.float64)
    dr = float(rv[1] - rv[0])
    c = 1500.0
    si = 2.0 * dr / c  # the sample interval that gives the reader's range step
    name = reader.name
    raw_dir = os.path.join(str(root), "ACOUSTIC", "EK60", "EK60_RAWDATA")
    snap_dir = os.path.join(str(root), "ACOUSTIC", "LSSS", "INTERPRETATION")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(snap_dir, exist_ok=True)
    # MATLAB serial day numbers -> unix seconds
    times = (np.asarray(reader.time_vector, np.float64) - 719529.0) * 86400.0
    freqs = [int(f) for f in np.asarray(reader.frequencies)]
    sv = reader.data_numpy(freqs).astype(np.float64)
    raw = ek60.write_raw_fixture(
        os.path.join(raw_dir, name + ".raw"), sv, freqs, times,
        sample_interval=si, sound_velocity=c, transducer_depth=0.0,
        heave=np.atleast_1d(np.asarray(reader.heave, np.float64)))
    r = np.arange(sv.shape[0]) * (c * si / 2.0)
    ek60.write_bot_fixture(os.path.join(raw_dir, name + ".bot"), times,
                           np.full((len(times), len(freqs)), r[-1]))
    half = c * si / 4.0
    schools = []
    for obj in reader.objects:
        y0, y1, x0, x1 = obj["bounding_box"]
        # ping columns are 1-based in the snap's x (ek60._rasterize_schools)
        xa, xb = x0 + 0.5, x1 + 1.5
        ya, yb = r[y0] - half, r[y1] + half
        schools.append({"x": [xa, xb, xb, xa], "y": [ya, ya, yb, yb],
                        "species": [(int(obj["fish_type_index"]), 1.0)]})
    ek60.write_snap_fixture(os.path.join(snap_dir, name + ".snap"), schools)
    return raw
