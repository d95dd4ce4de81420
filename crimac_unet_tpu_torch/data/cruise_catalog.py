"""Cruise-series catalog, snap/work/raw pairing, and data staging.

Pure-Python, network-free equivalent of the reference's offline MATLAB
metadata chain (reference ``data_preprocessing/generate_metadata.m:1-181``
builds ``DataOverview_<series>`` / ``DataPairedFiles_<series>`` tables from
the NMD API + a walk of the IMR cruise-data disk;
``generate_metadata2.m:1-67`` stages the paired snap/raw/bot files into
``data/<series>/<year>/``).  The NMD API itself is an IMR-internal web
service behind their firewall (generate_metadata.m:33-34), so the cruise
series description here comes from a plain JSON document instead — users
with API access export the ``NMDAPIreader_readcruiseseries`` structure once
and feed it in; everything downstream (directory scanning, file counting,
snap/work/raw pairing, .mat/.csv outputs, staging copies) is reproduced.

Cruise-series JSON schema (mirrors the MATLAB ``D`` struct,
generate_metadata.m:59-94)::

    [{"name": "<series>",
      "sampletime": [{"sampletime": "<year>",
                      "Cruise": [{"cruisenr": "...", "shipName": "...",
                                  "datapath": "<dir under data root>"}]}]}]

Outputs (variable names and column layouts match the MATLAB contract so
downstream consumers can swap tools without translation):

* ``DataOverview_<series>.mat`` — cell table ``DataStatus`` with header row
  CruiseSeries/Year/CruiseNr/ShipName/DataPath/Problem/Rawfiles/Snapfiles/
  Workfiles/RawfilesNotStdLocation/SnapfilesNotStdLocation/
  WorkfilesNotStdLocation (generate_metadata.m:120-123).
* ``DataPairedFiles_<series>.mat`` — per-cruise ``pairedfiles`` with
  ``F[i] = (snap, work, raw)`` full paths (generate_metadata.m:27-31).
* ``DataOverview_<series>.csv`` — ';'-separated dump (:166-175).
* :func:`stage_paired_files` — copy each paired (snap, raw, bot) triplet to
  ``<out>/data/<series>/<year>/<rawstem>.{snap,raw,bot}``
  (generate_metadata2.m:42-64; .bot is looked up next to the raw file and
  copied only when present, :50-57).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

# IMR standard locations of acoustic files inside a cruise directory
# (the MATLAB NMDAPIreader_getLSSSdatastatus convention: EK60 raw data and
# LSSS interpretation files; anything found elsewhere in the tree counts as
# "NotStdLocation", generate_metadata.m:120-123).  Same ACOUSTIC/...
# convention as data/ek60.py's convert_survey_raw, so the catalog and the
# raw-onboarding converter agree on what a cruise tree looks like.
STD_RAW_DIR = Path("ACOUSTIC/EK60/EK60_RAWDATA")
STD_SNAP_DIR = Path("ACOUSTIC/LSSS/INTERPRETATION")
STD_WORK_DIR = Path("ACOUSTIC/LSSS/WORK")

_HEADER = ["CruiseSeries", "Year", "CruiseNr", "ShipName", "DataPath",
           "Problem", "Rawfiles", "Snapfiles", "Workfiles",
           "RawfilesNotStdLocation", "SnapfilesNotStdLocation",
           "WorkfilesNotStdLocation"]

_EXT_STD = {".raw": STD_RAW_DIR, ".snap": STD_SNAP_DIR, ".work": STD_WORK_DIR}


def load_cruise_series(path) -> list[dict]:
    """Load the cruise-series description JSON (the offline stand-in for
    ``NMDAPIreader_readcruiseseries``, generate_metadata.m:59-66)."""
    with open(path) as f:
        series = json.load(f)
    if not isinstance(series, list):
        raise ValueError("cruise series JSON must be a list of series")
    for s in series:
        if "name" not in s or "sampletime" not in s:
            raise ValueError(f"series entry missing name/sampletime: {s}")
    return series


def scan_cruise_files(cruise_dir) -> tuple[list[int], dict[str, list[str]]]:
    """Count + list raw/snap/work files in one cruise directory.

    Returns (``filecount``, ``files``): filecount follows the MATLAB
    6-tuple (raw, snap, work at the standard location, then the same three
    elsewhere in the tree, generate_metadata.m:140-151); files maps
    extension -> sorted full paths (standard location first).
    """
    cruise_dir = Path(cruise_dir)
    std: dict[str, list[str]] = {e: [] for e in _EXT_STD}
    nonstd: dict[str, list[str]] = {e: [] for e in _EXT_STD}
    for p in sorted(cruise_dir.rglob("*")):
        ext = p.suffix.lower()
        if ext not in _EXT_STD or not p.is_file():
            continue
        # "standard location" means the exact convention directory; a file
        # in any sub- or side-directory (backup/, processing copies, ...)
        # counts as NotStdLocation
        in_std = p.parent.relative_to(cruise_dir) == _EXT_STD[ext]
        (std if in_std else nonstd)[ext].append(str(p))
    filecount = [len(std[".raw"]), len(std[".snap"]), len(std[".work"]),
                 len(nonstd[".raw"]), len(nonstd[".snap"]),
                 len(nonstd[".work"])]
    files = {ext: std[ext] + nonstd[ext] for ext in _EXT_STD}
    return filecount, files


def pair_files(files: dict[str, list[str]]) -> list[tuple[str, str, str]]:
    """Pair snap/work/raw files on their basename stem — the
    ``LSSSreader_pairfiles`` contract (generate_metadata.m:27-31,142):
    one row per unique stem, columns (snap, work, raw), empty string for a
    missing member, sorted by stem."""
    by_stem: dict[str, dict[str, str]] = {}
    for ext in (".snap", ".work", ".raw"):
        for f in files.get(ext, []):
            stem = Path(f).stem
            # standard-location files were listed first; keep the first hit
            by_stem.setdefault(stem, {}).setdefault(ext, f)
    return [(m.get(".snap", ""), m.get(".work", ""), m.get(".raw", ""))
            for stem, m in sorted(by_stem.items())]


def build_data_overview(series: dict, data_root) -> tuple[list, list]:
    """One cruise series -> (``DataStatus`` rows incl. header,
    per-cruise ``pairedfiles`` lists) — the crunch loop of
    generate_metadata.m:118-165.  Missing cruise directories get NaN
    counts and no paired files (:154-161)."""
    data_root = Path(data_root)
    rows: list[list] = [list(_HEADER)]
    paired: list[list[tuple[str, str, str]]] = []
    for st in series.get("sampletime", []):
        for cruise in st.get("Cruise", []):
            dpath = data_root / cruise.get("datapath", "")
            row = [series["name"], str(st["sampletime"]),
                   str(cruise.get("cruisenr", "")),
                   str(cruise.get("shipName", "")), str(dpath),
                   str(cruise.get("problem", ""))]
            if dpath.is_dir():
                filecount, files = scan_cruise_files(dpath)
                row += filecount
                paired.append(pair_files(files))
            else:
                row += [np.nan] * 6
                paired.append([])
            rows.append(row)
    return rows, paired


def _to_cell(rows) -> np.ndarray:
    """Nested lists -> MATLAB cell array (numpy object array) for
    scipy.io.savemat."""
    cell = np.empty((len(rows), len(rows[0])), dtype=object)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            cell[i, j] = v
    return cell


def save_overview(series: dict, data_root, out_dir) -> dict[str, str]:
    """Build + write the three outputs for one series; returns the paths
    (generate_metadata.m:162-175 save/fprintf layout)."""
    from scipy.io import savemat

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows, paired = build_data_overview(series, data_root)
    name = series["name"]

    mat_overview = out_dir / f"DataOverview_{name}.mat"
    savemat(str(mat_overview), {"DataStatus": _to_cell(rows)})

    mat_paired = out_dir / f"DataPairedFiles_{name}.mat"
    # each cruise entry is a STRUCT with field F (a cell table) — the
    # consumer generate_metadata2.m:42 reads dat.pairedfiles{i}.F, so a
    # bare cell array would crash MATLAB-side
    pf = np.empty((1, max(len(paired), 1)), dtype=object)
    for i, plist in enumerate(paired):
        pf[0, i] = {"F": _to_cell(plist) if plist
                    else np.empty((0, 3), object)}
    if not paired:
        pf[0, 0] = {"F": np.empty((0, 3), object)}
    savemat(str(mat_paired), {"pairedfiles": pf})

    csv = out_dir / f"DataOverview_{name}.csv"
    with open(csv, "w") as f:
        for row in rows:
            f.write(";".join("" if v != v else str(v) for v in row) + ";\n")
    return {"overview_mat": str(mat_overview),
            "paired_mat": str(mat_paired), "csv": str(csv)}


def stage_paired_files(series: dict, data_root, out_root,
                       overwrite=False, overview=None) -> list[str]:
    """Copy each paired (snap, raw[, bot]) triplet into
    ``<out_root>/data/<series>/<year>/<rawstem>.*`` —
    generate_metadata2.m:42-64.  Work files are not staged (the MATLAB
    uses columns 1 and 3 only, :41); a ``.bot`` sitting next to the raw
    file is staged when present (:50-57).  Pairs missing either member are
    skipped (:44).  Returns the created file paths.  Pass ``overview`` =
    a prior ``build_data_overview`` result to skip re-walking the cruise
    tree (large IMR trees live on network storage)."""
    out_root = Path(out_root)
    created: list[str] = []
    rows, paired = overview if overview is not None \
        else build_data_overview(series, data_root)
    for row, plist in zip(rows[1:], paired):
        year = row[1]
        dest = out_root / "data" / series["name"] / str(year)
        for snap, _work, raw in plist:
            if not snap or not raw:
                continue
            dest.mkdir(parents=True, exist_ok=True)
            stem = Path(raw).stem
            jobs = [(raw, dest / f"{stem}.raw"), (snap, dest / f"{stem}.snap")]
            bot = Path(raw).with_suffix(".bot")
            if bot.is_file():
                jobs.append((str(bot), dest / f"{stem}.bot"))
            for src, dst in jobs:
                if dst.exists() and not overwrite:
                    continue
                shutil.copyfile(src, dst)
                created.append(str(dst))
    return created
