"""Offline preprocessing: heave reversal of memmap label files (which the
memmap reader generates lazily), seabed caching and the memmap -> zarr
survey conversion.

The port's copy of the JAX package's ``crimac_unet_tpu/data/
preprocess.py`` (reference crimac_unet/data_preprocessing/
generate_heave_compensation_files.py:31-63, estimate_seabed.py:24-35,
memmap_to_zarr.py:34-171);
the objects CSV is written with the ``csv`` module, in pandas' layout.
"""

from __future__ import annotations

import os

import numpy as np


def heave_shift_labels(labels: np.ndarray, range_vector,
                       heave) -> np.ndarray:
    """Shift each label column (ping) vertically by
    ``round(heave / median-range-step)`` pixels — the single source of
    truth for the heave reversal used by both ``labels_heave.dat``
    generation and the Korona mask path
    (reference generate_heave_compensation_files.py:31-63 ==
    generate_maskfromJson_python.py:58-78)."""
    r = np.asarray(range_vector)
    r_diff = np.median(r[1:] - r[:-1])
    shifts = np.round(np.atleast_1d(heave) / r_diff).astype(int)
    if shifts.size != labels.shape[1]:
        raise ValueError(f"heave vector has {shifts.size} entries for "
                         f"{labels.shape[1]} pings")
    out = np.zeros_like(labels)
    for x, h in enumerate(shifts):
        if h == 0:
            out[:, x] = labels[:, x]
        elif h > 0:
            out[:-h, x] = labels[h:, x]
        else:
            out[-h:, x] = labels[:h, x]
    return out


def matlab_time_to_datetime64(time_vector) -> np.ndarray:
    """MATLAB ordinal-date floats -> datetime64[ns], vectorized
    (reference memmap_to_zarr.py:28-31; same epoch arithmetic as
    memmap_reader._matlab_time_to_datetime)."""
    t = np.asarray(time_vector, dtype=np.float64)
    # split whole days (exact int64 arithmetic) from the day fraction
    # (< 1, so float64 keeps sub-us precision) — multiplying the full
    # ordinal by ns/day would lose ~us of precision
    days_int = np.floor(t).astype(np.int64)
    frac = t - days_int
    # quantize the fraction to MICROSECONDS with round-half-even — the
    # exact law of the reference's timedelta(days=frac) arithmetic
    # (memmap_to_zarr.py:29-31; datetime.timedelta rounds fractional
    # microseconds half-to-even), verified bit-equal in
    # tests/test_reference_parity_preprocess.py.  A 2017 MATLAB ordinal
    # resolves to ~14 us in float64, so sub-us digits are representation
    # noise anyway.
    us = np.round(frac * 86_400_000_000.0).astype(np.int64)
    # ordinal 719163 == 1970-01-01; MATLAB ordinals carry a +366-day shift
    ns = ((days_int - 719163 - 366) * 86_400_000_000 + us) * 1000
    return ns.astype("<M8[ns]")


def write_heave_reverted_labels(echogram, force_write: bool = False) -> None:
    """Create ``labels_heave.dat`` by shifting each label column (ping)
    vertically by ``round(heave / median-range-step)`` pixels so labels align
    with the uncorrected sv data
    (reference generate_heave_compensation_files.py:31-63)."""
    path = os.path.join(echogram.path, "labels_heave.dat")
    if os.path.isfile(path) and not force_write:
        return

    labels_old = echogram.label_numpy(heave=False)
    labels_new = heave_shift_labels(labels_old, echogram.range_vector,
                                    echogram.heave)

    # atomic write: lazy generation can race between prefetch threads
    # (a reader must never mmap a half-written file)
    import tempfile
    fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(path),
                                    suffix=".heave.tmp")
    os.close(fd)
    fp = np.memmap(tmp_path, dtype=echogram.label_dtype, mode="w+",
                   shape=labels_new.shape)
    fp[:] = labels_new.astype(echogram.label_dtype)
    fp.flush()
    del fp
    os.replace(tmp_path, path)


def batch_estimate_seabed(echograms, force=False) -> None:
    """Precompute + cache ``seabed.npy`` for a list of echograms
    (reference data_preprocessing/estimate_seabed.py:24-35)."""
    for ech in echograms:
        ech.get_seabed(0, ech.shape[1], save_to_file=True,
                       ignore_saved=force)


def echograms_to_zarr_survey(echograms, out_dir, survey_name,
                             categories=(-1, 1, 27), compressor="blosc"):
    """Convert memmap echograms of one survey into the zarr survey triplet
    ``<name>_sv.zarr`` / ``_labels.zarr`` / ``_bottom.zarr`` + objects CSV
    (reference data_preprocessing/memmap_to_zarr.py:34-171).

    ``compressor="blosc"`` (default) writes the production codec (Blosc
    lz4-5 byte-shuffle, the zarr/xarray default that real CRIMAC survey
    triplets carry), falling back to zlib when no blosc backend loads.

    Padding conventions mirror the reference converter exactly: sv is
    nan-padded in range to the tallest echogram (memmap_to_zarr.py:41-44),
    annotation masks are ZERO-padded (memmap_to_zarr.py:75-79), and the
    bottom mask is nan above the seabed line and 1.0 from the seabed down to
    max range (memmap_to_zarr.py:104-107).
    """
    os.makedirs(out_dir, exist_ok=True)
    frequencies = np.asarray(echograms[0].frequencies, dtype=np.int64)
    max_range = max(e.shape[0] for e in echograms)
    n_pings_total = sum(e.shape[1] for e in echograms)
    range_vector = None
    for e in echograms:
        if e.shape[0] == max_range:
            range_vector = np.asarray(e.range_vector, dtype=np.float64)
            break

    from .zarr_reader import write_objects_csv
    from .zarrlite import ZGroup

    sv_group = ZGroup.create(os.path.join(out_dir, f"{survey_name}_sv.zarr"),
                             attrs={"description": "sv data"}, overwrite=True)
    ping_chunk = 1024
    sv = sv_group.create_array(
        "sv", (len(frequencies), n_pings_total, max_range),
        (1, ping_chunk, max_range), np.float32, fill_value=np.nan,
        dims=["frequency", "ping_time", "range"], compressor=compressor)
    sv_group.create_array("frequency", frequencies.shape, frequencies.shape,
                          np.float32, fill_value=None, compressor=None,
                          dims=["frequency"])[:] = frequencies.astype(np.float32)
    sv_group.create_array("range", (max_range,), (max_range,), np.float64,
                          fill_value=None, compressor=None,
                          dims=["range"])[:] = range_vector

    lab_group = ZGroup.create(
        os.path.join(out_dir, f"{survey_name}_labels.zarr"),
        attrs={"description": "annotation masks"}, overwrite=True)
    ann = lab_group.create_array(
        "annotation", (len(categories), n_pings_total, max_range),
        (1, ping_chunk, max_range), np.float32, fill_value=np.nan,
        dims=["category", "ping_time", "range"], compressor=compressor)
    lab_group.create_array("category", (len(categories),), (len(categories),),
                           np.int64, fill_value=None, compressor=None,
                           dims=["category"])[:] = np.asarray(categories)

    bot_group = ZGroup.create(
        os.path.join(out_dir, f"{survey_name}_bottom.zarr"),
        attrs={"description": "seabed mask"}, overwrite=True)
    bottom = bot_group.create_array(
        "bottom_range", (n_pings_total, max_range),
        (ping_chunk, max_range), np.float32, fill_value=np.nan,
        dims=["ping_time", "range"], compressor=compressor)

    ping_times = np.empty(n_pings_total, dtype="<M8[ns]")
    heave = np.empty(n_pings_total, dtype=np.float64)
    raw_files = np.empty(n_pings_total, dtype="|S64")

    rows = []
    obj_id = 0
    p0 = 0
    for ech in echograms:
        H, W = ech.shape
        data = ech.data_numpy(frequencies)       # (H, W, C)
        labels = ech.label_numpy()               # (H, W)
        seabed = ech.get_seabed(0, W)

        cube = np.full((len(frequencies), W, max_range), np.nan, np.float32)
        cube[:, :, :H] = np.transpose(data, (2, 1, 0))
        sv[:, p0:p0 + W, :] = cube

        masks = np.zeros((len(categories), W, max_range), np.float32)
        for ci, cat in enumerate(categories):
            masks[ci, :, :H] = (labels == cat).T.astype(np.float32)
        ann[:, p0:p0 + W, :] = masks

        cols_idx = np.arange(max_range)[None, :]
        bot = np.where(cols_idx >= seabed[:, None], 1.0, np.nan
                       ).astype(np.float32)
        bottom[p0:p0 + W, :] = bot

        ping_times[p0:p0 + W] = matlab_time_to_datetime64(ech.time_vector)
        heave[p0:p0 + W] = np.atleast_1d(ech.heave)[:W]
        raw_files[p0:p0 + W] = (ech.name + ".raw").encode()

        for obj in ech.objects:
            y0, y1, x0, x1 = obj["bounding_box"]
            center_ping = int(x0) + (int(x1) - int(x0)) // 2
            rows.append({
                "object": obj_id,
                "category": int(obj["fish_type_index"]),
                "upperdepthindex": int(y0),
                "lowerdepthindex": int(y1),
                "startpingindex": int(x0) + p0,
                "endpingindex": int(x1) + p0,
                "upperdepth": float(range_vector[min(int(y0), max_range - 1)]),
                "lowerdepth": float(range_vector[min(int(y1), max_range - 1)]),
                "distance_to_seabed": float(
                    seabed[min(center_ping, W - 1)] - int(y1)),
                "valid_object": True,
            })
            obj_id += 1
        p0 += W

    sv_group.create_array("ping_time", (n_pings_total,), (n_pings_total,),
                          "<M8[ns]", fill_value=None, compressor=None,
                          dims=["ping_time"])[:] = ping_times
    sv_group.create_array("heave", (n_pings_total,), (n_pings_total,),
                          np.float64, fill_value=None, compressor=None,
                          dims=["ping_time"])[:] = heave
    sv_group.create_array("raw_file", (n_pings_total,), (n_pings_total,),
                          "|S64", fill_value=None, compressor=None,
                          dims=["ping_time"])[:] = raw_files
    lab_group.create_array("ping_time", (n_pings_total,), (n_pings_total,),
                           "<M8[ns]", fill_value=None, compressor=None,
                           dims=["ping_time"])[:] = ping_times
    bot_group.create_array("ping_time", (n_pings_total,), (n_pings_total,),
                           "<M8[ns]", fill_value=None, compressor=None,
                           dims=["ping_time"])[:] = ping_times
    for grp in (lab_group, bot_group):
        grp.create_array("range", (max_range,), (max_range,), np.float64,
                         fill_value=None, compressor=None,
                         dims=["range"])[:] = range_vector
    # production stores written by xarray carry consolidated metadata;
    # match it so real-zarr consumers can open_consolidated our triplets
    for grp in (sv_group, lab_group, bot_group):
        grp.consolidate()

    # explicit columns: a survey with ZERO school objects must still write
    # a header row (a columnless CSV crashes every downstream reader)
    obj_cols = ["object", "category", "upperdepthindex", "lowerdepthindex",
                "startpingindex", "endpingindex", "upperdepth",
                "lowerdepth", "distance_to_seabed", "valid_object"]
    write_objects_csv(
        os.path.join(out_dir, f"{survey_name}_labels.parquet.csv"),
        {c: [r[c] for r in rows] for c in obj_cols})
