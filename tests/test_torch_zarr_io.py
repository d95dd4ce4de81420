"""Zarr survey I/O: the port's codec, zarrlite, reader and converter against
the JAX package's.

Stores written by either package are read by both; the port's fixtures
write the JAX package's survey; the reader's accessors (slices, the HWC
slab read, labels, seabed, objects) return what the JAX reader returns,
the objects CSV parsed without pandas.  Stated tolerance: bit-equal
everywhere (no arithmetic beyond the float32 -> bfloat16 rounding, which
is pinned to torch's on finite values).
"""

import json
import os
import shutil

import ml_dtypes
import numpy as np
import pandas as pd
import pytest
import torch

from crimac_unet_tpu.data import blosc_codec as jax_codec
from crimac_unet_tpu.data import zarrlite as jax_zl
from crimac_unet_tpu.data.fixtures import make_zarr_survey as jax_make_zarr
from crimac_unet_tpu.data.preprocess import \
    matlab_time_to_datetime64 as jax_matlab_time
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
from crimac_unet_tpu.data.zarr_reader import \
    get_zarr_readers as jax_get_zarr_readers
from crimac_unet_tpu_torch.data import blosc_codec, zarrlite
from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.data.preprocess import matlab_time_to_datetime64
from crimac_unet_tpu_torch.data.zarr_reader import (DataReaderZarr,
                                                    get_zarr_readers)

H, W, SEED = 120, 300, 23
COMPRESSORS = ["zlib", "blosc", "blosc-zstd", None]


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """The same survey written by each package, flat and nested."""
    root = tmp_path_factory.mktemp("zarrio")
    out = {}
    for layout in ("flat", "nested"):
        for who, make in (("jax", jax_make_zarr), ("port", make_zarr_survey)):
            out[who, layout] = make(root / f"{who}_{layout}", year=2017,
                                    n_echograms=2, H=H, W=W, seed=SEED,
                                    unused_species=True, layout=layout)
    return out


def _tree(store):
    """{relative path: bytes} of every file of a store."""
    files = {}
    for dirpath, _, names in os.walk(store):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, store)] = f.read()
    return files


@pytest.mark.parametrize("layout", ["flat", "nested"])
def test_port_fixture_writes_the_jax_survey(surveys, layout):
    """make_zarr_survey writes byte-identical stores and objects CSV."""
    jax_sv, sv = surveys["jax", layout], surveys["port", layout]
    assert os.path.basename(sv) == os.path.basename(jax_sv)
    jdir, pdir = os.path.dirname(jax_sv), os.path.dirname(sv)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    for n in names:
        a, b = os.path.join(jdir, n), os.path.join(pdir, n)
        if os.path.isdir(a):
            assert _tree(a) == _tree(b), n
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n


def test_matlab_time_matches_jax():
    t = 736800.0 + np.random.RandomState(1).uniform(0, 3, 500)
    t[:3] = [736800.0, 736800.5, 736800.999999999]
    np.testing.assert_array_equal(matlab_time_to_datetime64(t),
                                  jax_matlab_time(t))


def _write(zl, path, compressor, data, chunks):
    g = zl.ZGroup.create(path, attrs={"description": "x"}, overwrite=True)
    a = g.create_array("v", data.shape, chunks, data.dtype,
                       fill_value=np.nan, compressor=compressor,
                       dims=["a", "b", "c"])
    a[:] = data
    g.consolidate()
    return g


@pytest.mark.parametrize("compressor", COMPRESSORS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_cross_read(tmp_path, compressor, writer):
    """A store written by either package reads identically in both, and
    both write the same metadata and chunk bytes."""
    rng = np.random.RandomState(2)
    data = rng.lognormal(-10, 3, (3, 50, 37)).astype(np.float32)
    data[0, 3:7] = np.nan
    data[1, :, 5] = np.inf
    zls = {"jax": jax_zl, "port": zarrlite}
    _write(zls[writer], tmp_path / "s.zarr", compressor, data, (1, 16, 37))
    _write(zls["port" if writer == "jax" else "jax"], tmp_path / "o.zarr",
           compressor, data, (1, 16, 37))
    for zl in (jax_zl, zarrlite):
        for opener in (zl.ZGroup.open, zl.ZGroup.open_consolidated):
            got = opener(tmp_path / "s.zarr")["v"][:]
            np.testing.assert_array_equal(got, data)
            sub = opener(tmp_path / "s.zarr")["v"][1:3, 10:41, 2:30]
            np.testing.assert_array_equal(sub, data[1:3, 10:41, 2:30])
    assert _tree(tmp_path / "s.zarr") == _tree(tmp_path / "o.zarr")


@pytest.mark.parametrize("compressor", ["zlib", "blosc-zstd"])
def test_append_resize_consolidate_match_jax(tmp_path, compressor):
    """append along an axis, resize (shrink and grow) and consolidate
    leave the same files in both packages."""
    rng = np.random.RandomState(3)
    parts = [rng.rand(2, n, 20).astype(np.float16) for n in (7, 16, 5)]
    for who, zl in (("jax", jax_zl), ("port", zarrlite)):
        g = zl.ZGroup.create(tmp_path / who, attrs={"description": "p"})
        a = g.create_array("annotation", (2, 0, 20), (1, 8, 20), np.float16,
                           fill_value=0, compressor=compressor,
                           dims=["category", "ping_time", "range"])
        t = g.create_array("ping_time", (0,), (8192,), "<M8[ns]",
                           fill_value=None, compressor=None,
                           dims=["ping_time"])
        for k, p in enumerate(parts):
            a.append(p, axis=1)
            t.append(np.arange(k * 100, k * 100 + p.shape[1]).astype(
                "<M8[ns]"), axis=0)
        a.resize([2, 20, 20])
        a.resize([2, 24, 20])
        g.consolidate()
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    got = zarrlite.ZGroup.open_consolidated(tmp_path / "port")
    want = np.concatenate(parts, axis=1)[:, :20]
    np.testing.assert_array_equal(got["annotation"][:, :20], want)
    assert got["annotation"].shape == (2, 24, 20)


def test_codec_frames_cross_decode():
    """Frames compressed by either package decode in both, through the
    native backend and the pure decoder."""
    rng = np.random.RandomState(4)
    raw = rng.lognormal(0, 2, 5000).astype(np.float32).tobytes()
    assert blosc_codec.backend() == jax_codec.backend()
    for cname, shuffle in (("lz4", 1), ("zstd", 2), ("zlib", 1)):
        for codec, other in ((blosc_codec, jax_codec),
                             (jax_codec, blosc_codec)):
            frame = codec.compress(raw, 4, clevel=5, cname=cname,
                                   shuffle=shuffle)
            assert other.decompress(frame) == raw
            if cname != "zstd":       # the pure decoder has no zstd
                assert blosc_codec._pure_decompress(frame) == raw


def _bf16_cases(tmp_path, compressor):
    """A float32 store with NaN, +-Inf, denormals and chunks never
    written (read as the NaN fill)."""
    rng = np.random.RandomState(5)
    data = rng.lognormal(-12, 5, (4, 40, 33)).astype(np.float32)
    data[0, :3] = np.nan
    data[1, 5, :] = np.inf
    data[2, 6, :] = -np.inf
    data[3, 7, :4] = [1e-40, -1e-40, 3.4e38, -0.0]
    g = zarrlite.ZGroup.create(tmp_path / "b.zarr", overwrite=True)
    a = g.create_array("sv", data.shape, (1, 10, 33), np.float32,
                       fill_value=np.nan, compressor=compressor)
    a[:, :30] = data[:, :30]          # chunks of pings 30-39: never written
    data[:, 30:] = np.nan
    return data


@pytest.mark.parametrize("compressor", ["blosc", "zlib"])
def test_converting_bf16_decode(tmp_path, compressor):
    """read_into(cvt) writes bfloat16 bits into a uint16 slab: equal to
    torch's float32 -> bfloat16 on every non-NaN value (+-Inf kept), NaN
    where the store holds NaN or misses a chunk; the same bits as the JAX
    package's ml_dtypes decode on non-NaN values."""
    data = _bf16_cases(tmp_path, compressor)
    sel = (slice(0, 4), slice(2, 38), slice(1, 32))
    want = torch.from_numpy(np.ascontiguousarray(
        data[sel].transpose(2, 1, 0))).to(torch.bfloat16)
    dst = np.full((40, 45, 4), 7, np.uint16)
    zarrlite.ZGroup.open(tmp_path / "b.zarr")["sv"].read_into(
        sel, dst, np.s_[3:34, 4:40, :], axes=(2, 1, 0),
        cvt=blosc_codec.CVT_F32_BF16)
    got = torch.from_numpy(dst[3:34, 4:40]).view(torch.bfloat16)
    nan = torch.isnan(want)
    assert nan.any() and torch.isinf(want).any()
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int16),
                       want[~nan].view(torch.int16))
    assert (dst[:3] == 7).all() and (dst[:, :4] == 7).all()  # untouched
    jdst = np.zeros((40, 45, 4), ml_dtypes.bfloat16)
    jax_zl.ZGroup.open(tmp_path / "b.zarr")["sv"].read_into(
        sel, jdst, np.s_[3:34, 4:40, :], axes=(2, 1, 0))
    jbits = jdst[3:34, 4:40].view(np.uint16)
    keep = ~nan.numpy()
    np.testing.assert_array_equal(dst[3:34, 4:40][keep], jbits[keep])


def test_converting_decode_needs_float32_to_uint16(tmp_path):
    _bf16_cases(tmp_path, "zlib")
    a = zarrlite.ZGroup.open(tmp_path / "b.zarr")["sv"]
    with pytest.raises(ValueError, match="cvt"):
        a.read_into(np.s_[:, :, :], np.zeros((33, 40, 4), np.float32),
                    np.s_[:], axes=(2, 1, 0), cvt=blosc_codec.CVT_F32_BF16)


def test_f32_to_bf16_bits_matches_torch():
    x = np.random.RandomState(6).lognormal(-15, 8, 20000).astype(np.float32)
    x *= np.where(np.arange(x.size) % 3 == 0, -1, 1).astype(np.float32)
    x[:6] = [np.inf, -np.inf, 3.4e38, 1e-45, -0.0, np.nan]
    got = blosc_codec.f32_to_bf16_bits(x)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy(
        ).view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    as_bf16 = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(torch.isnan(as_bf16).numpy(), nan)


# ----------------------------------------------------------------- reader
@pytest.fixture(scope="module", params=["flat", "nested"])
def readers(request, surveys):
    return (DataReaderZarr(surveys["port", request.param]),
            JaxReader(surveys["jax", request.param]))


def test_reader_metadata_and_slices(readers):
    r, j = readers
    assert r.shape == j.shape == (2 * W, H) and r.name == j.name
    assert r.year == j.year
    for attr in ("frequencies", "range_vector", "time_vector", "heave",
                 "raw_file", "categories"):
        np.testing.assert_array_equal(getattr(r, attr), getattr(j, attr))
    assert r.fish_categories == j.fish_categories
    for args in ((0, None), (10, 50, 5, 60), (280, 40, None, 30),
                 (590, None, 100, None)):
        for freqs in (None, [38], [18, 120], [200, 38, 18], 120):
            np.testing.assert_array_equal(
                r.get_data_slice(*args, frequencies=freqs),
                j.get_data_slice(*args, frequencies=freqs))
        for cats in (None, [27], [1, 27, 6]):
            np.testing.assert_array_equal(
                r.get_label_slice(*args, categories=cats),
                j.get_label_slice(*args, categories=cats))


@pytest.mark.parametrize("freqs", [[18, 38, 120, 200], [38, 120], [200, 18]])
def test_read_data_into_matches_jax(readers, freqs):
    r, j = readers
    dst = np.full((90, 110, len(freqs)), -1, np.float32)
    want = dst.copy()
    r.read_data_into(250, 100, 3, 80, freqs, dst, np.s_[5:85, 7:107, :])
    j.read_data_into(250, 100, 3, 80, freqs, want, np.s_[5:85, 7:107, :])
    np.testing.assert_array_equal(dst, want)
    # the converting read: the bfloat16 rounding of the float32 read
    bits = np.zeros(dst.shape, np.uint16)
    r.read_data_into(250, 100, 3, 80, freqs, bits, np.s_[5:85, 7:107, :],
                     cvt=blosc_codec.CVT_F32_BF16)
    np.testing.assert_array_equal(bits[5:85, 7:107],
                                  blosc_codec.f32_to_bf16_bits(
                                      want[5:85, 7:107]))


def test_reader_seabed_matches_jax(readers):
    r, j = readers
    np.testing.assert_array_equal(r.get_seabed(0, None),
                                  j.get_seabed(0, None))
    np.testing.assert_array_equal(r.seabed_known(), j.seabed_known())
    np.testing.assert_array_equal(r.get_seabed(17, 40), j.get_seabed(17, 40))
    for pad in (0, 10):
        np.testing.assert_array_equal(
            r.get_seabed_mask(30, 60, 0, H, seabed_pad=pad),
            j.get_seabed_mask(30, 60, 0, H, seabed_pad=pad))


def _assert_table_equal(got, want, msg=""):
    """A {column: array} table against a DataFrame: the same columns in
    the same order, integer and bool columns equal, float columns within
    pandas' parser error (its default float parser may miss the correctly
    rounded double by one ulp; the csv-module parse rounds correctly).
    pandas types the columns of an empty table as objects; the port keeps
    their numeric dtypes."""
    assert list(got) == list(want.columns), msg
    for c in want.columns:
        w = want[c].to_numpy()
        assert len(got[c]) == len(w), (msg, c)
        if not len(w):
            continue
        assert got[c].dtype.kind == w.dtype.kind, (msg, c)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=4e-16, atol=0,
                                       err_msg=f"{msg} {c}")
        else:
            np.testing.assert_array_equal(got[c], w, err_msg=f"{msg} {c}")


def test_reader_objects_match_jax(readers):
    """The pandas-free objects parse: the same table, bounding boxes,
    object dicts and cached ``_objects_parsed.csv``."""
    r, j = readers
    want = j.get_objects_file()
    _assert_table_equal(r.get_objects_file(), want)
    np.testing.assert_array_equal(r.get_object_bounding_boxes(),
                                  j.get_object_bounding_boxes())
    assert r.objects == j.objects and len(r.objects) > 0
    for cat in (27, [1], [6, 27]):
        np.testing.assert_array_equal(
            r.get_fish_schools(cat)["startpingindex"],
            j.get_fish_schools(cat)["startpingindex"].to_numpy())
    # a fresh reader reads the cache back; pandas reads the port's cache
    parsed = os.path.join(r.path, r.name + "_objects_parsed.csv")
    _assert_table_equal(DataReaderZarr(r.sv_path).get_objects_file(), want)
    pd.testing.assert_frame_equal(pd.read_csv(parsed, index_col=0),
                                  pd.read_csv(os.path.join(
                                      j.path, j.name + "_objects_parsed.csv"),
                                      index_col=0))


def test_objects_csv_edge_cases_match_jax(tmp_path, surveys):
    """LSSS column spellings, a given distance_to_seabed, inverted and
    category -1 rows, and a survey with no objects at all."""
    rows = ("object,category,upperdeptindex,lowerdeptindex,startpingindex,"
            "endpingindex,upperdept,lowerdept,distance_to_seabed\n"
            "0,27,10,20,30,40,1.5,3.0,\n1,1,5,9,50,45,0.5,1.0,\n"
            "2,-1,5,9,60,70,0.5,1.0,\n3,27,40,60,100,130,4.0,6.0,\n")
    cases = {"lsss": rows, "given": rows.replace(",\n", ",7.5\n"),
             "empty": rows.split("\n")[0] + "\n"}
    for name, text in cases.items():
        got = {}
        for who, cls in (("port", DataReaderZarr), ("jax", JaxReader)):
            d = tmp_path / name / who
            shutil.copytree(os.path.dirname(surveys[who, "flat"]), d)
            sv = d / os.path.basename(surveys[who, "flat"])
            for f in d.glob("*_objects_parsed.csv"):
                f.unlink()
            (d / (sv.name.replace("_sv.zarr", "_labels.parquet.csv"))
             ).write_text(text)
            got[who] = cls(sv)
        _assert_table_equal(got["port"].get_objects_file(),
                            got["jax"].get_objects_file(), name)
        np.testing.assert_array_equal(
            got["port"].get_object_bounding_boxes(),
            got["jax"].get_object_bounding_boxes())


def test_get_zarr_readers_filters_match_jax(tmp_path):
    """Years, frequencies, the sandeel+other category rule (waived for a
    survey without annotation store) and minimum_shape."""
    for year, seed in ((2016, 1), (2017, 2)):
        for who in ("jax", "port"):
            jax_make_zarr(tmp_path / who, year=year, n_echograms=1, H=60,
                          W=140, seed=seed, layout="nested")
    for who in ("jax", "port"):   # 2016 ships only its _sv.zarr
        for store in (tmp_path / who / "2016").rglob("*_labels.zarr"):
            shutil.rmtree(store)

    def names(fn, root, **kw):
        try:
            return sorted(r.name for r in fn(path_to_zarr_files=str(root),
                                              **kw))
        except (ValueError, FileNotFoundError) as exc:
            return type(exc).__name__
    for kw in ({}, {"years": [2017]}, {"years": [2016, 2017]},
               {"years": [2015]}, {"require_categories": False},
               {"frequencies": [18, 70]}, {"minimum_shape": 59},
               {"minimum_shape": 60}, {"frequencies": [38]}):
        kw.setdefault("minimum_shape", 32)
        assert names(get_zarr_readers, tmp_path / "port", **kw) == \
            names(jax_get_zarr_readers, tmp_path / "jax", **kw), kw
    with pytest.raises(TypeError, match="years"):
        get_zarr_readers(2017, path_to_zarr_files=str(tmp_path / "port"))


def test_zero_object_survey_writes_header(tmp_path):
    """echograms_to_zarr_survey writes the objects CSV header for a survey
    without schools, as the JAX package's pandas writer does."""
    import pickle

    from crimac_unet_tpu.data.fixtures import make_survey_dir
    from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
    from crimac_unet_tpu.data.preprocess import \
        echograms_to_zarr_survey as jax_to_zarr
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    from crimac_unet_tpu_torch.data.preprocess import \
        echograms_to_zarr_survey
    d = make_survey_dir(tmp_path / "memm", n_echograms=1, H=40, W=60,
                        seed=1)[0]
    with open(os.path.join(d, "objects.pkl"), "wb") as f:
        pickle.dump([], f, protocol=2)
    jax_to_zarr([JaxEchogram(d)], tmp_path / "jax", "S2017843")
    echograms_to_zarr_survey([Echogram(d)], tmp_path / "port", "S2017843")
    name = "S2017843_labels.parquet.csv"
    text = (tmp_path / "port" / name).read_text()
    assert text == (tmp_path / "jax" / name).read_text()
    assert text.startswith("object,category,") and text.count("\n") == 1
    assert DataReaderZarr(tmp_path / "port" / "S2017843_sv.zarr"
                          ).get_object_bounding_boxes().shape == (0, 4)


def test_store_metadata_is_plain_json(surveys):
    """The port's stores carry the xarray dimension names and consolidated
    metadata a stock zarr reader opens."""
    sv = surveys["port", "flat"]
    with open(os.path.join(sv, ".zmetadata")) as f:
        meta = json.load(f)["metadata"]
    assert meta["sv/.zattrs"]["_ARRAY_DIMENSIONS"] == [
        "frequency", "ping_time", "range"]
    assert meta["sv/.zarray"]["compressor"]["id"] in ("blosc", "zlib")
