"""Cruise-series catalog, pairing and staging: the port against the JAX
package on one synthetic IMR-style cruise-data tree.

Stated tolerance: bit-equal — the same rows, pairs and created paths;
the written CSV byte-equal; the ``.mat`` outputs (whose savemat header
carries a date) equal after ``loadmat``.  Each case also holds the port
to the behaviour test of the same name in tests/test_cruise_catalog.py.
"""

import json
import os

import numpy as np
import pytest

from crimac_unet_tpu.data import cruise_catalog as jcc
from crimac_unet_tpu_torch.data import cruise_catalog as cc
from test_torch_ek60 import assert_same, assert_same_mat


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One series, two years; one cruise with files at standard and
    non-standard locations, one cruise dir missing entirely."""
    root = tmp_path_factory.mktemp("cruise_data")
    c1 = root / "S2011_PGOS" / "2011"
    raw, snap, work = (c1 / cc.STD_RAW_DIR, c1 / cc.STD_SNAP_DIR,
                       c1 / cc.STD_WORK_DIR)
    for d in (raw, snap, work):
        d.mkdir(parents=True)
    for stem in ("a", "b", "c"):
        (raw / f"{stem}.raw").write_bytes(b"RAW" + stem.encode())
    (raw / "a.bot").write_bytes(b"BOTa")
    for stem in ("a", "b", "d"):
        (snap / f"{stem}.snap").write_bytes(b"SNAP" + stem.encode())
    (work / "a.work").write_bytes(b"WORKa")
    (c1 / "EXTRA").mkdir()
    (c1 / "EXTRA" / "z.raw").write_bytes(b"RAWz")
    series = {
        "name": "sandeel",
        "sampletime": [
            {"sampletime": "2011",
             "Cruise": [{"cruisenr": "2011843", "shipName": "G.O. Sars",
                         "datapath": "S2011_PGOS/2011"}]},
            {"sampletime": "2012",
             "Cruise": [{"cruisenr": "2012830", "shipName": "Johan Hjort",
                         "datapath": "S2012_MISSING/2012"}]},
        ],
    }
    sj = root / "series.json"
    sj.write_text(json.dumps([series]))
    return root, series, sj


def test_constants_match_jax():
    for name in ("STD_RAW_DIR", "STD_SNAP_DIR", "STD_WORK_DIR", "_HEADER",
                 "_EXT_STD"):
        assert getattr(cc, name) == getattr(jcc, name), name


@pytest.mark.parametrize("doc,ok", [
    ("series", True), ({"name": "not-a-list"}, False),
    ([{"name": "no sampletime"}], False)])
def test_load_cruise_series(tree, tmp_path, doc, ok):
    root, series, sj = tree
    if doc == "series":
        path = sj
    else:
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(doc))
    if ok:
        assert cc.load_cruise_series(path) == jcc.load_cruise_series(path) \
            == [series]
        return
    for mod in (jcc, cc):
        with pytest.raises(ValueError):
            mod.load_cruise_series(path)


@pytest.mark.parametrize("where", ["cruise", "backup_subdir"])
def test_scan_counts_std_vs_nonstd(tree, tmp_path, where):
    if where == "cruise":
        d = tree[0] / "S2011_PGOS" / "2011"
        want_count = [3, 3, 1, 1, 0, 0]
    else:
        # only the exact convention directory is standard; a backup/
        # copy below it counts as NotStdLocation
        d = tmp_path / "C"
        (d / cc.STD_RAW_DIR / "backup").mkdir(parents=True)
        (d / cc.STD_RAW_DIR / "a.raw").write_bytes(b"r")
        (d / cc.STD_RAW_DIR / "backup" / "old.raw").write_bytes(b"r")
        want_count = [1, 0, 0, 1, 0, 0]
    got = cc.scan_cruise_files(d)
    assert_same(got, jcc.scan_cruise_files(d))
    assert got[0] == want_count


def test_pairing_by_stem(tree):
    root, *_ = tree
    _, files = cc.scan_cruise_files(root / "S2011_PGOS" / "2011")
    pairs = cc.pair_files(files)
    assert pairs == jcc.pair_files(files)
    by_stem = {os.path.splitext(os.path.basename(p[2] or p[0]))[0]: p
               for p in pairs}
    assert set(by_stem) == {"a", "b", "c", "d", "z"}
    assert by_stem["c"][0] == "" and by_stem["d"][2] == ""
    assert by_stem["z"] == ("", "", str(root / "S2011_PGOS/2011/EXTRA/z.raw"))


def test_overview_rows_and_missing_dir_nan(tree):
    root, series, _ = tree
    got = cc.build_data_overview(series, root)
    assert_same(got, jcc.build_data_overview(series, root))
    rows, paired = got
    assert rows[1][6:] == [3, 3, 1, 1, 0, 0]
    assert all(v != v for v in rows[2][6:]) and paired[1] == []


def test_save_overview_mat_csv_roundtrip(tree, tmp_path):
    from scipy.io import loadmat
    root, series, _ = tree
    out = cc.save_overview(series, root, tmp_path / "port")
    want = jcc.save_overview(series, root, tmp_path / "jax")
    assert sorted(out) == sorted(want)
    assert open(out["csv"], "rb").read() == open(want["csv"], "rb").read()
    assert_same_mat(out["overview_mat"], want["overview_mat"])
    a = loadmat(out["paired_mat"])["pairedfiles"]
    b = loadmat(want["paired_mat"])["pairedfiles"]
    assert a.shape == b.shape
    for i in range(a.shape[1]):
        assert_same(a[0, i]["F"][0, 0], b[0, i]["F"][0, 0], f"F{i}")
    assert a[0, 0]["F"][0, 0].shape == (5, 3)
    assert loadmat(out["overview_mat"])["DataStatus"].shape == (3, 12)


@pytest.mark.parametrize("precomputed", [False, True])
def test_stage_paired_files(tree, tmp_path, precomputed):
    root, series, _ = tree
    created = {}
    for who, mod in (("jax", jcc), ("port", cc)):
        kw = ({"overview": mod.build_data_overview(series, root)}
              if precomputed else {})
        created[who] = mod.stage_paired_files(series, root, tmp_path / who,
                                              **kw)
    rel = {who: [os.path.relpath(p, tmp_path / who) for p in c]
           for who, c in created.items()}
    assert rel["port"] == rel["jax"]
    names = sorted(os.path.basename(c) for c in created["port"])
    assert names == ["a.bot", "a.raw", "a.snap", "b.raw", "b.snap"]
    for p, q in zip(created["port"], created["jax"]):
        assert open(p, "rb").read() == open(q, "rb").read()
    # a second run copies nothing new without overwrite
    assert cc.stage_paired_files(series, root, tmp_path / "port") == []


def test_staged_tree_onboards(tree, tmp_path, rng):
    """The staged flat layout feeds the raw converter: real fixture streams
    staged by the port's catalog convert as the JAX package's do."""
    from crimac_unet_tpu.data import ek60 as jax_ek60
    from crimac_unet_tpu_torch.data import ek60
    root = tmp_path / "disk"
    c = root / "S2013" / "2013"
    (c / cc.STD_RAW_DIR).mkdir(parents=True)
    (c / cc.STD_SNAP_DIR).mkdir(parents=True)
    times = 1.5e9 + np.arange(12) * 1.0
    sv = rng.lognormal(np.log(1e-6), 1.0, (30, 12, 2))
    ek60.write_raw_fixture(c / cc.STD_RAW_DIR / "r1.raw", sv, [38, 200],
                           times)
    ek60.write_snap_fixture(c / cc.STD_SNAP_DIR / "r1.snap", [{
        "x": [2, 8, 8, 2], "y": [5.5, 5.5, 6.5, 6.5],
        "species": [(27, 1.0)]}])
    series = {"name": "s", "sampletime": [{"sampletime": "2013", "Cruise": [
        {"cruisenr": "2013001", "shipName": "x", "datapath": "S2013/2013"}]}]}
    cc.stage_paired_files(series, root, tmp_path / "staged")
    flat = tmp_path / "staged" / "data" / "s" / "2013"
    res = ek60.convert_survey_raw(str(flat), str(tmp_path / "port"),
                                  range_frequency=200)
    assert res == jax_ek60.convert_survey_raw(
        str(flat), str(tmp_path / "jax"), range_frequency=200) \
        == {"r1": "ok"}
    assert_same_mat(tmp_path / "port" / "r1.mat", tmp_path / "jax" / "r1.mat")
