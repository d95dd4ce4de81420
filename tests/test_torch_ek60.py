"""EK60 raw onboarding and the .mat -> memmap converter: the port against
the JAX package.

The same synthetic .raw/.bot/.snap streams (written from a numpy seed)
go through ``crimac_unet_tpu.data.ek60`` / ``mat_to_memmap`` and the
port's copies.  Stated tolerance: bit-equal (``np.array_equal`` with
``equal_nan=True``, dtypes equal), since both run the same numpy in
float64; written files byte-equal, except ``.mat`` files, whose
``scipy.io.savemat`` header carries a date, so their ``loadmat``
contents are compared.  Each case also holds the port to the JAX
package's behaviour test of the same name (tests/test_ek60.py,
tests/test_preprocessing_aux.py).
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from crimac_unet_tpu.data import ek60 as jax_ek60
from crimac_unet_tpu.data import mat_to_memmap as jax_m2m
from crimac_unet_tpu_torch.data import ek60
from crimac_unet_tpu_torch.data import mat_to_memmap as m2m

DR = 1500.0 * 1e-4 / 2.0   # the fixtures' sample spacing, 0.075 m


def assert_same(got, want, where="out"):
    """Bit-equal nested results: arrays (dtype, shape, NaN positions),
    dicts, sequences, dataclasses and scalars."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        assert_same(vars(got), vars(want), where)
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        if want.dtype == object:
            assert_same(got.tolist(), want.tolist(), where)
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind
                                  in "fc"), where
    elif isinstance(want, float) and want != want:
        assert got != got, where
    else:
        assert type(got) is type(want) and got == want, where


def assert_same_mat(got_path, want_path):
    import scipy.io as spio
    a, b = spio.loadmat(got_path), spio.loadmat(want_path)
    a = {k: v for k, v in a.items() if not k.startswith("__")}
    b = {k: v for k, v in b.items() if not k.startswith("__")}
    assert_same(a, b, str(got_path))


def assert_same_tree(got_dir, want_dir):
    """Two directories hold the same files: byte-equal, except pickles
    (compared unpickled) and .mat files (compared loaded)."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for n in names:
        g, w = os.path.join(got_dir, n), os.path.join(want_dir, n)
        if os.path.isdir(w):
            assert_same_tree(g, w)
        elif n.endswith(".mat"):
            assert_same_mat(g, w)
        elif n.endswith(".pkl"):
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert_same(pickle.load(fg), pickle.load(fw), g)
        else:
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read(), g


@pytest.fixture
def times():
    return 1.5e9 + np.arange(20) * 1.0


def _make_sv(rng, n_range=50, n_pings=20, n_freq=3):
    return rng.lognormal(np.log(1e-6), 1.0,
                         (n_range, n_pings, n_freq)).astype(np.float64)


def _write_both(tmp_path, writer, name, *args, **kw):
    """One fixture file per package, each by its own writer; the bytes
    must agree."""
    paths = []
    for who, mod in (("jax", jax_ek60), ("port", ek60)):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        paths.append(getattr(mod, writer)(d / name, *args, **kw))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read(), writer
    return paths   # [jax, port]


def test_raw_roundtrip_sv(tmp_path, rng, times):
    sv = _make_sv(rng)
    heave = rng.randn(20) * 0.3
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "a.raw", sv,
                         [38, 120, 200], times, heave=heave)
    raw, want = ek60.read_raw(pp), jax_ek60.read_raw(jp)
    assert_same(raw, want)
    assert [c.frequency for c in raw.channels] == [38e3, 120e3, 200e3]
    assert sorted(raw.pings) == [1, 2, 3] and len(raw.pings[1]) == 20
    np.testing.assert_allclose([p.time for p in raw.pings[2]], times,
                               atol=1e-6)
    np.testing.assert_allclose([p.heave for p in raw.pings[1]], heave,
                               atol=1e-6)
    got, r = ek60.power_to_sv(raw.pings[1][0], raw.channels[0])
    assert_same((got, r), jax_ek60.power_to_sv(want.pings[1][0],
                                               want.channels[0]))
    # Sv inverts the fixture's power synthesis within int16 quantization
    assert np.abs(10 * np.log10(got) - 10 * np.log10(sv[:, 0, 0])).max() \
        < 0.02
    assert r.shape == (50,)


# (fixture kwargs, raw_to_arrays kwargs, with .bot, with .snap): the
# behaviour tests' assembly cases, plus the interpolation path (a main
# grid finer than the channels')
ARRAY_CASES = {
    "contract": (dict(drop_pings={1: [3, 7]}),
                 dict(depthoffset=2 * DR, bottomoutlier=98), 40, True),
    "coarser_dz": ({}, dict(dz=2 * DR, dzdiff=1e-4), None, False),
    "finer_dz": ({}, dict(dz=0.5 * DR, dzdiff=1e-4), None, False),
    "main_missing": (dict(drop_pings={3: [4, 9]}), {}, 45, False),
    "sa_correction": (dict(sa=0.7), {}, None, False),
    "transducer_depth": (dict(transducer_depth=7.5), {}, 45, True),
}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_raw_to_arrays_matches_jax(tmp_path, rng, times, case):
    fix_kw, kw, bot_rows, with_snap = ARRAY_CASES[case]
    sv = _make_sv(rng)
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "a.raw", sv,
                         [38, 120, 200], times, **fix_kw)
    paths = {"jax": [jp], "port": [pp]}
    if bot_rows is not None:
        for who, p in zip(("jax", "port"), _write_both(
                tmp_path, "write_bot_fixture", "a.bot", times,
                np.full((20, 3), bot_rows * DR))):
            paths[who].append(p)
    if with_snap:
        td = fix_kw.get("transducer_depth", 5.0)
        for who, p in zip(("jax", "port"), _write_both(
                tmp_path, "write_snap_fixture", "a.snap", [{
                    "x": [5, 12, 12, 5],
                    "y": np.array([10, 10, 20, 20]) * DR + td,
                    "species": [(27, 0.8), (1, 0.2)]}])):
            paths[who].append(p)

    def run(mod, ps):
        bot = ps[1] if bot_rows is not None else None
        snap = ps[-1] if with_snap else None
        return mod.raw_to_arrays(ps[0], bot_path=bot, snap_path=snap,
                                 range_frequency=200, **kw)

    out = run(ek60, paths["port"])
    assert_same(out, run(jax_ek60, paths["jax"]))
    assert set(out) == {"I", "sv", "F", "t", "range", "depths", "heave"}
    assert out["t"].shape == out["heave"].shape == (20,)
    assert np.isfinite(out["sv"]).any()
    if case == "contract":
        n_keep = out["range"].size
        assert 40 <= n_keep <= 43 and out["sv"].shape == (n_keep, 20, 3)
        assert np.isnan(out["sv"][:, 3, 0]).all()
        assert np.isfinite(out["sv"][:, 3, 1]).all()
        rows, cols = np.where(out["I"] == 27)
        assert set(np.unique(out["I"])) == {0.0, 27.0}
        assert rows.min() >= 9 and rows.max() <= 21
        assert cols.min() >= 4 and cols.max() <= 12
    elif case == "coarser_dz":
        assert out["sv"].shape[0] == pytest.approx(25, abs=1)
    elif case == "finer_dz":
        assert out["sv"].shape[0] == pytest.approx(99, abs=1)
    elif case == "main_missing":
        assert np.isnan(out["sv"][:, 4, 2]).all()
        assert np.isfinite(out["sv"][:, 4, 0]).all()
        assert (np.diff(out["t"]) > 0).all()


def test_power_to_sv_golden_values():
    """The EK60 TVG equation against the hand-derived golden values of
    tests/test_ek60.py, and against the JAX package bit for bit."""
    power = np.zeros(501, np.int16)
    power[0], power[100], power[500] = -2000, -5000, -9000
    kw = dict(channel=1, time=0.0, transducerdepth=0.0, frequency=38000.0,
              transmitpower=2000.0, pulselength=0.001024,
              sampleinterval=0.000256, soundvelocity=1500.0,
              absorption=0.0098, heave=0.0, offset=0, power=power)
    ckw = dict(channel_id="t1", frequency=38000.0, gain=25.0,
               equivalent_beam_angle=-20.7, sa_correction=-0.49)
    sv, r = ek60.power_to_sv(ek60.Raw0Ping(**kw), ek60.ChannelConfig(**ckw))
    assert_same((sv, r), jax_ek60.power_to_sv(jax_ek60.Raw0Ping(**kw),
                                              jax_ek60.ChannelConfig(**ckw)))
    np.testing.assert_allclose(r[[0, 100, 500]], [0.0, 19.2, 96.0],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(10 * np.log10(sv[[0, 100, 500]]),
                               [-47.974048762467966, -42.878444579340766,
                                -74.42970131511744], atol=1e-9)


@pytest.mark.parametrize("blob,match", [
    (b"\x10\x00\x00\x00RAW0junk", "no complete datagrams"),
    (b"\x04\x00\x00\x00RAW0\x04\x00\x00\x00", "corrupt datagram framing"),
    (b"\x0c\x00\x00\x00TAG0" + bytes(8) + b"\x0d\x00\x00\x00",
     "trailer mismatch"),
    (b"", "no complete datagrams"),
])
def test_unreadable_raw_rejected(tmp_path, blob, match):
    (tmp_path / "bad.raw").write_bytes(blob)
    for mod in (jax_ek60, ek60):
        with pytest.raises(ValueError, match=match):
            mod.read_raw(tmp_path / "bad.raw")


def test_truncated_final_datagram_keeps_prefix(tmp_path, rng, times):
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "t.raw",
                         _make_sv(rng), [38, 120, 200], times)
    blob = open(pp, "rb").read()
    (tmp_path / "cut.raw").write_bytes(blob[:-10])
    raw = ek60.read_raw(tmp_path / "cut.raw")
    assert_same(raw, jax_ek60.read_raw(tmp_path / "cut.raw"))
    n_full = sum(len(p) for p in ek60.read_raw(pp).pings.values())
    n_cut = sum(len(p) for p in raw.pings.values())
    assert n_full - 1 <= n_cut < n_full


def test_duplicate_timestamps_do_not_collapse_time_grid(tmp_path, rng,
                                                        times):
    t = np.array(times, dtype=float)
    t[1] = t[0]
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "dup.raw",
                         _make_sv(rng), [38, 120, 200], t)
    out = ek60.raw_to_arrays(pp)
    assert_same(out, jax_ek60.raw_to_arrays(jp))
    assert out["sv"].shape[1] >= len(t) - 1
    assert np.isfinite(out["sv"]).any()


def test_read_bot_and_snap(tmp_path, rng, times):
    depths = rng.uniform(10, 20, (20, 3))
    jb, pb = _write_both(tmp_path, "write_bot_fixture", "a.bot", times,
                         depths)
    assert_same(ek60.read_bot(pb), jax_ek60.read_bot(jb))
    schools = [{"x": [1, 9, 9, 1], "y": [2.0, 2.0, 3.5, 3.5],
                "species": [(27, 0.6), (1, 0.4)]},
               {"x": [3, 6, 4.5], "y": [1.0, 1.0, 2.5],
                "species": [(1, 1.0)]}]
    js, ps = _write_both(tmp_path, "write_snap_fixture", "a.snap", schools)
    assert_same(ek60.read_snap(ps), jax_ek60.read_snap(js))


def test_rasterize_equals_matplotlib_point_test(rng):
    """The port tests polygon points in numpy; the JAX package asks
    matplotlib.  Random polygons, integer and fractional vertices, points
    on edges and corners: the same label images."""
    R = np.arange(0, 30) * 0.5
    t_idx = np.arange(40)
    for trial in range(60):
        nv = rng.randint(3, 9)
        if trial % 2:
            x = rng.randint(0, 42, nv).astype(float)
            y = rng.randint(0, 30, nv) * 0.5
        else:
            x = rng.uniform(-2, 42, nv)
            y = rng.uniform(-1, 16, nv)
        schools = [{"x": x, "y": y + 1.0, "species": [(27, 1.0)]},
                   {"x": [2, 20, 20, 2], "y": [3.0, 3.0, 8.0, 8.0],
                    "species": [(1, 0.7), (27, 0.3)]}]
        got = ek60._rasterize_schools(schools, t_idx, R, 1.0)
        want = jax_ek60._rasterize_schools(schools, t_idx, R, 1.0)
        assert_same(got, want, f"trial {trial}")


def test_transducer_depths_and_h5_bridge(tmp_path, rng, times):
    h5py = pytest.importorskip("h5py")
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "c.raw",
                         _make_sv(rng), [38, 120, 200], times,
                         transducer_depth=7.5)
    d = ek60.extract_transducer_depths(pp)
    assert_same(d, jax_ek60.extract_transducer_depths(jp))
    assert sorted(d) == [1, 2, 3]
    np.testing.assert_allclose(d[2], 7.5)
    got = ek60.save_transducer_depths(pp, tmp_path / "port.h5")
    want = jax_ek60.save_transducer_depths(jp, tmp_path / "jax.h5")
    with h5py.File(got, "r") as f, h5py.File(want, "r") as g:
        assert list(f["transducer"]) == list(g["transducer"])
        key = list(f["transducer"])[0]
        a, b = np.array(f["transducer"][key]), np.array(g["transducer"][key])
    assert_same(a, b)
    assert a.shape == (20, 1)
    np.testing.assert_allclose(a[:, 0], 7.5)


def _survey_tree(root, rng, times, snap_dir="WORK", bad=True):
    raw_dir = root / "ACOUSTIC" / "EK60" / "EK60_RAWDATA"
    sdir = root / "ACOUSTIC" / "LSSS" / snap_dir
    raw_dir.mkdir(parents=True)
    sdir.mkdir(parents=True)
    sv = _make_sv(rng)
    for name in ("2017843-D1-T1", "2017843-D2-T2"):
        jax_ek60.write_raw_fixture(raw_dir / f"{name}.raw", sv,
                                   [38, 120, 200], times)
    jax_ek60.write_bot_fixture(raw_dir / "2017843-D1-T1.bot", times,
                               np.full((20, 3), 45 * DR))
    jax_ek60.write_snap_fixture(sdir / "2017843-D1-T1.snap", [{
        "x": [3, 12, 12, 3], "y": [5.0, 5.0, 8.0, 8.0],
        "species": [(27, 0.9)]}])
    if bad:
        (raw_dir / "2017843-D3-T3.raw").write_bytes(b"garbage!")
    return root


@pytest.mark.parametrize("layout", ["WORK", "INTERPRETATION", "flat"])
def test_convert_survey_raw_matches_jax(tmp_path, rng, times, layout):
    """The survey converter over the ACOUSTIC tree (snaps under LSSS/WORK or
    the standard LSSS/INTERPRETATION) and the flat staged layout: the same
    results, the same .mat contents, the same status file; a broken file
    recorded and retried, done files skipped on resume."""
    if layout == "flat":
        src = tmp_path / "staged"
        src.mkdir()
        jax_ek60.write_raw_fixture(src / "2017843-D9-T9.raw",
                                   _make_sv(rng), [38, 120, 200], times)
        jax_ek60.write_snap_fixture(src / "2017843-D9-T9.snap", [{
            "x": [3, 12, 12, 3], "y": [5.0, 5.0, 8.0, 8.0],
            "species": [(1, 1.0)]}])
    else:
        src = _survey_tree(tmp_path / "S2017843", rng, times, layout)
    res = ek60.convert_survey_raw(str(src), str(tmp_path / "port"),
                                  range_frequency=200)
    want = jax_ek60.convert_survey_raw(str(src), str(tmp_path / "jax"),
                                       range_frequency=200)
    assert res == want
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    import scipy.io as spio
    if layout == "flat":
        assert res == {"2017843-D9-T9": "ok"}
        assert (spio.loadmat(tmp_path / "port" / "2017843-D9-T9.mat")["I"]
                == 1).any()
        return
    assert res["2017843-D1-T1"] == res["2017843-D2-T2"] == "ok"
    assert res["2017843-D3-T3"].startswith("failed")
    mat = spio.loadmat(tmp_path / "port" / "2017843-D1-T1.mat")
    assert (mat["I"] > 0).any(), "the snap was not found"
    res2 = ek60.convert_survey_raw(str(src), str(tmp_path / "port"),
                                   range_frequency=200)
    assert res2["2017843-D1-T1"] == "skipped"
    assert res2["2017843-D3-T3"].startswith("failed")


def test_raw_to_matfile_feeds_memmap_converter(tmp_path, rng, times):
    """.raw -> .mat -> memmap echogram dir through both packages: the same
    .mat contents, the same echogram files, and the port's reader opens
    it."""
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    sv = _make_sv(rng, n_freq=4)
    jp, pp = _write_both(tmp_path, "write_raw_fixture", "b.raw", sv,
                         [18, 38, 120, 200], times)
    js, ps = _write_both(tmp_path, "write_snap_fixture", "b.snap", [{
        "x": [2, 9, 9, 2], "y": np.array([12, 12, 22, 22]) * DR + 5.0,
        "species": [(27, 1.0)]}])
    mat = ek60.raw_to_matfile(pp, tmp_path / "port.mat", snap_path=ps,
                              range_frequency=200)
    jmat = jax_ek60.raw_to_matfile(jp, tmp_path / "jax.mat", snap_path=js,
                                   range_frequency=200)
    assert_same_mat(mat, jmat)
    name = "2017843-D20170427-T062615"
    n = m2m.convert_mat_file(mat, str(tmp_path / "port_e" / name))
    assert n == jax_m2m.convert_mat_file(jmat, str(tmp_path / "jax_e"
                                                   / name))
    assert_same_tree(tmp_path / "port_e", tmp_path / "jax_e")
    e = Echogram(str(tmp_path / "port_e" / name))
    assert e.shape == (50, 20) and len(e.frequencies) == 4
    assert e.n_objects >= 1


def _mat_case(case):
    rng = np.random.RandomState(2)
    if case == "four_freq":
        H, W = 40, 60
        I = np.zeros((H, W))
        I[10:14, 20:30] = 27
        I[20:25, 5:8] = 1
        I[30, 40:50] = 27
        return {"sv": rng.lognormal(np.log(1e-7), 1.0, (H, W, 4)),
                "I": I, "F": np.array([[18., 38., 120., 200.]]),
                "range": np.arange(H, dtype=float) * 0.18,
                "t": 736000.0 + np.arange(W) / 86400.0,
                "depths": np.zeros((W, 1)), "heave": np.zeros((1, W))}
    if case == "single_freq_3d":     # F saved as (1, 1)
        H, W = 20, 30
        return {"F": np.array([[200.0]]), "sv": rng.rand(H, W, 1),
                "I": np.zeros((H, W)),
                "range": np.arange(H, dtype=float)[:, None],
                "t": (736000.0 + np.arange(W) / 86400.0)[None, :],
                "heave": np.zeros((1, W)), "depths": np.full((W, 1), 50.0)}
    # single_freq_2d: MATLAB drops the trailing singleton dim of sv
    H, W = 30, 40
    return {"sv": rng.lognormal(np.log(1e-7), 1.0, (H, W)),
            "I": np.zeros((H, W)), "F": np.array([[38.0]]),
            "range": np.arange(H, dtype=float) * 0.18,
            "t": 736000.0 + np.arange(W) / 86400.0,
            "depths": np.zeros((W, 1)), "heave": np.zeros((1, W))}


@pytest.mark.parametrize("case", ["four_freq", "single_freq_3d",
                                  "single_freq_2d"])
def test_convert_mat_file_matches_jax(tmp_path, case):
    import scipy.io as spio
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    mat = _mat_case(case)
    name = "2014843-D20140427-T000000"
    spio.savemat(tmp_path / f"{name}.mat", mat)
    n = m2m.convert_mat_file(tmp_path / f"{name}.mat",
                             tmp_path / "port" / name)
    assert n == jax_m2m.convert_mat_file(tmp_path / f"{name}.mat",
                                         tmp_path / "jax" / name)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    e = Echogram(tmp_path / "port" / name)
    sv = mat["sv"] if mat["sv"].ndim == 3 else mat["sv"][:, :, None]
    assert e.shape == sv.shape[:2]
    f = int(np.ravel(mat["F"])[-1 if case == "four_freq" else 0])
    np.testing.assert_array_equal(
        np.asarray(e.data_memmaps(f)[0]),
        sv[:, :, -1 if case == "four_freq" else 0].astype(np.float32))
    if case == "four_freq":
        assert n == 3 and e.objects[0]["fish_type_index"] == 1
    else:
        assert n == 0


@pytest.mark.parametrize("layout", ["year_dirs", "flat"])
def test_convert_survey_tree_matches_jax(tmp_path, layout):
    import scipy.io as spio
    out = {}
    for who, mod in (("jax", jax_m2m), ("port", m2m)):
        root = tmp_path / who
        d = root / "2019" if layout == "year_dirs" else root
        d.mkdir(parents=True)
        mat = _mat_case("four_freq")
        spio.savemat(d / "2019843-D1-T1.mat", mat)
        spio.savemat(d / "datastatus.mat", {"x": np.zeros(1)})
        (d / "2019843-D2-T2.mat").write_bytes(b"not a mat file")
        out[who] = mod.convert_survey_tree(str(root))
    assert out["port"] == out["jax"] == ["2019843-D1-T1"]
    assert_same_tree(tmp_path / "port" / "memmap",
                     tmp_path / "jax" / "memmap")
    assert (tmp_path / "port" / "memmap" / "2019843-D1-T1"
            / "labels.dat").is_file()


def test_objects_from_label_image_one_definition(rng):
    """The port defines the school-object function once, in
    mat_to_memmap, as the JAX package does; fixtures and school_eval use
    that one."""
    from crimac_unet_tpu_torch.data import fixtures
    from crimac_unet_tpu_torch.pipeline import school_eval
    assert fixtures.objects_from_label_image is m2m.objects_from_label_image
    src = open(school_eval.__file__).read()
    assert "from ..data.mat_to_memmap import objects_from_label_image" in src
    labels = np.zeros((40, 50), np.int16)
    labels[rng.rand(40, 50) < 0.15] = 27
    labels[5:9, 10:30] = 1
    assert_same(m2m.objects_from_label_image(labels),
                jax_m2m.objects_from_label_image(labels))

