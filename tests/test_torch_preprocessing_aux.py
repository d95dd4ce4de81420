"""Regrid, interp, rechunk, Korona, seabed caching, the Gridded sampler,
the LSSS parquet rasterizer and the plotting module: the port against
the JAX package.

The same seeded inputs go through ``crimac_unet_tpu`` and the port's
copies.  Stated tolerance: bit-equal (``np.array_equal``,
``equal_nan=True``) for every array, since both run the same numpy in
float64; stores and caches byte-equal; figures equal pixel for pixel
after an Agg draw.  Each case also holds the port to the behaviour test
of the same name in tests/test_preprocessing_aux.py.
"""

import json
import os

import numpy as np
import pytest

from crimac_unet_tpu.data import fixtures as jax_fixtures
from crimac_unet_tpu.data import regrid as jrg
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu_torch.data import fixtures
from crimac_unet_tpu_torch.data import regrid as rg
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from test_torch_ek60 import assert_same, assert_same_tree


@pytest.fixture(scope="module")
def echs(tmp_path_factory):
    """The same echogram written by each package's fixtures into its own
    directory: (jax reader, port reader)."""
    root = tmp_path_factory.mktemp("aux")
    jax_fixtures.make_survey_dir(root / "jax", year=2014, n_echograms=1,
                                 H=80, W=160, seed=13)
    fixtures.make_survey_dir(root / "port", year=2014, n_echograms=1, H=80,
                             W=160, seed=13)
    j = JaxEchogram(next((root / "jax").iterdir()))
    p = Echogram(next((root / "port").iterdir()))
    assert_same_tree(p.path, j.path)
    return j, p


# ----------------------------------------------------------------- regrid
@pytest.mark.parametrize("case", ["identity", "coarsen", "nan", "refine",
                                  "shifted"])
def test_area_weighted_regrid_matches_jax(case):
    rng = np.random.RandomState(0)
    data = rng.rand(40, 30)
    src = np.arange(40, dtype=float)
    dst = {"identity": src, "coarsen": src[::2] + 0.5, "nan": src[::2] + 0.5,
           "refine": np.arange(0, 39, 0.37),
           "shifted": np.cumsum(0.3 + rng.rand(25)) - 2.0}[case]
    if case == "nan":
        data[0, 0] = np.nan
    for axis in (0, 1):
        d = data if axis == 0 else data.T
        got = rg.area_weighted_regrid_1d(d, src, dst, axis=axis)
        assert_same(got, jrg.area_weighted_regrid_1d(d, src, dst,
                                                     axis=axis))
    got = rg.area_weighted_regrid_1d(data, src, dst, axis=0)
    if case == "identity":
        np.testing.assert_allclose(got, data, atol=1e-12)
    elif case == "coarsen":
        np.testing.assert_allclose(got, (data[::2] + data[1::2]) / 2,
                                   atol=1e-9)
    elif case == "nan":
        np.testing.assert_allclose(got[0, 0], data[1, 0], atol=1e-9)
    tsrc = np.arange(30, dtype=float)
    for method in ("area", "nearest"):
        out = rg.regrid_data(data, src, tsrc, dst, tsrc[::3] + 1.0, method)
        assert_same(out, jrg.regrid_data(data, src, tsrc, dst,
                                         tsrc[::3] + 1.0, method))
    out = rg.regrid_data(data, src, tsrc, src[::2] + 0.5, tsrc[::3] + 1.0)
    assert bool(rg.sanity_check(data, out, rel_tol=0.2)) \
        == bool(jrg.sanity_check(data, out, rel_tol=0.2)) is True


def test_sparse_overlap_weights_match_dense():
    rng = np.random.RandomState(3)
    for _ in range(5):
        src = np.cumsum(0.1 + rng.rand(rng.randint(5, 60)))
        dst = np.cumsum(0.05 + rng.rand(rng.randint(4, 80)) * 1.7)
        dense = rg._overlap_matrix(src, dst)
        sparse = rg._overlap_weights(src, dst).toarray()
        assert_same(dense, jrg._overlap_matrix(src, dst))
        assert_same(sparse, jrg._overlap_weights(src, dst).toarray())
        np.testing.assert_allclose(sparse, dense, atol=1e-12)


def test_nearest_regrid_sparse_matches_dense_argmin():
    rng = np.random.RandomState(3)
    for trial in range(60):
        src = np.unique(rng.choice(np.arange(200), rng.randint(2, 50)))
        dst = rng.uniform(-10, 210, rng.randint(1, 50))
        dst[0] = (src[0] + src[1]) / 2    # an exact midpoint tie
        data = np.arange(src.size, dtype=float)[:, None] * [1.0, 1.0]
        got = rg.nearest_regrid_1d(data, src, dst, axis=0)
        assert_same(got, jrg.nearest_regrid_1d(data, src, dst, axis=0))
        want = np.abs(dst[:, None] - src[None, :]).argmin(axis=1)
        np.testing.assert_array_equal(got[:, 0].astype(int), want,
                                      err_msg=str(trial))


@pytest.mark.parametrize("t", [
    [0.0, 1.0, 2.0, 10.0, 3.0, 4.0, 11.0, 12.0],     # multi-ping jump
    [0.0, 1.0, 0.5, 2.0],                            # a single dip
    [0.0, 1.0, 2.0, 1.5, 3.0, 4.0],
    [3.0, 2.0, 1.0, 0.0],
])
def test_monotonic_keep_matches_jax(t):
    t = np.asarray(t)
    keep = rg._monotonic_keep(t)
    assert_same(keep, jrg._monotonic_keep(t))
    assert np.all(np.diff(t[keep]) >= 0)
    if len(t) == 4 and t[2] == 0.5:
        np.testing.assert_array_equal(keep, [0, 1, 3])


def test_edges_degenerate_raises():
    for mod in (jrg, rg):
        with pytest.raises(ValueError, match=">= 2 cell centers"):
            mod._edges(np.array([5.0]))


@pytest.mark.parametrize("case", ["same_grid", "backward_step", "ping_rate",
                                  "range_diff"])
def test_regrid_prediction_matches_jax(echs, case):
    j, p = echs
    if case == "backward_step":
        class Fake:
            time_vector = np.array([0.0, 1.0, 2.0, 1.5, 3.0, 4.0])
            range_vector = np.arange(5, dtype=float)
        j = p = Fake()
        pred = np.arange(30, dtype=float).reshape(5, 6)
    else:
        pred = np.random.RandomState(1).rand(*p.shape)
    kw = {"ping_rate": dict(pred_ping_rate=0.5),
          "range_diff": dict(pred_range_diff=0.5)}.get(case, {})
    got = None if kw else rg.regrid_prediction(pred, p)
    if case == "same_grid":
        assert_same(got, jrg.regrid_prediction(pred, j))
        np.testing.assert_array_equal(got, pred)
    elif case == "backward_step":
        assert_same(got, jrg.regrid_prediction(pred, j))
        np.testing.assert_array_equal(got, pred[:, [0, 1, 2, 4, 5]])
    else:
        tv = np.asarray(p.time_vector, np.float64)
        rv = np.asarray(p.range_vector, np.float64)
        n_t = np.arange(tv[0], tv[-1],
                        rg.ping_rate_to_time_difference(0.5)).size \
            if case == "ping_rate" else tv.size
        n_r = np.arange(rv[0], rv[-1], 0.5).size \
            if case == "range_diff" else rv.size
        coarse = np.random.RandomState(2).rand(n_r, n_t)
        got = rg.regrid_prediction(coarse, p, **kw)
        assert_same(got, jrg.regrid_prediction(coarse, j, **kw))
        assert got.shape == p.shape


@pytest.mark.parametrize("ping_rate,range_diff", [
    (1.0, None), (0.25, 0.5), (1e-9, None)])
def test_fix_pings_and_regrid_matches_jax(echs, ping_rate, range_diff):
    j, p = echs
    got = rg.fix_pings_and_regrid(p, ping_rate=ping_rate,
                                  range_diff=range_diff)
    assert_same(got, jrg.fix_pings_and_regrid(j, ping_rate=ping_rate,
                                              range_diff=range_diff))
    data, labels, new_range, new_time = got
    assert data.shape == (len(new_range), len(new_time), 4)
    assert labels.shape == data.shape[:2]
    assert len(new_time) >= 2       # degenerate targets keep the axis


# ----------------------------------------------------------------- interp
def test_interp_matches_jax():
    from crimac_unet_tpu.utils import interp as ji
    from crimac_unet_tpu_torch.utils import interp as pi
    for siz in ([4, 6], [3, 5, 2]):
        assert_same(pi.get_grid(siz), ji.get_grid(siz))
    g = pi.get_grid([4, 6])
    assert g.shape == (2, 4, 6) and g[0].min() == -1 and g[0].max() == 2
    rng = np.random.RandomState(5)
    arr2 = rng.rand(4, 5)
    arr3 = rng.rand(3, 4, 5)
    inds2 = rng.uniform(-2, 6, (2, 40))
    inds3 = rng.uniform(-1, 5, (3, 7, 6))
    for fn in ("nearest_interpolation", "linear_interpolation"):
        for arr, inds in ((arr2, inds2), (arr3, inds3)):
            assert_same(getattr(pi, fn)(arr, inds, boundary_val=-7),
                        getattr(ji, fn)(arr, inds, boundary_val=-7))
        grid = np.stack(np.meshgrid(np.arange(4), np.arange(5),
                                    indexing="ij"))
        assert_same(getattr(pi, fn)(arr2, grid, out_shape=(4, 5)),
                    getattr(ji, fn)(arr2, grid, out_shape=(4, 5)))
        np.testing.assert_allclose(
            getattr(pi, fn)(arr2, grid, out_shape=(4, 5)), arr2)
    assert_same(pi.coordinate_map(arr3), ji.coordinate_map(arr3))
    assert_same(pi.rotation_matrix_2d(0.3), ji.rotation_matrix_2d(0.3))
    assert_same(pi.rotation_matrix_3d([1.0, 2.0, 0.5], 0.7),
                ji.rotation_matrix_3d([1.0, 2.0, 0.5], 0.7))
    val = pi.nearest_interpolation(arr2, np.array([[-3.0], [0.0]]),
                                   boundary_val=-7)
    assert val[0] == -7


def test_combine_functions_matches_jax():
    from crimac_unet_tpu.utils.combine_functions import \
        CombineFunctions as J
    from crimac_unet_tpu_torch.utils.combine_functions import \
        CombineFunctions as P
    fns = [lambda a, b: (a + b, b), lambda a, b: (a * 2, b - 1)]
    assert P(fns)(3, 4) == J(fns)(3, 4) == (14, 3)


# ---------------------------------------------------------------- rechunk
@pytest.mark.parametrize("spec", [
    {"frequency": 1, "ping_time": 37, "range": 80},
    {"frequency": 2, "ping_time": 64, "range": 16},
    None])
def test_rechunk_store_matches_jax(tmp_path, echs, spec):
    from crimac_unet_tpu.data.preprocess import \
        echograms_to_zarr_survey as jax_to_zarr
    from crimac_unet_tpu.data.rechunk import rechunk_store as jax_rechunk
    from crimac_unet_tpu_torch.data.preprocess import \
        echograms_to_zarr_survey
    from crimac_unet_tpu_torch.data.rechunk import rechunk_store
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    j, p = echs
    jax_to_zarr([j], tmp_path / "jax", "S2014843", compressor="zlib")
    echograms_to_zarr_survey([p], tmp_path / "port", "S2014843",
                             compressor="zlib")
    for who, fn in (("jax", jax_rechunk), ("port", rechunk_store)):
        fn(tmp_path / who / "S2014843_sv.zarr",
           tmp_path / who / "S2014843_sv_rechunked.zarr", spec)
    assert_same_tree(tmp_path / "port" / "S2014843_sv_rechunked.zarr",
                     tmp_path / "jax" / "S2014843_sv_rechunked.zarr")
    src = tmp_path / "port" / "S2014843_sv.zarr"
    dst = tmp_path / "port" / "S2014843_sv_rechunked.zarr"
    a, b = ZGroup.open(src), ZGroup.open(dst)
    if spec is not None:
        assert b["sv"].chunks == (min(spec["frequency"], 4),
                                  min(spec["ping_time"], 160),
                                  min(spec["range"], 80))
    np.testing.assert_array_equal(a["sv"][:], b["sv"][:])
    np.testing.assert_array_equal(a["ping_time"][:], b["ping_time"][:])
    doc = json.loads((dst / ".zmetadata").read_text())
    assert doc["zarr_consolidated_format"] == 1


def test_rechunk_store_copies_vlen_arrays(tmp_path):
    from test_zarrlite import _write_vlen_utf8_array

    from crimac_unet_tpu.data.rechunk import rechunk_store as jax_rechunk
    from crimac_unet_tpu_torch.data.rechunk import rechunk_store
    from crimac_unet_tpu_torch.data.zarrlite import (ZGroup,
                                                     default_blosc_compressor)
    src = tmp_path / "src.zarr"
    g = ZGroup.create(src)
    g.create_array("sv", (1, 10, 6), (1, 4, 6), np.float32,
                   fill_value=np.nan,
                   dims=["frequency", "ping_time", "range"])[:, :, :] = \
        np.arange(60, dtype=np.float32).reshape(1, 10, 6)
    names = [f"f{i}.raw" for i in range(10)]
    _write_vlen_utf8_array(str(src / "raw_file"), names, chunks=4,
                           compressor=default_blosc_compressor())
    spec = {"frequency": 1, "ping_time": 5, "range": 6}
    rechunk_store(src, tmp_path / "port.zarr", spec)
    jax_rechunk(src, tmp_path / "jax.zarr", spec)
    assert_same_tree(tmp_path / "port.zarr", tmp_path / "jax.zarr")
    out = ZGroup.open(tmp_path / "port.zarr")
    assert out["sv"].chunks == (1, 5, 6)
    np.testing.assert_array_equal(out["sv"][:], g["sv"][:])
    assert list(out["raw_file"][:]) == names
    assert out["raw_file"].chunks == (4,)


# ----------------------------------------------------------------- korona
@pytest.mark.parametrize("depths_from", ["vector", "h5"])
def test_korona_labels_match_jax(echs, tmp_path, depths_from):
    from crimac_unet_tpu.data import korona as jk
    from crimac_unet_tpu_torch.data import korona as pk
    from crimac_unet_tpu_torch.data.memmap_reader import \
        _matlab_time_to_datetime
    j, p = echs
    korona = []
    for n, (lo, hi) in zip((5, 40, 41, 120), ((10, 30), (2, 12), (50, 79),
                                               (60, 200))):
        t = _matlab_time_to_datetime(float(p.time_vector[n]))
        korona.append({"time": t.isoformat() + "Z", "pingNumber": n,
                       "depthRanges": [
                           {"min": float(p.range_vector[lo]) + 1.0,
                            "max": (float(p.range_vector[min(hi, 79)])
                                    + (1.0 if hi < 80 else 50.0))}]})
    path = tmp_path / "korona.json"
    path.write_text(json.dumps(korona))
    klist = pk.get_korona_list_from_json(path)
    assert klist == jk.get_korona_list_from_json(path)
    depths = np.zeros((p.shape[1], 1))
    if depths_from == "h5":
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp_path / f"{p.name}.h5", "w") as f:
            f.create_group("transducer").create_dataset("1", data=depths)
        got_d = pk.get_transducer_depths(p, root_depths=tmp_path)
        assert_same(got_d, jk.get_transducer_depths(j, root_depths=tmp_path))
        labels = pk.get_korona_labels(p, klist, transducer_depths=got_d)
    else:
        labels = pk.get_korona_labels(p, klist,
                                      transducer_depths=depths[:, 0])
    want = jk.get_korona_labels(j, jk.get_korona_list_from_json(path),
                                transducer_depths=depths)
    assert_same(labels, want)
    assert labels.shape == p.shape and labels.sum() > 0
    assert set(np.unique(np.argwhere(labels > 0)[:, 1])) <= {5, 40, 41, 120}
    bad = tmp_path / "unsorted.json"
    bad.write_text(json.dumps(korona[::-1]))
    for mod in (jk, pk):
        with pytest.raises(ValueError, match="not sorted"):
            mod.get_korona_list_from_json(bad)


def test_compensate_heave_matches_jax(echs):
    from crimac_unet_tpu.data import korona as jk
    from crimac_unet_tpu_torch.data import korona as pk
    j, p = echs
    labels = (np.random.RandomState(4).rand(*p.shape) < 0.1).astype(
        np.int16)
    assert_same(pk.compensate_heave(p, labels),
                jk.compensate_heave(j, labels))


# ----------------------------------------------------------- seabed cache
def test_batch_estimate_seabed_matches_jax(tmp_path):
    from crimac_unet_tpu.data.memmap_reader import get_echograms as jget
    from crimac_unet_tpu.data.preprocess import \
        batch_estimate_seabed as jbatch
    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.data.preprocess import batch_estimate_seabed
    for who in ("jax", "port"):
        fixtures.make_survey_dir(tmp_path / who, year=2015, n_echograms=2,
                                 H=70, W=130, seed=21)
    je = jget(years=[2015], path_to_echograms=str(tmp_path / "jax"),
              minimum_shape=60)
    pe = get_echograms(years=[2015], path_to_echograms=str(tmp_path / "port"),
                       minimum_shape=60)
    assert len(pe) == len(je) == 2
    jbatch(je)
    batch_estimate_seabed(pe)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    for e in pe:
        assert os.path.isfile(os.path.join(e.path, "seabed.npy"))
    # cached: a second pass leaves the files; force recomputes the same
    batch_estimate_seabed(pe, force=True)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


# ------------------------------------------------------- gridded sampler
@pytest.mark.parametrize("mode", ["all", "region", "trace"])
def test_gridded_sampler_matches_jax(echs, mode):
    from crimac_unet_tpu.data.samplers import Gridded as JG
    from crimac_unet_tpu_torch.data.samplers import Gridded
    j, p = echs
    g = Gridded([p], [32, 32], patch_overlap=4, mode=mode)
    want = JG([j], [32, 32], patch_overlap=4, mode=mode)
    assert_same(g.coords_list, want.coords_list)
    assert len(g) > 0
    center, reader = g.get_sample(0)
    assert reader is p and center == want.get_sample(0)[0]


def test_grid_centers_matches_jax():
    from crimac_unet_tpu.ops.patches import grid_centers as jgc
    from crimac_unet_tpu_torch.ops.patches import grid_centers
    for args in ((0, 1000, 256, 20), (5, 77, 32, 4), (0, 3, 64, 8)):
        assert_same(grid_centers(*args), jgc(*args))


# ------------------------------------------------- LSSS parquet labels
def _zarr_pair(tmp_path, draft):
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JZ
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    sv = fixtures.make_zarr_survey(tmp_path, year=2017, n_echograms=1,
                                   H=60, W=120, seed=8)
    if draft:
        g = ZGroup.open(sv)
        n = g["sv"].shape[1]
        g.create_array("transducer_draft", (n,), (n,), np.float64,
                       dims=["ping_time"])[:] = \
            np.random.RandomState(3).uniform(0.2, 0.6, n)
        g.consolidate()
    return DataReaderZarr(sv), JZ(sv)


@pytest.mark.parametrize("heave", [True, False])
@pytest.mark.parametrize("draft", [False, True])
def test_create_label_mask_from_work_matches_jax(tmp_path, heave, draft):
    """The port reads the parquet with pyarrow (no pandas) and must
    rasterize as the JAX package's pandas rows do: ping times near the
    midpoint between two pings (a nanosecond part that a microsecond
    timestamp drops), overlapping rows (the later row wins), IDs with a
    category suffix, depths beyond the range axis."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    reader, jreader = _zarr_pair(tmp_path, draft)
    tv = reader.time_vector.astype("M8[ns]")
    rv = np.asarray(reader.range_vector)
    rng = np.random.RandomState(9)
    rows = []
    for k in range(40):
        p = rng.randint(0, len(tv) - 1)
        t = tv[p] + (tv[p + 1] - tv[p]) // 2 + np.timedelta64(
            int(rng.choice([0, 1, 499, 500, 999])), "ns")
        lo = float(rng.uniform(rv[0] - 1, rv[-1]))
        rows.append((t, lo, lo + float(rng.uniform(0, 4)),
                     f"school{k}-{rng.choice([1, 27, 5027])}"))
    rows.append((tv[10], rv[3], rv[40], "late-1"))
    rows.append((tv[10], rv[20], rv[25], "later-27"))
    table = pa.table({
        "pingTime": pa.array(np.array([r[0] for r in rows], "M8[ns]")),
        "mask_depth_upper": [r[1] for r in rows],
        "mask_depth_lower": [r[2] for r in rows],
        "ID": [r[3] for r in rows]})
    path = tmp_path / "annot_work.parquet"
    pq.write_table(table, path)
    got = reader.create_label_mask_from_work(path, heave=heave)
    want = jreader.create_label_mask_from_work(path, heave=heave)
    assert_same(got, want)
    assert got.shape == reader.shape and got.dtype == np.int16
    assert (got == 27).any() and (got == 1).any()
    # the later of two overlapping rows wins where they overlap
    assert (got[10] == 27).sum() >= 3 and (got[10] == 1).any()


def test_create_label_mask_default_path(tmp_path):
    pytest.importorskip("pyarrow")
    import pyarrow as pa
    import pyarrow.parquet as pq
    reader, jreader = _zarr_pair(tmp_path, False)
    tv = reader.time_vector.astype("M8[ns]")
    rv = np.asarray(reader.range_vector)
    pq.write_table(pa.table({
        "pingTime": pa.array(tv[[3, 50, 90]]),
        "mask_depth_upper": [rv[5], rv[10], rv[0]],
        "mask_depth_lower": [rv[15], rv[30], rv[2]],
        "ID": ["x-27", "y-1", "z-27"]}),
        os.path.join(reader.path, f"{reader.name}_work.parquet"))
    got = reader.create_label_mask_from_work()
    assert_same(got, jreader.create_label_mask_from_work())
    assert (got[3] == 27).any() and (got[50] == 1).any()


# --------------------------------------------------------------- plotting
def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_visualize_echogram_matches_jax(echs, tmp_path):
    pytest.importorskip("matplotlib")
    from crimac_unet_tpu.utils import plotting as jplot
    j, p = echs
    preds = np.random.RandomState(6).rand(2, *p.shape)
    fig = p.visualize(n_pings=100, predictions=preds)
    want = j.visualize(n_pings=100, predictions=preds)
    assert_same(_pixels(fig), _pixels(want))
    out = tmp_path / "ech.png"
    p.visualize(n_pings=100, predictions=np.zeros((2,) + p.shape),
                save_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    jplot._plt().close("all")


def test_zarr_visualize_and_predictions_vs_labels_match_jax(tmp_path, rng):
    pytest.importorskip("matplotlib")
    from crimac_unet_tpu.utils import plotting as jplot
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    from crimac_unet_tpu_torch.utils import plotting
    reader, jreader = _zarr_pair(tmp_path, False)
    assert_same(_pixels(reader.visualize(ping_idx=10, n_pings=80)),
                _pixels(jreader.visualize(ping_idx=10, n_pings=80)))
    g = ZGroup.create(tmp_path / "pred.zarr")
    probs = rng.rand(2, 120, 60).astype(np.float16)
    g.create_array("annotation", probs.shape, (1, 60, 60), np.float16,
                   fill_value=0, compressor="zlib",
                   dims=["category", "ping_time", "range"])[:] = probs
    out = tmp_path / "cmp.png"
    fig = plotting.visualize_predictions_vs_labels(
        reader, tmp_path / "pred.zarr", threshold=0.4)
    want = jplot.visualize_predictions_vs_labels(
        jreader, tmp_path / "pred.zarr", threshold=0.4)
    assert_same(_pixels(fig), _pixels(want))
    plotting.visualize_predictions_vs_labels(reader, tmp_path / "pred.zarr",
                                             save_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    jplot._plt().close("all")


def test_visualize_school_detections_matches_jax(echs):
    pytest.importorskip("matplotlib")
    from crimac_unet_tpu.utils import plotting as jplot
    from crimac_unet_tpu_torch.utils import plotting
    j, p = echs
    dets = [{"bounding_box": [10, 30, 20, 60], "score": 0.8},
            {"bounding_box": [40, 50, 100, 150], "score": 0.3}]
    fig = plotting.visualize_school_detections(p, dets, n_pings=150)
    want = jplot.visualize_school_detections(j, dets, n_pings=150)
    assert_same(_pixels(fig), _pixels(want))
    jplot._plt().close("all")
