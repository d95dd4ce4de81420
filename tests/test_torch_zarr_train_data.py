"""The port's zarr training data plane against the JAX package's, on the CPU.

Each package writes and reads its own copy of the same nested zarr
surveys (2017 with a STOX transects CSV of two transects, 2016 without),
so neither reads the other's objects cache.  Stated tolerance: everything
here is integer or copy arithmetic and must be equal — the STOX valid
ping ranges and ping indices, the zarr crops (NaN and +-Inf in the data
included), the zarr seabed rows, the five zarr samplers draw for draw
from equal ``RandomState`` seeds (centres, readers and the stream's
position, give-up fallbacks included), the partition and battery, the
datasets' batches, the ``ZarrSamplePool`` canvases and its gather (against
the JAX pool's gather and the host crops), and the metadata-on-zarr
``ValueError``s.
"""

import csv
import logging
import os
import warnings

import numpy as np
import pytest
import torch

from crimac_unet_tpu.data import dataset as jax_dataset
from crimac_unet_tpu.data import device_pool as jax_pool
from crimac_unet_tpu.data import samplers as jax_samplers
from crimac_unet_tpu.data.fixtures import make_zarr_survey as jax_make_zarr
from crimac_unet_tpu.data.partition import make_partition as jax_partition
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
from crimac_unet_tpu_torch.data import dataset, device_pool, samplers
from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.data.meta_channels import crop_meta
from crimac_unet_tpu_torch.data.partition import make_partition
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr

WIN = (32, 32)
FREQS = [18, 38, 120, 200]
TRANSECTS = [(10, 150), (230, 390)]
CFG = {"frequencies": FREQS, "patch_size": list(WIN), "data_mode": "zarr",
       "partition_train": "selected surveys", "train_surveys": [2017],
       "validation_surveys": [2016], "partition_predict": "all surveys",
       "evaluation_surveys": [], "eval_mode": "all"}
STOX_FORMATS = {"T": "%Y-%m-%dT%H:%M:%S", "space": "%Y-%m-%d %H:%M:%S",
                "Z": "%Y-%m-%dT%H:%M:%S.000Z"}


def _write_stox(sv, pings, fmt="T"):
    """A STOX transects CSV for the survey of store ``sv``, transects
    from and to the given ping indices."""
    times = DataReaderZarr(sv).time_vector
    survey_dir = os.path.dirname(os.path.dirname(os.path.dirname(sv)))
    stox = os.path.join(survey_dir, "STOX")
    os.makedirs(stox, exist_ok=True)
    name = os.path.basename(sv).replace("_sv.zarr", "").replace("S", "")

    def cell(i):      # the ping's time to the nearest second
        t = (times[i] + np.timedelta64(500, "ms")).astype("M8[s]")
        return t.item().strftime(STOX_FORMATS[fmt])

    with open(os.path.join(stox, f"{name}_transects.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Transect", "StartDateTime",
                                          "StopDateTime"])
        w.writeheader()
        for k, (a, b) in enumerate(pings):
            w.writerow({"Transect": f"T{k}", "StartDateTime": cell(a),
                        "StopDateTime": cell(b)})


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """{package: (root, 2017 store, 2016 store)}, one tree each."""
    base = tmp_path_factory.mktemp("zarr_train")
    out = {}
    for who, make in (("jax", jax_make_zarr), ("port", make_zarr_survey)):
        root = base / who
        sv17 = make(root, year=2017, n_echograms=2, H=100, W=200, seed=51,
                    n_schools=6, layout="nested")
        sv16 = make(root, year=2016, n_echograms=1, H=90, W=200, seed=52,
                    n_schools=5, layout="nested")
        _write_stox(sv17, TRANSECTS)
        out[who] = (root, sv17, sv16)
    return out


def _readers(surveys):
    """(port readers, JAX readers), 2017 then 2016."""
    return ([DataReaderZarr(p) for p in surveys["port"][1:]],
            [JaxReader(p) for p in surveys["jax"][1:]])


def _poison(monkeypatch, reader):
    """NaN, +Inf and -Inf at fixed survey coordinates in every data read,
    so the crops' and the pool's scrub is exercised."""
    real = reader.get_data_slice

    def get_data_slice(idx_ping, n_pings=None, idx_range=None, n_range=None,
                       frequencies=None, **kw):
        out = np.array(real(idx_ping, n_pings, idx_range, n_range,
                            frequencies), copy=True)
        p = idx_ping + np.arange(out.shape[1])
        q = (idx_range or 0) + np.arange(out.shape[2])
        key = np.add.outer(3 * p, q)
        out[0][key % 97 == 0] = np.nan
        out[1][key % 89 == 0] = np.inf
        out[3][key % 83 == 0] = -np.inf
        return out

    monkeypatch.setattr(reader, "get_data_slice", get_data_slice)


@pytest.mark.parametrize("fmt", sorted(STOX_FORMATS))
def test_valid_pings_equal(surveys, fmt):
    for who in ("jax", "port"):
        _write_stox(surveys[who][1], TRANSECTS, fmt)
    try:
        (r17, r16), (j17, j16) = _readers(surveys)
        with warnings.catch_warnings():
            # numpy warns on the 'Z' suffix, then parses it as UTC
            warnings.filterwarnings("ignore", "no explicit representation")
            got, want = r17.get_valid_pings(), j17.get_valid_pings()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.array(TRANSECTS))
        assert r17.get_valid_pings() is got           # cached
        # no STOX CSV: the whole survey
        np.testing.assert_array_equal(r16.get_valid_pings(),
                                      j16.get_valid_pings())
        np.testing.assert_array_equal(r16.get_valid_pings(),
                                      [[0, r16.shape[0]]])
        t = r17.time_vector
        for when in (t[0], t[57], t[-1], t[199] + np.timedelta64(700, "ms"),
                     t[0] - np.timedelta64(1, "D"), t[-1] + 3600 * 10 ** 9):
            assert r17.get_ping_index(when) == j17.get_ping_index(when)
        for depth in (-5.0, 0.0, 13.3, float(r17.range_vector[-1]) + 9):
            assert r17.get_range_index(depth) == j17.get_range_index(depth)
    finally:
        for who in ("jax", "port"):
            _write_stox(surveys[who][1], TRANSECTS)


def _edge_centers(shape, rng, n=8):
    n_pings, n_range = shape
    fixed = [(0, 0), (-20, 5), (n_range - 1, n_pings - 1),
             (n_range + 10, n_pings + 12), (n_range // 2, -15),
             (40, n_pings // 2)]
    return fixed + [(int(rng.randint(-40, n_range + 40)),
                     int(rng.randint(-40, n_pings + 40)))
                    for _ in range(n)]


def test_zarr_crops_and_seabed_rows_equal(surveys, monkeypatch):
    (r17, r16), (j17, j16) = _readers(surveys)
    rng = np.random.RandomState(3)
    for r, jr in ((r17, j17), (r16, j16)):
        _poison(monkeypatch, r)
        _poison(monkeypatch, jr)
        for c in _edge_centers(r.shape, rng):
            for win in (WIN, (17, 40)):
                d, jd = r.crop_data(c, win, FREQS), jr.crop_data(c, win,
                                                                 FREQS)
                assert d.dtype == np.float32
                np.testing.assert_array_equal(d, jd)
                lab, jlab = r.crop_labels(c, win), jr.crop_labels(c, win)
                assert lab.dtype == jlab.dtype == np.int16
                np.testing.assert_array_equal(lab, jlab)
                np.testing.assert_array_equal(
                    dataset.seabed_patch_row(r, c, win),
                    jax_dataset.seabed_patch_row(jr, c, win))
    # the poison reached the crops: +-Inf stays the float32 extremes
    d = r17.crop_data((50, 100), (100, 200), FREQS)
    assert (d == np.finfo(np.float32).max).any() and \
        (d == -np.finfo(np.float32).max).any() and not np.isnan(d).any()


def _build(mod, kind, readers):
    if kind.startswith("SchoolSeabedZarr"):
        ft, dist = kind[16:].split("_")
        return mod.SchoolSeabedZarr(readers, WIN, max_dist_to_seabed=int(dist),
                                    fish_type=int(ft))
    if kind.startswith("SchoolZarr"):
        ft = kind[10:]
        return mod.SchoolZarr(readers, WIN, "all" if ft == "all" else int(ft))
    return getattr(mod, kind)(readers, WIN)


SAMPLER_KINDS = ["BackgroundZarr", "SeabedZarr", "SchoolZarr27",
                 "SchoolZarr1", "SchoolZarrall", "SchoolSeabedZarr27_16",
                 "SchoolSeabedZarr1_16", "SchoolSeabedZarr27_60",
                 "SchoolSeabedZarr1_-5", "BackgroundSeabedZarr"]


@pytest.mark.parametrize("kind", SAMPLER_KINDS)
def test_zarr_sampler_draws_equal(surveys, kind):
    port, jax_r = _readers(surveys)
    try:
        js = _build(jax_samplers, kind, jax_r)
    except ValueError as e:          # no school within the distance
        with pytest.raises(ValueError, match="no schools within"):
            _build(samplers, kind, port)
        assert "no schools within" in str(e)
        return
    s = _build(samplers, kind, port)
    if hasattr(js, "schools"):
        assert [(z.name, b.tolist()) for z, b in s.schools] == \
            [(z.name, b.tolist()) for z, b in js.schools]
    rng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(60):
        (c, r), (jc, jr) = s.get_sample(rng), js.get_sample(jrng)
        assert list(map(int, c)) == list(map(int, jc))
        assert r.name == jr.name
    assert rng.randint(1 << 30) == jrng.randint(1 << 30)
    assert getattr(s, "give_ups", 0) == getattr(js, "give_ups", 0)


@pytest.mark.parametrize("kind,what", [
    ("BackgroundZarr", "labels"), ("BackgroundSeabedZarr", "labels"),
    ("SeabedZarr", "seabed")])
def test_zarr_sampler_give_ups_equal(surveys, kind, what, caplog):
    """Every candidate rejected: both packages return the same last
    draw, count the give-up and log it."""
    port, jax_r = _readers(surveys)
    for r in port + jax_r:
        if what == "labels":
            r.get_label_slice = lambda *a, **k: np.ones((4, 4), np.float32)
        else:
            r.get_seabed(0, 1)
            r._seabed_vec = np.zeros_like(r._seabed_vec)
    s, js = _build(samplers, kind, port), _build(jax_samplers, kind, jax_r)
    rng, jrng = np.random.RandomState(8), np.random.RandomState(8)
    with caplog.at_level(logging.WARNING):
        (c, r), (jc, jr) = s.get_sample(rng), js.get_sample(jrng)
    assert list(map(int, c)) == list(map(int, jc)) and r.name == jr.name
    assert rng.randint(1 << 30) == jrng.randint(1 << 30)
    assert s.give_ups == js.give_ups == 1
    assert [r.name for r in caplog.records if "gave up" in r.getMessage()
            and kind in r.getMessage()] == ["crimac_unet_tpu_torch.data."
                                            "samplers",
                                            "crimac_unet_tpu.data.samplers"]


def _datasets(surveys, seed, meta=None):
    proot, jroot = surveys["port"][0], surveys["jax"][0]
    part = make_partition(dict(CFG, path_to_zarr_files=str(proot)))
    jpart = jax_partition(dict(CFG, path_to_zarr_files=str(jroot),
                               save_prediction_surveys=[]))
    (tr, te), (jtr, jte) = part.partition_data_train(), \
        jpart.partition_data_train()
    assert [r.name for r in tr + te] == [r.name for r in jtr + jte]
    s_tr, s_te, probs = part.get_samplers_train(tr, te)
    js_tr, js_te, jprobs = jpart.get_samplers_train(jtr, jte)
    assert probs == jprobs
    assert [type(s).__name__ for s in s_tr + s_te] == \
        [type(s).__name__ for s in js_tr + js_te]
    ds = dataset.RandomPatchDataset(s_tr, WIN, FREQS, probs, seed=seed,
                                    meta_channels=meta)
    jds = jax_dataset.RandomPatchDataset(js_tr, WIN, FREQS, jprobs,
                                         seed=seed, meta_channels=meta)
    return ds, jds, tr, jtr


def test_zarr_partition_and_batches_equal_host_and_pooled(surveys):
    ds, jds, tr, jtr = _datasets(surveys, 11)
    for _ in range(3):
        b, jb = ds.batch(4), jds.batch(4)
        assert set(b) == set(jb) == {"data", "labels", "seabed_row"}
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])
    ds, jds, tr, jtr = _datasets(surveys, 12)
    pool = device_pool.ZarrSamplePool(tr, FREQS, WIN, "cpu")
    jpool = jax_pool.ZarrSamplePool(jtr, FREQS, WIN)
    ds.use_pool(pool, with_seabed=True)
    jds.use_pool(jpool, with_seabed=True)
    host = dataset.RandomPatchDataset(ds.samplers, WIN, FREQS,
                                      np.diff(np.r_[0, ds.cum_probs]),
                                      seed=12)
    for _ in range(3):
        b, jb, hb = ds.batch(4), jds.batch(4), host.batch(4)
        for k in ("ech_idx", "starts", "seabed_row"):
            np.testing.assert_array_equal(b[k], jb[k])
        np.testing.assert_array_equal(b["seabed_row"], hb["seabed_row"])
        data, labels = device_pool.gather_crops(
            pool.data, pool.labels, torch.from_numpy(b["ech_idx"]),
            torch.from_numpy(b["starts"]), WIN)
        np.testing.assert_array_equal(data.numpy(), hb["data"])
        np.testing.assert_array_equal(labels.numpy(), hb["labels"])


@pytest.mark.parametrize("chunk_pings", [96, 512])
def test_zarr_pool_equals_jax_pool_and_host_crops(surveys, monkeypatch,
                                                  chunk_pings):
    """96: several chunks and a shifted tail per survey; 512: one short
    chunk per survey."""
    port, jax_r = _readers(surveys)
    for r in port + jax_r:
        _poison(monkeypatch, r)
    assert device_pool.canvas_dims(port, WIN) == \
        jax_pool.canvas_dims(jax_r, WIN)
    assert device_pool.pool_bytes(port, FREQS, WIN) == \
        jax_pool.pool_bytes(jax_r, FREQS, WIN)
    pool = device_pool.ZarrSamplePool(port, FREQS, WIN, "cpu",
                                      chunk_pings=chunk_pings)
    jpool = jax_pool.ZarrSamplePool(jax_r, FREQS, WIN,
                                    chunk_pings=chunk_pings)
    np.testing.assert_array_equal(pool.data.numpy(), np.asarray(jpool.data))
    np.testing.assert_array_equal(pool.labels.numpy(),
                                  np.asarray(jpool.labels))
    rng = np.random.RandomState(4)
    samples = [(k, c) for k, r in enumerate(port)
               for c in _edge_centers(r.shape, rng)]
    idx, starts = pool.prepare_batch([(port[k], c) for k, c in samples])
    jidx, jstarts = jpool.prepare_batch([(jax_r[k], c) for k, c in samples])
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(starts, jstarts)
    d, lab = device_pool.gather_crops(pool.data, pool.labels,
                                      torch.from_numpy(idx),
                                      torch.from_numpy(starts), WIN)
    jd, jl = jpool.gather(jidx, jstarts)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    for b, (k, c) in enumerate(samples):
        np.testing.assert_array_equal(d[b].numpy(),
                                      port[k].crop_data(c, WIN, FREQS))
        np.testing.assert_array_equal(lab[b].numpy(),
                                      port[k].crop_labels(c, WIN))


def test_meta_on_zarr_raises(surveys):
    port, _ = _readers(surveys)
    with pytest.raises(ValueError, match="memmap-only"):
        device_pool.ZarrSamplePool(port, FREQS, WIN, "cpu",
                                   meta_channels=META_CHANNELS_ALL)
    with pytest.raises(ValueError, match="ZarrSamplePool"):
        device_pool.DeviceSamplePool(port, FREQS, WIN, "cpu")
    with pytest.raises(ValueError, match="DeviceSamplePool"):
        device_pool.ZarrSamplePool(
            [type("M", (), {"data_format": "memmap"})()], FREQS, WIN, "cpu")
    with pytest.raises(ValueError, match="memmap-only"):
        crop_meta(port[0], (40, 60), WIN, META_CHANNELS_ALL)
    ds, jds, _, _ = _datasets(surveys, 3, meta=META_CHANNELS_ALL)
    with pytest.raises(ValueError, match="memmap-only"):
        ds.batch(2)
    with pytest.raises(ValueError, match="memmap-only"):
        jds.batch(2)


def test_reader_caches_built_once_under_threads(surveys, monkeypatch):
    """Prefetch threads share a reader: 16 threads asking at once for the
    valid pings and the objects table build each cache once and all get
    the same object."""
    import sys
    import threading
    import time
    (r17, _), _ = _readers(surveys)
    calls = {"pings": 0, "objects": 0}
    real_p, real_o = r17._read_valid_pings, r17._read_objects

    def counted(name, real):
        def f():
            calls[name] += 1
            time.sleep(0.01)      # widen the race window
            return real()
        return f

    monkeypatch.setattr(r17, "_read_valid_pings", counted("pings", real_p))
    monkeypatch.setattr(r17, "_read_objects", counted("objects", real_o))
    got = []
    barrier = threading.Barrier(16)

    def work():
        barrier.wait()
        got.append((r17.get_valid_pings(), r17.get_objects_file()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert calls == {"pings": 1, "objects": 1}
    assert len(got) == 16
    assert all(p is got[0][0] and o is got[0][1] for p, o in got)
