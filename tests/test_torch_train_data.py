"""The port's training data plane against the JAX package's, on the CPU.

One synthetic memmap survey per package (the same seed; each package
computes its own seabed and heave-reverted labels) feeds both packages'
crops, samplers, datasets and sample pools.  Stated tolerance: everything
here is integer or copy arithmetic and must be equal — crops (short
echograms included), sampler centers from equal ``RandomState`` seeds,
``RandomPatchDataset`` batches (host crops and pool coordinates), pool
sizes, and crops gathered from the pool on the device against the host
crops and the JAX package's ``_gather_crops``.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.data import dataset as jax_dataset
from crimac_unet_tpu.data import device_pool as jax_pool
from crimac_unet_tpu.data import samplers as jax_samplers
from crimac_unet_tpu.data.fixtures import make_survey_dir as jax_make_survey
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.partition import make_partition as jax_partition
from crimac_unet_tpu.utils import grids as jax_grids
from crimac_unet_tpu_torch.data import dataset, device_pool, samplers
from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.partition import make_partition
from crimac_unet_tpu_torch.utils import grids

WIN = (64, 64)
FREQS = [18, 38, 120, 200]
CFG = {"frequencies": FREQS, "patch_size": list(WIN), "data_mode": "memm",
       "partition_train": "selected surveys", "train_surveys": [2017],
       "validation_surveys": [2016], "partition_predict": "all surveys",
       "evaluation_surveys": [], "eval_mode": "all"}


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """(port readers, JAX readers, port root, JAX root): two 2017
    echograms, one 2016 echogram and one short 2016 echogram (48 range
    rows: shorter than the window)."""
    roots, shorts = [], []
    for make in (make_survey_dir, jax_make_survey):
        root = tmp_path_factory.mktemp("train_data")
        make(root, year=2017, n_echograms=2, H=150, W=400, seed=31,
             n_schools=4)
        make(root, year=2016, n_echograms=1, H=140, W=300, seed=32,
             n_schools=4)
        short = tmp_path_factory.mktemp("train_data_short")
        make(short, year=2016, n_echograms=1, H=48, W=200, seed=33,
             n_schools=2)
        roots.append(root)
        shorts.append(short)
    port = [Echogram(p) for p in sorted(roots[0].glob("20*"))
            + sorted(shorts[0].glob("20*"))]
    jax_r = [JaxEchogram(p) for p in sorted(roots[1].glob("20*"))
             + sorted(shorts[1].glob("20*"))]
    return port, jax_r, roots[0], roots[1]


@pytest.mark.parametrize("center", [(30, 40), (0, 0), (149, 399), (-20, 10),
                                    (75, 420), (63, 200)])
def test_extract_crops_equal(center):
    rng = np.random.RandomState(1)
    a2 = rng.randn(150, 400).astype(np.float32)
    a3 = rng.randn(3, 150, 400).astype(np.float32)
    for win in (WIN, (33, 17)):
        np.testing.assert_array_equal(
            grids.extract_crop_2d(a2, center, win, -7.0),
            jax_grids.extract_crop_2d(a2, center, win, -7.0))
        np.testing.assert_array_equal(
            grids.extract_crop_3d(a3, center, win, 0.0),
            jax_grids.extract_crop_3d(a3, center, win, 0.0))
    assert grids.crop_bounds(center, WIN)[0].tolist() == \
        jax_grids.crop_bounds(center, WIN)[0].tolist()
    assert grids.patch_coord_to_data_coord((3, 5), center, WIN).tolist() == \
        jax_grids.patch_coord_to_data_coord((3, 5), center, WIN).tolist()


def test_reader_crops_equal_incl_short_echograms(surveys):
    port, jax_r, _, _ = surveys
    rng = np.random.RandomState(2)
    for r, jr in zip(port, jax_r):
        H, W = r.shape
        for _ in range(6):
            c = [int(rng.randint(-30, H + 30)), int(rng.randint(-30, W + 30))]
            np.testing.assert_array_equal(r.crop_data(c, WIN, FREQS),
                                          jr.crop_data(c, WIN, FREQS))
            np.testing.assert_array_equal(r.crop_labels(c, WIN),
                                          jr.crop_labels(c, WIN))
    assert port[-1].shape[0] < WIN[0]      # the short echogram recenters


@pytest.mark.parametrize("kind", ["Background", "Seabed", "School27",
                                  "School1", "SchoolSeabed27",
                                  "SchoolSeabed1", "BackgroundSeabed"])
def test_sampler_draws_equal(surveys, kind):
    port, jax_r, _, _ = surveys

    def build(mod, readers):
        if kind.startswith("SchoolSeabed"):
            return mod.SchoolSeabed(readers, WIN, max_dist_to_seabed=WIN[0],
                                    fish_type=int(kind[12:]))
        if kind.startswith("School"):
            return mod.School(readers, WIN, int(kind[6:]))
        return getattr(mod, kind)(readers, WIN)

    s, js = build(samplers, port[:3]), build(jax_samplers, jax_r[:3])
    rng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(40):
        (c, r), (jc, jr) = s.get_sample(rng), js.get_sample(jrng)
        assert list(map(int, c)) == list(map(int, jc))
        assert r.name == jr.name
    assert rng.randint(1 << 30) == jrng.randint(1 << 30)


def _datasets(surveys, seed):
    port, jax_r, proot, jroot = surveys
    part = make_partition(dict(CFG, path_to_echograms=str(proot),
                               save_prediction_surveys=[]))
    jpart = jax_partition(dict(CFG, path_to_echograms=str(jroot),
                               save_prediction_surveys=[]))
    (tr, te), (jtr, jte) = part.partition_data_train(), \
        jpart.partition_data_train()
    assert [r.name for r in tr + te] == [r.name for r in jtr + jte]
    s_tr, s_te, probs = part.get_samplers_train(tr, te)
    js_tr, js_te, jprobs = jpart.get_samplers_train(jtr, jte)
    assert probs == jprobs
    ds = dataset.RandomPatchDataset(s_tr, WIN, FREQS, probs, seed=seed)
    jds = jax_dataset.RandomPatchDataset(js_tr, WIN, FREQS, jprobs,
                                         seed=seed)
    return ds, jds, tr, jtr


def test_partition_and_battery_match(surveys):
    ds, jds, tr, jtr = _datasets(surveys, 0)
    assert [type(s).__name__ for s in ds.samplers] == \
        [type(s).__name__ for s in jds.samplers]


def test_dataset_batches_equal_host_and_pooled(surveys):
    ds, jds, tr, jtr = _datasets(surveys, 11)
    for _ in range(3):
        b, jb = ds.batch(4), jds.batch(4)
        assert set(b) == set(jb) == {"data", "labels", "seabed_row"}
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])
    ds, jds, tr, jtr = _datasets(surveys, 12)
    pool = device_pool.DeviceSamplePool(tr, FREQS, WIN, device="cpu")
    jpool = jax_pool.DeviceSamplePool(jtr, FREQS, WIN)
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
        jdata, jlabels = jax_pool._gather_crops(
            jpool.data, jpool.labels, jnp.asarray(jb["ech_idx"]),
            jnp.asarray(jb["starts"]), WIN)
        np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_pool_canvases_and_bytes_equal(surveys):
    port, jax_r, _, _ = surveys
    assert device_pool.pool_bytes(port, FREQS, WIN) == \
        jax_pool.pool_bytes(jax_r, FREQS, WIN)
    assert device_pool.canvas_dims(port, WIN) == \
        jax_pool.canvas_dims(jax_r, WIN)
    for budget in (0.1, 2048):
        assert device_pool.fits_budget(port, FREQS, WIN, budget) == \
            jax_pool.fits_budget(jax_r, FREQS, WIN, budget)
    pool = device_pool.DeviceSamplePool(port, FREQS, WIN, device="cpu")
    jpool = jax_pool.DeviceSamplePool(jax_r, FREQS, WIN)
    np.testing.assert_array_equal(pool.data.numpy(), np.asarray(jpool.data))
    np.testing.assert_array_equal(pool.labels.numpy(),
                                  np.asarray(jpool.labels))
    # out-of-canvas starts clamp as jax.lax.dynamic_slice clamps them
    idx = np.array([0, 3], np.int32)
    starts = np.array([[-5, 10_000], [10_000, -3]], np.int32)
    d, lab = device_pool.gather_crops(pool.data, pool.labels,
                                      torch.from_numpy(idx),
                                      torch.from_numpy(starts), WIN)
    jd, jl = jax_pool._gather_crops(jpool.data, jpool.labels,
                                    jnp.asarray(idx), jnp.asarray(starts),
                                    WIN)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))


class _Counting:
    def __init__(self, fail_at=None):
        self.n = 0
        self.fail_at = fail_at
        self.lock = threading.Lock()

    def batch(self, batch_size):
        with self.lock:
            self.n += 1
            n = self.n
        if n == self.fail_at:
            raise RuntimeError("worker failed")
        return {"x": np.full(batch_size, n)}


def test_batch_prefetcher_delivers_n_batches():
    pf = dataset.BatchPrefetcher(lambda seed_offset=0: _Counting(), 3, 17,
                                 num_workers=4)
    got = list(pf)
    assert len(got) == 17 and all(b["x"].shape == (3,) for b in got)
    for t in pf.threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_batch_prefetcher_surfaces_worker_exception():
    shared = _Counting(fail_at=5)
    pf = dataset.BatchPrefetcher(lambda seed_offset=0: shared, 2, 50,
                                 num_workers=3, prefetch_depth=2)
    with pytest.raises(RuntimeError, match="worker failed"):
        for _ in pf:
            pass
    for t in pf.threads:
        t.join(timeout=10)
        assert not t.is_alive()
