"""Slab-mode streaming memory against survey length (ROADMAP C, F16).

Phase 19 of ``chip_smoke.py`` reads the host RSS delta of a 20 000-ping
slab-mode ``save_survey_predictions_zarr`` against the same call over
4000 pings.  Here the same call runs at a small size (depth 3,
start_filts 8, patch 64, float32) over zarr surveys of 1500, 3000 and
6000 pings, 200-ping chunks, on the CPU:

* the port's own host memory (numpy and Python objects, traced by
  ``tracemalloc``) stays flat in survey length;
* the runner's caches (``_col_starts``, ``_grid_cache``, the timer's
  tables) hold a number of entries that does not depend on the length;
* the JAX package's ``predict_reader`` in slab mode, on the same survey
  written by its own fixture, runs the same sequence of slab grids
  (R, C) as the port, so both see the same count of distinct forward
  shapes: whatever either keeps per shape, it keeps for the same
  workload;
* ``scripts/torch_soak50k.py`` reports the per-chunk rows phase 19
  prints.

The traced peak of a call is set by the decode of the survey's store
chunks (1024 pings x 100 ranges x 4 frequencies here): a chunk's window
that crosses a store-chunk boundary decodes two of them.  So every
length holds such a window (1500 pings and up; a 1000-ping survey lies
inside one store chunk), and the prefetch pool runs one thread, so that
the peak does not depend on whether two threads' decodes overlap.  The
seabed scan at the start of a call reads the bottom store in blocks of
``_SEABED_READ_ELEMS`` elements (ROADMAP C, F14): the blocks are cut to
1024 pings here, as a full-width (1000-range) survey's are about 4000
pings, so that every length scans more than one block.  The
pipeline's own bounds (two chunks prefetched, ``pipeline_depth`` in
flight, one write pending) do not depend on the survey's length.
"""

import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from crimac_unet_tpu_torch.data import zarr_reader
from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
from crimac_unet_tpu_torch.pipeline import predict
from crimac_unet_tpu_torch.pipeline.predict import \
    save_survey_predictions_zarr
from crimac_unet_tpu_torch.utils.general import process_pool
from scripts import torch_check_common as common, torch_soak50k

MODEL = {"depth": 3, "start_filts": 8, "patch_size": [64, 64],
         "patch_overlap": 10, "compute_dtype": "float32", "fwd_batch": 8,
         "infer_mode": "slab", "transfer_dtype": "bfloat16"}
LENGTHS = (1500, 3000, 6000)
H = 100
PRELOAD = 200
# Slack, chosen before the first run.  What the call must hold for the
# whole survey grows with it: the seabed row and its known flag, the
# reader's cached seabed and the ping times, about 33 bytes a ping; 64
# bytes a ping allows twice that.  10 % of the shortest survey's peak
# allows for the order in which the prefetch thread and the writer
# allocate.
# A chunk's slab held past its chunk (about 0.5 MB here) or its output
# (80 kB, 400 bytes a ping) breaks it.
PER_PING_BYTES = 64
ORDER_SLACK = 0.10


def _config():
    return common.model_config(MODEL)


@pytest.fixture(scope="module")
def weights():
    """The port's seeded state dict and the same weights as JAX
    variables."""
    from crimac_unet_tpu_torch.models.weights import torch_to_flax_variables
    sd = init_random_(build_unet(_config()),
                      torch.Generator().manual_seed(5)).state_dict()
    return sd, torch_to_flax_variables(sd)


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """Each length's survey, written by each package's fixture with the
    same seed."""
    from crimac_unet_tpu.data import fixtures as jfix
    root = tmp_path_factory.mktemp("f16")
    out = {}
    for w in LENGTHS:
        kw = dict(year=2017, n_echograms=1, H=H, W=w, seed=4, n_schools=4)
        out[w] = {"port": make_zarr_survey(root / f"port{w}", **kw),
                  "jax": jfix.make_zarr_survey(root / f"jax{w}", **kw)}
    return root, out


def _port_runner(sd):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the misaligned slab grid
        return common.make_runner(sd, _config(), "cpu")


def _port_call(sd, sv, out, monkeypatch):
    """One slab-mode streaming call under tracemalloc, one prefetch
    thread: its traced peak, the slab grids it ran, and the runner."""
    monkeypatch.setattr(predict, "process_pool", lambda name, workers:
                        process_pool(f"{name}-serial", 1))
    monkeypatch.setattr(zarr_reader, "_SEABED_READ_ELEMS", 1024 * H)
    runner = _port_runner(sd)
    grids = []
    real = runner._predict_slab

    def spy(data_slab, border_ext, R, C, meta_full=None):
        grids.append((R, C))
        return real(data_slab, border_ext, R, C, meta_full)
    runner._predict_slab = spy
    reader = DataReaderZarr(sv)
    tracemalloc.start()
    try:
        save_survey_predictions_zarr(runner, reader, str(out),
                                     preload_n_pings=PRELOAD)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return peak, grids, runner


@pytest.fixture(scope="module")
def base_peak(weights, surveys):
    """The shortest survey's traced peak, after a warm-up call (imports,
    first-use caches) on the same survey."""
    root, sv = surveys
    with pytest.MonkeyPatch.context() as mp:
        _port_call(weights[0], sv[LENGTHS[0]]["port"], root / "warm.zarr",
                   mp)
        return _port_call(weights[0], sv[LENGTHS[0]]["port"],
                          root / "base.zarr", mp)[0]


def _jax_grids(variables, sv):
    """The slab grids (R, C) the JAX package's ``predict_reader`` runs in
    slab mode over ``sv``."""
    from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    from crimac_unet_tpu.pipeline.inference import GriddedRunner, \
        predict_reader
    cfg = _config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner = GriddedRunner(jax_build_unet(cfg), variables, cfg)
    grids = []
    real = runner._predict_slab

    def spy(*a, **k):
        grids.append((int(a[4]), int(a[5])))
        return real(*a, **k)
    runner._predict_slab = spy
    for _ in predict_reader(runner, JaxReader(sv), PRELOAD):
        pass
    return grids


@pytest.mark.parametrize("n_pings", LENGTHS)
def test_slab_stream_memory_flat_in_survey_length(weights, surveys,
                                                  base_peak, n_pings,
                                                  monkeypatch):
    root, sv = surveys
    sd, variables = weights
    peak, grids, runner = _port_call(sd, sv[n_pings]["port"],
                                     root / f"pred{n_pings}.zarr",
                                     monkeypatch)
    bound = base_peak * (1 + ORDER_SLACK) \
        + PER_PING_BYTES * (n_pings - LENGTHS[0])
    assert peak <= bound, (n_pings, peak, base_peak, bound)

    # one slab forward a chunk; the caches do not grow with the survey:
    # one rank starts every window at column 0, and slab mode uses no
    # patch-start cache
    assert len(grids) == -(-n_pings // PRELOAD) == runner.forwards
    assert len(runner._col_starts) == 1 and not runner._grid_cache
    phases = {"device_wait", "d2h", "host_slab", "host_fill", "host_label",
              "h2d_dispatch", "device_chunk", "zarr_write", "pass_head",
              "seabed_lookup", "static_grid_shape", "store_remove",
              "wait_prefetch", "wait_writer"}
    assert set(runner.timer.totals) <= phases | {
        p + ".cpu" for p in phases} | {"n_fwd_px", "n_pad_px"}

    # the JAX package runs the same slab grids on the same survey
    jax_grids = _jax_grids(variables, sv[n_pings]["jax"])
    assert jax_grids == grids
    assert len(set(jax_grids)) == len(set(grids))


def test_soak_reports_memory_per_chunk(weights, surveys):
    """``torch_soak50k.run`` reports one row a chunk (the RSS, the count
    of distinct forward shapes so far, the pinned cache off a card as
    None, glibc's malloc counters) and the static-grid arm runs one
    shape."""
    root, sv = surveys
    sd = weights[0]
    model = {k: v for k, v in MODEL.items()
             if k not in ("infer_mode", "transfer_dtype")}
    res = {static: torch_soak50k.run(
        "slab", sd, sv[3000]["port"], "cpu", model,
        out=root / f"soak{static}.zarr", preload_n_pings=PRELOAD,
        static_grid=static) for static in (False, True)}
    for static, r in res.items():
        rows = r["chunks"]
        assert r["static_grid"] is static
        assert len(rows) == 3000 // PRELOAD == r["launches"]["forwards"]
        assert [row["chunk"] for row in rows] == list(range(len(rows)))
        for row in rows:
            assert set(row) == {"chunk", "t_s", "rss_bytes",
                                "forward_shapes", "pinned", "malloc"}
            assert row["rss_bytes"] > 0 and row["pinned"] is None
            m = row["malloc"]
            assert m is None or set(m) == {"in_use", "free", "mmap"}
        times = [row["t_s"] for row in rows]
        assert times == sorted(times) and 0 <= r["rss_peak_s"] <= r["wall_s"]
        assert r["rss_after_scan_bytes"] > 0
        assert "after the seabed scan" in torch_soak50k.scan_line(r)
        counts = [row["forward_shapes"] for row in rows]
        assert counts[0] == 1 and counts == sorted(counts)
        assert counts[-1] == len(r["forward_shapes"])
        assert all(s[0] == 1 and s[-1] == 4 for s in r["forward_shapes"])
        lines = torch_soak50k.chunk_lines(r, 3)
        assert len(lines) == len(rows[::3]) + ((len(rows) - 1) % 3 > 0)
        # the command line's timer table: phases and counters alike
        lines = torch_soak50k.timer_lines(r)
        assert len(lines) == len(r["timers"])
        assert any("n_fwd_px" in ln and " count " in ln for ln in lines)
        assert any("host_fill" in ln and " cpu " in ln for ln in lines)
    assert len(res[True]["forward_shapes"]) == 1
    np.testing.assert_array_equal(
        torch_soak50k.read_store(root / "soakTrue.zarr",
                                 DataReaderZarr(sv[3000]["port"]))[
            "store_pings"], 3000)


def test_zlib_reads_share_the_decode_pool(tmp_path, monkeypatch):
    """A read of many zlib chunks (the card host's codec, which has no
    libblosc) decodes them on the process's decode threads: twenty reads
    run on at most ``DECODE_THREADS`` threads, where a pool a read
    started eight new threads each time and glibc kept an arena for each
    (the soak's RSS rose with the survey's length; ROADMAP C, F16).  The
    values are the JAX package's, whose reads start their own pools."""
    import os
    import threading

    from crimac_unet_tpu.data import zarrlite as jax_zarrlite
    from crimac_unet_tpu_torch.data import blosc_codec, zarrlite
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4, 1000, 50)).astype(np.float32)
    arr = zarrlite.ZArray.create(tmp_path / "a", data.shape, (1, 128, 50),
                                 np.float32, compressor="zlib")
    arr[:] = data
    seen = set()
    for i in range(20):
        lo = 37 * i
        np.testing.assert_array_equal(arr[:, lo:lo + 500, :],
                                      data[:, lo:lo + 500, :])
        seen |= {t for t in threading.enumerate()
                 if t.name.startswith("crimac-decode")}
    assert 0 < len(seen) <= blosc_codec.DECODE_THREADS
    pool = blosc_codec.decode_pool()
    assert blosc_codec.decode_pool() is pool
    sel = np.s_[:, 100:700, :]
    np.testing.assert_array_equal(
        arr[sel], jax_zarrlite.ZArray.open(tmp_path / "a")[sel])
    # a forked child (another pid) finds no threads in its copy of the
    # pool: it starts a pool of its own
    monkeypatch.setattr(os, "getpid", lambda: -1)
    assert blosc_codec.decode_pool() is not pool
    np.testing.assert_array_equal(arr[sel], data[sel])


def test_abandoned_stream_stages_nothing_more(weights, surveys, monkeypatch):
    """Closing ``predict_reader`` after its first chunk, on the process's
    prefetch threads, cancels the chunks not yet started and waits for
    those being staged: nothing is staged after the close, and the
    threads are free for the next call."""
    import time

    root, sv = surveys
    filled = []
    real = predict._fill_hwc_slab

    def fill(*a, **k):
        filled.append(a[3])                  # the chunk's first column
        return real(*a, **k)
    monkeypatch.setattr(predict, "_fill_hwc_slab", fill)
    runner = _port_runner(weights[0])
    gen = predict.predict_reader(runner, DataReaderZarr(sv[3000]["port"]),
                                 PRELOAD)
    s, e, _, _ = next(gen)
    assert (s, e) == (0, PRELOAD)
    gen.close()
    n = len(filled)
    # pipeline_depth chunks enqueued before the first yield, two staged
    # ahead of them
    assert runner.pipeline_depth <= n <= runner.pipeline_depth + 2
    time.sleep(0.2)
    assert len(filled) == n
    pool = process_pool("prefetch", 2)
    assert pool._work_queue.empty()
    # and the next call streams on the same threads
    out = list(predict.predict_reader(runner, DataReaderZarr(
        sv[LENGTHS[0]]["port"]), PRELOAD))
    assert len(out) == -(-LENGTHS[0] // PRELOAD)
    assert process_pool("prefetch", 2) is pool


def test_process_pools_under_contention(tmp_path):
    """More threads than cores ask for one process pool at once and read
    a zlib store through the shared decode threads at once, with the
    interpreter switching threads as often as it can: every caller gets
    the same pool, and every read its own region."""
    import os
    import sys
    import threading

    from crimac_unet_tpu_torch.data import zarrlite
    rng = np.random.default_rng(1)
    data = rng.standard_normal((2, 2048, 16)).astype(np.float32)
    arr = zarrlite.ZArray.create(tmp_path / "s", data.shape, (1, 64, 16),
                                 np.float32, compressor="zlib")
    arr[:] = data
    n = 4 * (os.cpu_count() or 1) + 4
    got, bad = [None] * n, []
    start = threading.Barrier(n)

    def work(i):
        start.wait()
        got[i] = process_pool("contention", 2)
        lo = (97 * i) % 1500
        if not np.array_equal(arr[:, lo:lo + 500, :],
                              data[:, lo:lo + 500, :]):
            bad.append(i)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and all(p is got[0] for p in got) and got[0] is not None
