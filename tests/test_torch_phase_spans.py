"""The port's tracer on the CPU: ``PhaseTimer``'s spans, CPU totals and
counters; the spans of a zarr prediction pass, chunk by chunk; their
export into a ``device_trace``; the idle-gap tool that reads them; and
the benchmark's readers of the timer's totals.  No time here is a device
number: these tests check what is recorded, not how long it took."""

import gzip
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.conftest import TINY_CONFIG, tiny_workload
from benchmark.yardstick.predict_cell import PredictCell
from crimac_unet_tpu_torch.data import blosc_codec
from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.pipeline.predict import (predict_reader,
                                                    save_survey_predictions_zarr)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.utils.general import PhaseTimer, map_charged
from crimac_unet_tpu_torch.utils.profiling import SPAN_CATEGORY, device_trace
from scripts import torch_span_gaps

H, W, PRELOAD = 120, 450, 150
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
       "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": PRELOAD}
LAUNCH = ("pass_head", "wait_prefetch", "wait_writer", "device_chunk",
          "device_wait", "d2h")
CHAIN = ("host_fill", "wait_prefetch", "device_chunk", "zarr_write")


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return make_zarr_survey(tmp_path_factory.mktemp("spans"), year=2017,
                            n_echograms=1, H=H, W=W, seed=5)


def _runner(mode="patch"):
    torch.manual_seed(0)
    cfg = dict(CFG, infer_mode=mode)
    return GriddedRunner(build_unet(cfg), build_unet(cfg).state_dict(), cfg,
                         device="cpu")


def _recorded_pass(runner, survey, target):
    """One warm zarr pass with recording on, over the store a first pass
    wrote: (spans, call start ns, call end ns)."""
    save_survey_predictions_zarr(runner, DataReaderZarr(survey),
                                 str(target), PRELOAD)
    runner.timer.reset()
    runner.timer.recording = True
    reader = DataReaderZarr(survey)
    t0 = time.time_ns()
    save_survey_predictions_zarr(runner, reader, str(target), PRELOAD)
    t1 = time.time_ns()
    runner.timer.recording = False
    return runner.timer.take_spans(), t0, t1


def _union_ns(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


# ------------------------------------------------------------ the timer
def test_spans_carry_chunk_parent_thread_and_clock():
    t = PhaseTimer()
    t.recording = True
    before = time.time_ns()
    t.start("outer", 300)
    t.start("inner", 300)
    t.stop("inner")
    t.stop("outer")

    def other():
        with t.phase("writer_side", 450):
            pass
    th = threading.Thread(target=other, name="span-test-thread")
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    after = time.time_ns()
    spans = {s[0]: s for s in t.take_spans()}
    assert set(spans) == {"outer", "inner", "writer_side"}
    _, thread, chunk, parent, a, b = spans["inner"]
    assert (thread, chunk, parent) == ("MainThread", 300, "outer")
    assert spans["outer"][4] <= a <= b <= spans["outer"][5]
    assert spans["outer"][3] is None and spans["outer"][2] == 300
    assert spans["writer_side"][1:4] == ("span-test-thread", 450, None)
    for _, _, _, _, a, b in spans.values():
        assert before <= a <= b <= after
    assert t.take_spans() == []          # taken spans are cleared
    assert t.counts["outer"] == t.counts["inner"] == 1


def test_recording_off_keeps_no_span_and_the_totals_hold():
    t = PhaseTimer()
    for _ in range(3):
        t.start("phase", 7)
        sum(range(20000))
        t.stop("phase")
    t.count("px", 5)
    t.count("px", 6)
    t.add("chunk_stream", 0.25)
    assert t.spans == []
    assert t.counts == {"phase": 3, "phase.cpu": 3, "px": 2,
                        "chunk_stream": 1}
    assert t.totals["px"] == 11 and t.totals["chunk_stream"] == 0.25
    assert 0 < t.totals["phase.cpu"] and 0 < t.totals["phase"]
    summary = t.summary()
    assert summary["px"] == {"count": 11, "n": 2}
    assert summary["phase"]["n"] == 3 and "cpu_s" in summary["phase"]
    assert "phase.cpu" not in summary and "chunk_stream" in summary
    report = t.report()
    line = next(ln for ln in report.splitlines() if ln.startswith("phase"))
    assert "cpu" in line and "count 11" in report
    t.reset()
    assert not t.totals and not t.counts and not t.counters


def test_a_phase_left_open_by_an_exception_is_dropped():
    t = PhaseTimer()
    t.recording = True
    with pytest.raises(RuntimeError):
        with t.phase("wait", 1):
            raise RuntimeError("prefetch failed")
    t.start("head")
    t.start("inner")                     # never stopped
    t.start("head")                      # the stale head goes, inner too
    t.start("next")
    t.stop("next")
    t.stop("head")
    spans = {s[0]: s for s in t.take_spans()}
    assert set(spans) == {"wait", "next", "head"}
    assert spans["next"][3] == "head" and spans["head"][3] is None
    assert t.stop("inner") == 0.0 and "inner" not in t.counts


def test_cpu_totals_and_counters_reach_the_benchmark_snapshot():
    """What ``PredictCell.timer_snapshot`` / ``timer_delta`` hand the
    readers: every phase's ``.cpu`` and every counter, as deltas."""
    t = PhaseTimer()
    cell = SimpleNamespace(runner=SimpleNamespace(timer=t))
    cell.timer_snapshot = lambda: PredictCell.timer_snapshot(cell)
    with t.phase("host_fill", 0):
        pass
    t.count("n_fwd_px", 100)
    before = cell.timer_snapshot()
    with t.phase("host_fill", 150):
        sum(range(20000))
    t.count("n_fwd_px", 40)
    t.count("n_pad_px", 10)
    delta = PredictCell.timer_delta(cell, before)
    assert delta["n_fwd_px"] == (40, 1) and delta["n_pad_px"] == (10, 1)
    assert delta["host_fill"][1] == delta["host_fill.cpu"][1] == 1
    assert delta["host_fill.cpu"][0] > 0


def test_a_phase_counts_the_cpu_of_the_pool_tasks_it_hands_work_to():
    """``map_charged`` charges each task's thread CPU to the caller: a
    fill that waits on the decode threads counts the decode's CPU in
    its ``.cpu``, not only its own thread's."""
    def burn(n):
        c0 = time.thread_time()
        while time.thread_time() - c0 < 0.05:
            pass
        return n
    t = PhaseTimer()
    with ThreadPoolExecutor(2) as pool:
        c0 = time.thread_time()
        with t.phase("host_fill", 0):
            assert list(map_charged(pool, burn, range(4))) == [0, 1, 2, 3]
        own = time.thread_time() - c0
    assert t.totals["host_fill.cpu"] >= 0.2 > own
    with t.phase("host_label", 0):       # charged once, to that phase
        pass
    assert t.totals["host_label.cpu"] < 0.2


# ----------------------------------------------------- the zarr pass
@pytest.mark.parametrize("mode", ["patch", "slab"])
def test_zarr_pass_chains_every_chunk_and_covers_the_pass(mode, survey,
                                                          tmp_path):
    runner = _runner(mode)
    spans, t0, t1 = _recorded_pass(runner, survey, tmp_path / "p.zarr")
    chunks = [0, 150, 300]
    by = {}
    for name, thread, chunk, parent, a, b in spans:
        by.setdefault((name, chunk), []).append((thread, parent, a, b))
    for c in chunks:
        ends = []
        for name in CHAIN:
            assert len(by[(name, c)]) == 1, (name, c)
            ends.append(by[(name, c)][0])
        fill, wait, dev, write = ends
        assert fill[0].startswith("crimac-prefetch")
        assert wait[0] == dev[0] == "MainThread"
        assert write[0].startswith("crimac-writer")
        # the slab is read before the launch thread has it, its device
        # work is enqueued after that and written after that
        assert fill[3] <= wait[3] <= dev[2] <= dev[3] <= write[2]
        assert by[("host_fill", c)][0][1] == "host_slab"
        assert len(by[("wait_writer", c)]) == 1
    head = by[("pass_head", None)][0]
    assert head[1] is None and by[("wait_prefetch", 0)][0][1] == "pass_head"
    assert head[3] <= by[("device_chunk", 0)][0][2]
    assert by[("store_remove", None)][0][1] == "pass_head"
    assert by[("seabed_lookup", None)][0][1] == "pass_head"
    assert ("chunk_stream", None) not in by  # no card: no CUDA events
    launch = [(a, b) for name, thread, _, _, a, b in spans
              if thread == "MainThread" and name in LAUNCH]
    assert _union_ns(launch) >= 0.9 * (t1 - t0)
    timer = runner.timer
    assert timer.counts["n_fwd_px"] == timer.counts["n_pad_px"] == 3
    assert "chunk_stream" not in timer.totals


def test_predict_reader_heads_its_pass_and_counts_the_pad(survey):
    """``predict_reader`` alone opens ``pass_head``; patch mode counts
    whole sub-batches of 8 patches of 64 x 64, of them the pad."""
    runner = _runner("patch")
    runner.timer.recording = True
    out = list(predict_reader(runner, DataReaderZarr(survey), PRELOAD))
    assert len(out) == 3
    spans = runner.timer.take_spans()
    head = [s for s in spans if s[0] == "pass_head"]
    first = min(s[4] for s in spans if s[0] == "device_chunk")
    assert len(head) == 1 and head[0][5] <= first
    assert not any(s[0] in ("wait_writer", "zarr_write") for s in spans)
    px = 64 * 64
    per_chunk = runner.timer.totals["n_fwd_px"] // 3
    pad = runner.timer.totals["n_pad_px"] // 3
    assert per_chunk % (8 * px) == 0 and 0 <= pad < per_chunk
    assert (per_chunk - pad) % px == 0


def test_device_trace_writes_the_threads_spans(survey, tmp_path):
    runner = _runner("slab")
    reader = DataReaderZarr(survey)
    save_survey_predictions_zarr(runner, reader, str(tmp_path / "w.zarr"),
                                 PRELOAD)
    with device_trace(tmp_path / "prof", timer=runner.timer) as d:
        assert runner.timer.recording
        save_survey_predictions_zarr(runner, reader,
                                     str(tmp_path / "p.zarr"), PRELOAD)
    assert d == tmp_path / "prof" and not runner.timer.recording
    assert runner.timer.spans == []          # written out and cleared
    files = list((tmp_path / "prof").glob("*.pt.trace.json.gz"))
    assert len(files) == 1 and not list((tmp_path / "prof").glob("*.json"))
    with gzip.open(files[0], "rt") as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in ev
            if e.get("ph") == "M" and e.get("name") == "thread_name"
            and e["args"]["name"].startswith("spans ")}
    spans = [e for e in ev if e.get("cat") == SPAN_CATEGORY]
    threads = {rows[e["tid"]] for e in spans}
    assert "spans MainThread" in threads
    assert any(t.startswith("spans crimac-prefetch") for t in threads)
    assert any(t.startswith("spans crimac-writer") for t in threads)
    assert all(e["ph"] == "X" and set(e["args"]) == {"chunk", "parent"}
               for e in spans)
    # the spans sit on the profiler's clock: every convolution the
    # profiler saw lies inside a device_chunk span
    chunks = [e for e in spans if e["name"] == "device_chunk"]
    convs = [e for e in ev if e.get("ph") == "X"
             and e.get("name") == "aten::conv2d"]
    assert convs and all(any(
        c["ts"] <= e["ts"] and e["ts"] + e["dur"] <= c["ts"] + c["dur"]
        for c in chunks) for e in convs)
    res = torch_span_gaps.summarize(*torch_span_gaps.events(doc))
    assert res["chunks"] == 3 and res["covered_share"] >= 0.9
    assert res["gaps"][0]["ms"] == pytest.approx(res["pass_ms"])


# ------------------------------------------------------ the gap tool
def test_span_gaps_name_each_gap_by_the_innermost_span():
    """A made-up trace: two chunks, one K1 kernel each, the device idle
    between; the gaps are named by the launch thread's innermost span."""
    base = 10 ** 15

    def span(name, chunk, a, b, thread="MainThread", parent=None):
        return (name, thread, chunk, parent, base + a * 1000,
                base + b * 1000)
    spans = [span("pass_head", None, 0, 100),
             span("wait_prefetch", 0, 10, 100, parent="pass_head"),
             span("device_chunk", 0, 100, 120),
             span("wait_prefetch", 150, 120, 300),
             span("device_chunk", 150, 300, 320),
             span("wait_writer", 0, 320, 400),
             span("zarr_write", 0, 310, 400, thread="crimac-writer_0")]
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "gather_db_kernel<u8>",
         "ts": 105, "dur": 10, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "gather_db_kernel<u8>",
         "ts": 305, "dur": 10, "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 115, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 102, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 303, "dur": 1, "args": {"correlation": 9}}]}
    res = torch_span_gaps.summarize(*torch_span_gaps.events(doc, spans),
                                    top=3)
    assert res["pass_ms"] == pytest.approx(0.4)
    assert res["busy_ms"] == pytest.approx(0.04)
    got = [(round(g["ms"], 6), g["span"], g["chunk"], g["parent"])
           for g in res["gaps"]]
    assert got == [(0.17, "wait_prefetch", 150, None),
                   (0.105, "wait_prefetch", 0, "pass_head"),
                   (0.085, "wait_writer", 0, None)]
    assert res["covered_share"] == pytest.approx(1.0)
    assert res["kernel_order_checked"] and res["kernel_before_its_chunk"] == []
    assert res["launch_checked"] and res["launch_outside_its_chunk"] == []
    ev = doc["traceEvents"]
    late = dict(doc, traceEvents=[dict(ev[0], ts=95)] + ev[1:])
    res = torch_span_gaps.summarize(*torch_span_gaps.events(late, spans))
    assert res["kernel_before_its_chunk"] == [0]
    # spans whose clock runs early: every kernel still starts after its
    # span's start, but the second launch falls after its span's end
    early = [(n, t, c, p, a - 30_000, b - 30_000)
             for n, t, c, p, a, b in spans]
    res = torch_span_gaps.summarize(*torch_span_gaps.events(doc, early))
    assert res["kernel_before_its_chunk"] == []
    assert res["launch_outside_its_chunk"] == [0, 150]
    # a trace of the device alone has no launch calls to check
    res = torch_span_gaps.summarize(*torch_span_gaps.events(
        dict(doc, traceEvents=ev[:3]), spans))
    assert res["kernel_order_checked"] and not res["launch_checked"]


# --------------------------------------------------- the benchmark
READINGS = {
    "pass_head_ms.predict": ({"pass_head": (1.5, 2)}, 750.0),
    "fill_wait_ms.predict": ({"wait_prefetch": (0.2, 40)}, 5.0),
    "host_fill_cpu_ms.predict": ({"host_fill.cpu": (4.0, 40)}, 100.0),
    "writer_wait_ms.predict": ({"wait_writer": (2.0, 20)}, 100.0),
    "zarr_write_cpu_ms.predict": ({"zarr_write.cpu": (3.0, 20)}, 150.0),
    "chunk_stream_ms.predict": ({"chunk_stream": (0.18, 20)}, 9.0),
    "forward_pad_share.predict": ({"n_fwd_px": (24 * 65536, 1),
                                   "n_pad_px": (4 * 65536, 1)},
                                  100.0 * 4 / 24),
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_returns_its_number_and_none_without(metric):
    read = bench_run.load_reader(metric)
    timer, want = READINGS[metric]
    assert read({"timer": timer}) == pytest.approx(want)
    assert read({"timer": {"host_fill": (1.0, 4)}}) is None


@pytest.mark.parametrize("cell", ["predict_zarr.serving",
                                  "predict_memm.baseline"])
def test_traced_tiny_cell_reports_the_program_metrics(cell, tmp_path,
                                                      monkeypatch):
    """A traced benchmark run of the cell at a tiny size on the CPU
    reports every new metric of the cell except the chunk's time on the
    card's stream."""
    monkeypatch.setattr(bench_run, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(blosc_codec, "_chunkio", False)
    monkeypatch.setattr(blosc_codec, "_libblosc", False)
    bench = bench_run.load_bench()
    res = bench_run.run_cell(
        bench, cell, 12345678901, 0.5, 1, device="cpu",
        overrides={"config": TINY_CONFIG,
                   "workload": dict(tiny_workload(cell), limits={
                       "prob_gap_max": 0.04, "prob_gap_mean": 0.003,
                       "mask_errors": 0, "output_errors": 0})})
    assert res["correct"], res["checks"]
    m = res["metrics"]
    want = {e["name"] for e in bench["per_layer"]
            if e["name"] in READINGS and cell in e["workloads"]}
    assert want and "chunk_stream_ms.predict" in want
    assert set(m) & set(READINGS) == want - {"chunk_stream_ms.predict"}
    assert m["pass_head_ms.predict"]["value"] > 0
    assert 0 <= m["forward_pad_share.predict"]["value"] < 100
    assert ("writer_wait_ms.predict" in m) == (cell ==
                                               "predict_zarr.serving")
