"""The port's measurement tools on the CPU: FLOP accounting
(crimac_unet_tpu_torch/utils/flops.py) against the JAX package's analytic
count and against PyTorch's flop counter, burst timing
(utils/timing.py) and the torch.profiler traces and per-kernel table
(utils/profiling.py).  No time measured here is a device number: these
tests check what the tools count and parse."""

import gzip
import json

import pytest
import torch

from crimac_unet_tpu.utils import flops as jax_flops
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.utils import flops as F
from crimac_unet_tpu_torch.utils.general import PhaseTimer
from crimac_unet_tpu_torch.utils.profiling import (device_op_table,
                                                   device_trace,
                                                   print_device_op_table)
from crimac_unet_tpu_torch.utils.timing import burst_time


@pytest.mark.parametrize("hw", [(256, 256), (64, 96), (1120, 1120)])
@pytest.mark.parametrize("depth,start_filts,in_ch", [
    (5, 64, 4), (3, 8, 4), (2, 4, 11), (4, 16, 7)])
def test_analytic_flops_equal_jax(hw, depth, start_filts, in_ch):
    kw = dict(in_channels=in_ch, depth=depth, start_filts=start_filts)
    assert F.unet_forward_flops(*hw, **kw) == \
        jax_flops.unet_forward_flops(*hw, **kw)
    assert F.unet_train_step_flops(*hw, **kw) == \
        jax_flops.unet_train_step_flops(*hw, **kw)
    assert F.conv2d_flops(*hw, 3, in_ch, start_filts) == \
        jax_flops.conv2d_flops(*hw, 3, in_ch, start_filts)


def test_flagship_patch_flops():
    """The flagship forward: 96.4 GFLOP a 256 x 256 patch."""
    assert round(F.unet_forward_flops(256, 256) / 1e9, 1) == 96.4


def test_counted_flops_match_analytic():
    """PyTorch's flop counter over the port's eval forward (depth 5,
    start_filts 8, 64 x 64, batch 2) within 15 % of twice the analytic
    per-example count, as tests/test_flops.py holds XLA's count."""
    H = W = 64
    model = build_unet({"compute_dtype": "float32", "depth": 5,
                        "start_filts": 8}).eval()
    x = torch.zeros((2, H, W, 4))
    measured = F.counted_flops(model, x)
    analytic = 2 * F.unet_forward_flops(H, W, in_channels=4, depth=5,
                                        start_filts=8)
    assert abs(measured - analytic) / analytic < 0.15, (measured, analytic)


def test_peak_table_lookup(monkeypatch):
    """None on the CPU; the H100 SXM5 entry by the card's name; None for
    a card with no entry."""
    assert F.device_peak_flops("cpu") is None
    assert F.mfu(1e12, 1.0, "cpu") is None
    names = {"NVIDIA H100 80GB HBM3": 989.4e12,
             "NVIDIA A100-SXM4-80GB": None}
    for name, peak in names.items():
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, n=name: n)
        assert F.device_peak_flops("cuda") == peak
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert F.mfu(989.4e12, 2.0, "cuda") == pytest.approx(0.5)
    assert F.format_rate(3e12, 1.5) == "2.00 TFLOP/s"


def test_burst_time_on_cpu():
    calls = []
    syncs = []
    t = burst_time(lambda a: calls.append(a) or a, 3, reps=2, burst=4,
                   warmup=2, sync=syncs.append)
    assert t >= 0.0 and len(calls) == 2 + 2 * 4 and len(syncs) == 3
    assert burst_time(torch.add, torch.ones(8), torch.ones(8)) >= 0.0


def test_device_op_table_parses_trace(tmp_path):
    """GPU kernel events (cat == "kernel") summed by name from the newest
    *.pt.trace.json[.gz]; CPU ops and runtime calls are not kernels."""
    old = tmp_path / "old.pt.trace.json"
    old.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "stale", "dur": 9}]}))
    d = tmp_path / "run"
    d.mkdir()
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 99999},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 5000},
        {"ph": "X", "cat": "kernel", "name": "gather_db_kernel<...>",
         "dur": 1500},
        {"ph": "X", "cat": "kernel", "name": "gather_db_kernel<...>",
         "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "pool_kernel<bf16, 8, true>",
         "dur": 3000},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]}
    import os
    import time
    with gzip.open(d / "t.pt.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    later = time.time() + 10
    os.utime(d / "t.pt.trace.json.gz", (later, later))
    rows = device_op_table(tmp_path, top=0)
    assert [r["name"] for r in rows] == ["pool_kernel<bf16, 8, true>",
                                         "gather_db_kernel<...>"]
    assert rows[0]["total_ms"] == 3.0 and rows[0]["count"] == 1
    assert rows[1]["total_ms"] == 2.0 and rows[1]["count"] == 2
    assert len(device_op_table(tmp_path, top=1)) == 1
    with pytest.raises(FileNotFoundError):
        device_op_table(tmp_path / "empty")


def test_device_trace_writes_a_trace_on_cpu(tmp_path, monkeypatch, capsys):
    """CRIMAC_PROFILE_DIR turns device_trace on; without it (and no
    argument) it is off; enabled=True with no destination raises."""
    monkeypatch.delenv("CRIMAC_PROFILE_DIR", raising=False)
    with device_trace() as d:
        assert d is None
    with pytest.raises(ValueError, match="CRIMAC_PROFILE_DIR"):
        with device_trace(enabled=True):
            pass
    monkeypatch.setenv("CRIMAC_PROFILE_DIR", str(tmp_path / "prof"))
    timer = PhaseTimer()
    with device_trace(timer=timer) as d:
        with timer.phase("crimac-test-region"):
            torch.ones(64).sum()
    assert d == str(tmp_path / "prof")
    files = list((tmp_path / "prof").glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "crimac-test-region" for e in events)
    assert device_op_table(tmp_path / "prof") == []   # no card: no kernels
    print_device_op_table(tmp_path / "prof")
