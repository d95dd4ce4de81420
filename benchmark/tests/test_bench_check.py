"""The check that decides ``correct``, on the CPU at a tiny width: the
reference agrees with itself and with the program, the control (the
reference in fp8 in the program's place) fails, and so does a run whose
timed path is broken underneath.

The tiny cells' limits here are set from tiny readings of the program
and the control over seeds 1-5 (PERF.md, §2), which the tests draw
from; the cells' own limits are set from readings at full width on the
card.  At this width the gradient and update gaps of the program and
the control overlap, so only the loss separates them there.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import predict as ref_predict
from benchmark.reference import train as ref_train
from benchmark.reference import unet
from benchmark.yardstick.faults import FAULTS

TINY_LIMITS = {
    "predict": {"prob_gap_max": 0.04, "prob_gap_mean": 0.003,
                "mask_errors": 0, "output_errors": 0},
    "train": {"loss_gap": 0.003, "update_gap": 0.3},
}
CELLS = ["predict_zarr.serving", "predict_memm.baseline",
         "train_b16.fast_train"]


def _limits(cell):
    return TINY_LIMITS["train" if cell.startswith("train") else "predict"]


def _state(seed=0, depth=2, filts=4):
    gen = torch.Generator().manual_seed(seed)
    return unet.init_state(gen, "cpu", depth, filts, 4)


def test_reference_forward_is_deterministic_and_batch_free():
    state = _state()
    x = torch.randn(4, 4, 64, 64, generator=torch.Generator().manual_seed(1))
    unet.calibrate_bn(state, x * 10 - 60, depth=2)
    with torch.no_grad():
        a = unet.forward(state, x, 2)
        b = torch.cat([unet.forward(state, x[i:i + 1], 2) for i in range(4)])
    assert torch.equal(a, unet.forward(state, x, 2))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_calibration_gives_unit_scale_logits():
    state = _state(3)
    x = torch.rand(4, 4, 64, 64, generator=torch.Generator().manual_seed(2))
    x = -75 + 60 * x
    unet.calibrate_bn(state, x, depth=2)
    with torch.no_grad():
        logits = unet.forward(state, x, 2)
    assert 0.1 < float(logits.std()) < 10


def test_train_reference_repeats_and_biases_under_bn_get_no_gradient():
    state = _state(5)
    g = torch.Generator().manual_seed(9)
    data = torch.rand(2, 4, 64, 64, generator=g) * 1e-5
    labels = torch.randint(0, 2, (2, 64, 64), generator=g) * 27
    cfg = {"lr": 0.005, "lr_reduction": 0.5, "lr_step": 1000,
           "momentum": 0.95}

    def once():
        gen = torch.Generator().manual_seed(4)
        return ref_train.run_steps(
            state, [(data, labels)] * 2, gen, cfg,
            lambda s, x, q, mode: unet.forward(s, x, 2, q, bn_mode=mode))

    (l1, g1, p1), (l2, g2, p2) = once(), once()
    assert l1 == l2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    norms = {k: float(v.norm()) for k, v in g1.items()}
    med = float(np.median(list(norms.values())))
    assert norms["down_convs.0.main.0.bias"] < 1e-3 * med


def test_write_mask_law_zarr_band():
    """A zarr chunk masks background from max(seabed, band top) + 10: with
    the seabed at row 5 and bands of 44 rows, rows 0-14 are written and
    every row from 15 on is not (band 1's top row 34 + 10 lies above it)."""
    cfg = {"patch_size": [64, 64], "patch_overlap": 10,
           "preload_n_pings": 100}
    n_range = 120
    sb = np.full(100, 5)
    g = ref_predict.Geometry(cfg, n_range, 100, sb, np.ones(100, bool),
                             True)
    ext = g.chunk(0, 100)
    labels = np.zeros((ext["row_cut"], 100), np.float32)
    keep = ref_predict.write_mask(g, ext, 0, 100, labels,
                                  np.ones((n_range, 100), bool))
    assert keep[:15].all() and not keep[15:].any()
    labels[:, 50] = 27          # a school is written wherever it lies
    keep = ref_predict.write_mask(g, ext, 0, 100, labels,
                                  np.ones((n_range, 100), bool))
    assert keep[:ext["row_cut"], 50].all()


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(tiny_run, cell):
    res = tiny_run(cell, 2, limits=_limits(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_run, cell):
    # a window of one step or pass: the checked steps take the stream's
    # next batches, so a timed window would make the compared crops, and
    # the control's readings, depend on the machine's speed
    res = tiny_run(cell, 4, limits=_limits(cell), control=True, seconds=0)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]


@pytest.mark.parametrize("cell,fault", [
    ("predict_zarr.serving", "swap_classes"),
    ("predict_memm.baseline", "swap_classes"),
    ("predict_memm.baseline", "half_batch_predict"),
    ("train_b16.fast_train", "unchanged_state"),
    ("train_b16.fast_train", "half_batch_train"),
])
def test_broken_timed_path_is_not_correct(tiny_run, cell, fault):
    res = tiny_run(cell, 5, fault=FAULTS[fault], limits=_limits(cell))
    assert not res["correct"], res["checks"]


def _after_warm_up(fault):
    """``fault`` planted once the warm-up is over, as a step captured or
    compiled after it would run, and not before."""
    def plant(cell):
        window = cell.window

        def faulty(seconds, span):
            fault(cell)
            return window(seconds, span)
        cell.window = faulty
    return plant


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch_train"])
def test_train_fault_after_warm_up_is_not_correct(tiny_run, fault):
    res = tiny_run("train_b16.fast_train", 5,
                   fault=_after_warm_up(FAULTS[fault]),
                   limits=_limits("train"))
    assert not res["correct"], res["checks"]


def test_traced_run_reports_per_layer_metrics(tiny_run):
    res = tiny_run("predict_zarr.serving", 1, trace=1,
                   limits=_limits("predict"))
    assert res["correct"]
    m = res["metrics"]
    assert m["host_fill_ms.predict"]["value"] > 0
    assert m["zarr_write_ms.predict"]["value"] > 0
    assert m["pass_pings_per_s.predict"]["value"] > 0
    assert "k1_roofline.predict" not in m   # no kernel runs on the CPU
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert list(res)[-1] == "checks"
