"""The port's where-the-time-goes tools (``scripts/torch_roofline.py``,
``torch_roofline_bwd.py``, ``torch_decomp.py``,
``torch_predict_timeline.py``, ``torch_host_slab_profile.py``,
``torch_host_scaling.py``) against the JAX repo's scripts and package.

Small size on the CPU (depth 3, start_filts 8, patch 32-64, the plain
versions of the kernels).  The JAX scripts are imported from
``scripts/`` (``roofline.py``, ``roofline_bwd.py``); the JAX functions
run eagerly on the CPU.  Tolerances: layer specs, costs, FLOP counts,
write-mask planes, slabs, casts and stores equal (bit for bit where
arrays); forwards and gradients at float32 within 1e-5; train losses
within 1e-5 of the float64 JAX reference.
"""

import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import roofline as jax_roofline  # noqa: E402
import roofline_bwd as jax_roofline_bwd  # noqa: E402

from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey  # noqa: E402
from crimac_unet_tpu_torch.pipeline import predict as P  # noqa: E402
from scripts import (torch_check_common as common, torch_decomp,  # noqa: E402
                     torch_host_scaling, torch_host_slab_profile,
                     torch_predict_timeline, torch_roofline,
                     torch_roofline_bwd, torch_timing_common as tc)

MODEL = {"depth": 3, "start_filts": 8, "patch_size": [64, 64],
         "patch_overlap": 10, "compute_dtype": "float32", "fwd_batch": 8}
PRELOAD = 300        # W = 700: three chunks
TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    return t.requires_grad_(grad)


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    root = tmp_path_factory.mktemp("perf_tools")
    return make_zarr_survey(root / "sv", year=2017, n_echograms=1, H=120,
                            W=700, seed=3, n_schools=6)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("perf_work")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small ops wait on idle threads' barriers
    when the other test workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _short_cpu_window(monkeypatch):
    """The host tools read CPU time over 0.5 s of calls; the CPU's
    numbers mean nothing here, so one call will do."""
    monkeypatch.setattr(torch_host_slab_profile, "CPU_WINDOW_S", 0.0)


@pytest.fixture(scope="module")
def sd():
    return torch_roofline.seeded_state_dict(common.model_config(MODEL))


# ------------------------------------------------------------- roofline
CASES = [(32, 256, 256, 5, 64), (4, 256, 256, 5, 64), (2, 64, 64, 3, 8),
         (1, 32, 48, 2, 4)]


@pytest.mark.parametrize("case", CASES)
def test_layer_specs_and_op_cost_match_jax(case):
    B, H, W, depth, sf = case
    specs = torch_roofline.layer_specs(B, H, W, depth, sf)
    assert specs == jax_roofline.layer_specs(B, H, W, depth, sf)
    for name, kind, b, h, w, ci, co in specs:
        for el in (2, 4):
            assert torch_roofline.op_cost(kind, b, h, w, ci, co, el) == \
                jax_roofline.op_cost(kind, b, h, w, ci, co, el), name


@pytest.mark.parametrize("case", CASES)
def test_spec_flops_sum_to_unet_forward_flops(case):
    from crimac_unet_tpu.utils.flops import \
        unet_forward_flops as jax_flops
    from crimac_unet_tpu_torch.utils.flops import unet_forward_flops
    B, H, W, depth, sf = case
    total = sum(torch_roofline.op_cost(k, b, h, w, ci, co)[0] for
                _, k, b, h, w, ci, co in
                torch_roofline.layer_specs(B, H, W, depth, sf))
    assert total == B * unet_forward_flops(H, W, depth=depth,
                                           start_filts=sf)
    assert total == B * jax_flops(H, W, depth=depth, start_filts=sf)


SPECS = torch_roofline.layer_specs(2, 32, 32, 3, 8)


@pytest.mark.parametrize("cut", torch_roofline.prefix_cuts(SPECS),
                         ids=lambda c: c[0])
def test_prefix_forward_matches_jax(cut):
    """The port's prefix forward (K3 at level 0, [up, skip] concat) with
    the JAX HWIO weights carried over equals roofline.py's
    ``forward_prefix`` at float32."""
    hwio = torch_roofline.hwio_weights(SPECS)
    x = (np.random.RandomState(3).randn(2, 32, 32, 4) * .1).astype(
        np.float32)
    want = jax_roofline.forward_prefix(
        jnp.float32(0), jnp.asarray(x),
        {k: (jnp.asarray(w), jnp.asarray(b)) for k, (w, b) in hwio.items()},
        SPECS, cut[1])
    got = torch_roofline.forward_prefix(
        _nchw(x), torch_roofline.port_weights(hwio, SPECS, "cpu",
                                              torch.float32), SPECS, cut[1])
    _close(_nhwc(got), want)


def test_whole_forward_matches_folded_jax(sd):
    import dataclasses

    from crimac_unet_tpu.models.fold_bn import fold_variables
    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    from crimac_unet_tpu_torch.models.weights import torch_to_flax_variables
    cfg = common.model_config(MODEL)
    model = torch_roofline.serving_model(sd, cfg, "cpu")
    assert not model.use_bn
    x = np.random.RandomState(1).randn(2, 64, 64, 4).astype(np.float32)
    got = model(torch.from_numpy(x)).numpy()
    jmodel = jax_build_unet(cfg)
    folded = dataclasses.replace(jmodel, use_bn=False)
    want = folded.apply(fold_variables(torch_to_flax_variables(sd)),
                        jnp.asarray(x), train=False)
    _close(got, want)


# ------------------------------------------------------ training roofline
def _port_kernel(w, kind):
    if kind == "convT":
        return w[::-1, ::-1].transpose(2, 3, 0, 1)
    return w.transpose(3, 2, 0, 1)


def _hwio_grad(dw, kind):
    if kind == "convT":
        return dw.transpose(2, 3, 0, 1)[::-1, ::-1]
    return dw.transpose(2, 3, 1, 0)


@pytest.mark.parametrize("kind", ["conv3", "conv1", "convT"])
def test_conv_backward_matches_jax_vjp(kind):
    rng = np.random.RandomState(5)
    k = {"conv3": 3, "conv1": 1, "convT": 2}[kind]
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = (rng.randn(k, k, 6, 5) * .3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    oh = 16 if kind == "convT" else 8
    ct = rng.randn(2, oh, oh, 5).astype(np.float32)
    y_j, vjp = jax.vjp(lambda xx, ww: jax_roofline_bwd.conv_fwd(
        xx, ww, jnp.asarray(b), kind), jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(ct))
    wt = torch.from_numpy(np.ascontiguousarray(_port_kernel(w, kind))
                          ).requires_grad_(True)
    y, dx, dw = torch_roofline_bwd.conv_fwdbwd(
        kind, _nchw(x, True), wt, torch.from_numpy(b), _nchw(ct))
    _close(_nhwc(y), y_j)
    _close(_nhwc(dx), dx_j)
    _close(_hwio_grad(dw.numpy(), kind), dw_j)


def test_pool_backward_matches_jax_vjp():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    ct = rng.randn(2, 4, 4, 6).astype(np.float32)
    y_j, vjp = jax.vjp(jax_roofline.maxpool, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(ct))
    y, dx = torch_roofline_bwd.pool_fwdbwd(_nchw(x, True), _nchw(ct))
    _close(_nhwc(y), y_j)
    _close(_nhwc(dx), dx_j)


def test_bn_row_matches_jax_time_bn_pair(monkeypatch):
    """The BatchNorm row's function (the train step's ``bn_relu_train``)
    against ``roofline_bwd.time_bn_pair``'s ``bn``, taken from the first
    function that script hands its timer: forward and gradients."""
    _bn_row_matches_jax(monkeypatch, torch_roofline_bwd.bn_relu)


def test_bn_law_row_matches_jax_time_bn_pair(monkeypatch):
    """The row of the law ``bn_relu_train`` replaced (``_bn_train`` +
    relu in plain ops), held to the same JAX function."""
    _bn_row_matches_jax(monkeypatch, torch_roofline_bwd.bn_relu_law)


def _bn_row_matches_jax(monkeypatch, fn):
    captured = []
    monkeypatch.setattr(jax_roofline_bwd, "chain_time",
                        lambda fn, *a, **k: captured.append(fn) or 0.0)
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 6, 6, 5) * 2 + .5).astype(np.float32)
    jax_roofline_bwd.time_bn_pair(jnp.asarray(x), 1e-3)
    bn_j = captured[0]
    g = rng.uniform(.5, 1.5, 5).astype(np.float32)
    b = rng.uniform(-.2, .2, 5).astype(np.float32)
    ct = rng.randn(4, 6, 6, 5).astype(np.float32)
    y_j, vjp = jax.vjp(lambda xx, gg, bb: bn_j(jnp.float32(0), xx, gg, bb),
                       jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    dx_j, dg_j, db_j = vjp(jnp.asarray(ct))
    bn = torch.nn.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(g))
        bn.bias.copy_(torch.from_numpy(b))
    y, dx, dg, db = torch_roofline_bwd.bn_fwdbwd(_nchw(x, True), bn,
                                                 _nchw(ct), fn)
    _close(_nhwc(y), y_j)
    _close(_nhwc(dx), dx_j)
    _close(dg.numpy(), dg_j)
    _close(db.numpy(), db_j)


def test_update_row_is_one_optimizer_step_optax_law():
    """Two update rows over the port's optimizer equal optax's SGD with
    momentum 0.95 (the JAX package's optimizer) on the same gradients."""
    import optax
    cfg = torch_roofline_bwd.train_config(2, 32, 2, 4, "float32")
    state = torch_roofline_bwd.train_model(cfg, "cpu")
    params = dict(state.model.named_parameters())
    p0 = {k: v.detach().numpy().copy() for k, v in params.items()}
    rng = np.random.RandomState(8)
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(2)]
    tx = optax.sgd(cfg["lr"], momentum=cfg["momentum"])
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        torch_roofline_bwd.sgd_update(state.optimizer)
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
    for k, p in params.items():
        _close(p.detach().numpy(), jp[k], 1e-6)


# -------------------------------------------------------- decomposition
def test_train_decomp_losses_match_jax_float64():
    """Forward + loss in train mode (batch statistics) and in eval mode
    (running statistics) against the JAX ``loss_fn`` of
    ``stage_train_decomp`` on the carried weights, in float64."""
    from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
    from crimac_unet_tpu.pipeline import engine as jax_engine
    from crimac_unet_tpu_torch.models.weights import torch_to_flax_variables
    res = torch_decomp.run_train("cpu", batches=(2,), size=32, depth=3,
                                 start_filts=8, compute_dtype="float32",
                                 reps=1)["b2"]
    cfg = torch_roofline_bwd.train_config(2, 32, 3, 8, "float32")
    sd = torch_roofline_bwd.train_model(cfg, "cpu").model.state_dict()
    x, y = torch_decomp.train_inputs(2, 32)
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   torch_to_flax_variables(sd))
        model = jax_build_unet(dict(cfg, compute_dtype="float64"))
        xj = jnp.asarray(x, jnp.float64)
        logits, _ = model.apply(v, xj, train=True, mutable=["batch_stats"])
        train = jax_engine.weighted_ce_loss(logits, jnp.asarray(y),
                                            (10.0, 300.0, 250.0))
        evalbn = jax_engine.weighted_ce_loss(
            model.apply(v, xj, train=False), jnp.asarray(y),
            (10.0, 300.0, 250.0))
        _close(res["losses"]["fwd"], float(train))
        _close(res["losses"]["grad"], float(train))
        _close(res["losses"]["fwd_evalbn"], float(evalbn))
    for call in ("fwd", "grad", "full_step", "fwd_evalbn"):
        assert set(res[call]) >= {"device_ms", "host_enqueue_ms", "wall_ms",
                                  "kernels", "kernel_ms", "launches"}


def test_predict_decomp_full_chunk_bit_equal(survey, sd):
    res = torch_decomp.run_predict("cpu", survey, MODEL, sd,
                                   preload_n_pings=PRELOAD, n=1)
    assert res["full_equal"] and res["k1_equal"]
    assert res["launches"]["forwards"] == res["sub_batches"]
    assert res["padded_to"] == res["sub_batches"] * res["sub_batch"] \
        >= res["n_useful_patches"] > 0


def test_capture_first_chunk_is_the_first_chunk_predict_reader_writes(
        survey, sd):
    """The captured stitched chunk, masked by the runner as the pass masks
    it, is what ``predict_reader`` yields for chunk 0."""
    runner = common.make_runner(sd, common.model_config(MODEL), "cpu")
    args, kw, out = torch_decomp.capture_first_chunk(
        runner, common.zarr_reader(survey), PRELOAD)
    assert "_predict_patches" not in runner.__dict__
    s, e, pred, _ = next(P.predict_reader(runner, common.zarr_reader(survey),
                                          PRELOAD))
    assert s == 0 and torch.equal(runner._predict_patches(*args, **kw), out)
    # the chunk's written probabilities come out of this stitched grid
    n_range = pred.shape[1]
    grid = out[:n_range, :e - s].permute(2, 0, 1).numpy().astype(np.float16)
    written = pred != 0
    assert written.any() and np.array_equal(pred[written], grid[written])


# ------------------------------------------------------------- timeline
@pytest.mark.parametrize("arm", ["default", "serving"])
def test_timeline_store_identical_and_every_kind_logged(arm, survey, sd,
                                                        work):
    real_put = P._to_device
    res = torch_predict_timeline.run_arm(arm, sd, common.zarr_reader(survey),
                                         work, "cpu", MODEL, PRELOAD)
    assert res["store_equal"]
    assert set(res["kinds_seen"]) >= set(
        torch_predict_timeline.SPY_KINDS + torch_predict_timeline.TIMER_KINDS)
    assert all(s <= 1.05 for s in res["thread_busy_share"].values())
    assert res["n_chunks"] == 3 and P._to_device is real_put
    assert res["device_busy_share"] is None      # no card: not measured
    if arm == "serving":
        assert res["config"]["infer_mode"] == "slab"


@pytest.mark.parametrize("where", ["body", "pass"])
def test_timeline_restores_every_patched_attribute_on_error(where, survey,
                                                            sd, work,
                                                            monkeypatch):
    runner = common.make_runner(sd, common.model_config(MODEL), "cpu")
    reader = common.zarr_reader(survey)
    real_put, real_timer = P._to_device, runner.timer
    if where == "pass":
        def broken(*a, **k):
            raise RuntimeError("label read failed")
        monkeypatch.setattr(reader, "get_label_slice", broken)
    with pytest.raises(RuntimeError):
        with torch_predict_timeline.instrument(runner):
            assert P._to_device is not real_put
            if where == "body":
                raise RuntimeError("boom")
            P.save_survey_predictions_zarr(runner, reader,
                                           str(work / "broken.zarr"),
                                           preload_n_pings=PRELOAD)
    assert P._to_device is real_put and runner.timer is real_timer
    for name in ("_predict_patches", "_predict_slab", "_mask_output"):
        assert name not in runner.__dict__


# ----------------------------------------------------------- host work
def test_host_components_equal_pipeline_chunk0(survey, sd, work):
    rows, equal, ctx, c = torch_host_slab_profile.profile(
        sd, common.model_config(MODEL), common.zarr_reader(survey), "cpu",
        work, reps=1, preload=PRELOAD)
    assert set(equal) == set(rows) and all(equal.values()), equal
    assert "zarr_compress" in rows and ctx["chunk"] == [0, c.w]
    u = ctx["u8_vs_inline_formula"]
    assert u["min"] >= 0 and u["max"] <= 1


def test_fill_and_label_planes_match_jax_package(survey):
    """``_fill_hwc_slab`` and the write-mask planes of chunk 0 through the
    port's reader and the JAX package's reader of the same store."""
    from crimac_unet_tpu.data.zarr_reader import \
        DataReaderZarr as JaxReaderZarr
    from crimac_unet_tpu.pipeline.inference import \
        _fill_hwc_slab as jax_fill
    from crimac_unet_tpu_torch.pipeline.infer_common import _fill_hwc_slab
    cfg = common.model_config(MODEL)
    port, jr = common.zarr_reader(survey), JaxReaderZarr(survey)
    c = torch_host_slab_profile.chunk_at(port, cfg, 0, PRELOAD)
    g, freqs = c.g, sorted(cfg["frequencies"])
    slabs = []
    for fill, reader in ((_fill_hwc_slab, port), (jax_fill, jr)):
        slab = np.zeros((g.Hs, g.Wp, 4), np.float32)
        fill(reader, freqs, slab, g.slab_x0, g.slab_x1, g.slab_y1, c.o,
             g.x_off)
        lab = reader.get_label_slice(c.s, c.w, 0, g.row_cut)
        planes = []
        for pred in (np.isfinite, lambda a: a == 0):
            m = np.zeros((g.nr, g.C * c.sw), bool)
            m[:g.row_cut, :c.w] = pred(lab).T
            planes.append(np.packbits(m, axis=1))
        slabs.append((slab, planes))
    assert slabs[0][0].tobytes() == slabs[1][0].tobytes()
    assert all(np.array_equal(a, b) for a, b in zip(slabs[0][1],
                                                    slabs[1][1]))


def test_bf16_cast_matches_ml_dtypes_with_non_finite():
    """The host cast of the bfloat16 transfer against ml_dtypes' (the JAX
    package's): every non-NaN element bit for bit (round to nearest even,
    +-Inf and the overflow to +Inf included), NaN where ml_dtypes has NaN.
    The NaN bit patterns differ (torch writes 0xFFFF, ml_dtypes 0x7FC0);
    K1 scrubs every NaN to 0 either way."""
    import ml_dtypes
    rng = np.random.RandomState(9)
    x = (10.0 ** rng.uniform(-12, 3, 20000)).astype(np.float32)
    x[::7] *= -1
    x[::97] = np.nan
    x[1::89] = np.inf
    x[2::83] = -np.inf
    x[3::79] = np.float32(3.4e38)         # past bfloat16's max: +Inf
    got = torch.from_numpy(x).to(torch.bfloat16)
    want = x.astype(ml_dtypes.bfloat16)
    nan = np.isnan(want.astype(np.float32))
    assert np.array_equal(torch.isnan(got).numpy(), nan) and nan.any()
    assert np.array_equal(got.view(torch.uint16).numpy()[~nan],
                          want.view(np.uint16)[~nan])
    assert np.isposinf(want[3::79].astype(np.float32)).all()


def test_u8_quantize_against_jax_and_the_inline_formula():
    """The pipeline's ``_quantize_db_u8`` equals the JAX package's bit for
    bit; against ``scripts/host_scaling.py``'s inline formula it is the
    same law rounded half up where the formula truncates: equal to the
    formula + 0.5 before its cast on finite non-negative sv, and at most
    one code above the formula itself."""
    from crimac_unet_tpu.pipeline.infer_common import \
        _quantize_db_u8 as jax_q
    from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8
    rng = np.random.RandomState(10)
    x = (10.0 ** rng.uniform(-11, 1, (64, 64, 4))).astype(np.float32)
    x[0, ::5, 0] = 0.0
    got = _quantize_db_u8(x)
    assert np.array_equal(got, jax_q(x))
    inline = torch_host_slab_profile.inline_u8_formula(x)
    d = got.astype(np.int16) - inline.astype(np.int16)
    assert d.min() >= 0 and d.max() <= 1 and (d == 1).any()
    rounded = (np.clip((10 * np.log10(x + 1e-10) + 75) * (255 / 75), 0, 255)
               + 0.5).astype(np.uint8)
    assert np.array_equal(got, rounded)


def test_slab_identical_at_1_2_4_decoder_threads(survey, monkeypatch):
    monkeypatch.setattr(torch_host_scaling, "counts", lambda: [1, 2, 4])
    reader = common.zarr_reader(survey)
    cfg = common.model_config(MODEL)
    c = torch_host_slab_profile.chunk_at(reader, cfg, 0, PRELOAD)
    rows = torch_host_scaling.decoder_threads(reader, cfg, c, reps=1)
    assert sorted(rows) == [1, 2, 4]
    assert all(r["slab_equal"] for r in rows.values())
    cc = torch_host_scaling.concurrent_assemblies(reader, cfg, PRELOAD,
                                                  per_thread=1, reps=1)
    assert all(r["slab_equal"] for r in cc.values())


# ---------------------------------------------------------------- phase 20
CPU_ONLY_FAILURES = ("launches", "K4 a full step", "K2 an eval-BN",
                     "full chunk K1, K3, forwards", "device-busy share")


def test_phase20_reads_every_key_of_each_run(survey, monkeypatch):
    """``chip_smoke.py`` phase 20 over every tool's ``run()`` on the CPU
    (small model): every key it prints exists, and the only checks that
    fail are the ones a card answers (launch counts, device intervals)."""
    import chip_smoke
    from crimac_unet_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(common, "device_of", lambda d: torch.device("cpu"))
    monkeypatch.setattr(common, "FLAGSHIP", common.model_config(MODEL))
    small = dict(size=16, depth=3, start_filts=4, n=1)
    for mod, name, kw in (
            (torch_roofline, "run", dict(small, batch=2, train_batch=1,
                                         prefixes=False)),
            (torch_roofline_bwd, "run", dict(small, batch=2, steps=2)),
            (torch_decomp, "run_predict", dict(n=1)),
            (torch_decomp, "run_train", dict(batches=(2,), size=16, depth=3,
                                             start_filts=4, reps=1))):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda dev, *a, _r=real, _kw=kw, **k:
                            _r(dev, *a, **{**k, **_kw}))
    monkeypatch.setattr(torch_host_scaling, "counts", lambda: [1, 2])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, msg: ok or failed.append(msg))
    with tempfile.TemporaryDirectory() as tmp:
        paths, rates = chip_smoke.phase_where_time_goes(
            torch, cuda_lib, Path(tmp), "cpu", survey)
    assert set(paths) == {f"p20_{k}" for k in (
        "roofline", "roofline_bwd", "decomp_predict", "decomp_train",
        "timeline_default", "timeline_serving", "host_profile",
        "host_scaling")}
    assert all(set(c) == set(cuda_lib.launches) for c in paths.values())
    assert {"timeline default", "timeline serving"} <= set(rates)
    unexplained = [m for m in failed
                   if not any(s in m for s in CPU_ONLY_FAILURES)]
    assert failed and not unexplained, unexplained


def test_timing_helpers_on_the_cpu():
    assert tc.copies(1) == 64 and tc.copies(10 * tc.L2_BYTES) == 2
    assert tc.copies(tc.L2_BYTES // 2) == 4 and tc.copies(1, "cpu") == 1
    assert tc.bound_s(989.4e12, 0, 989.4e12) == (1.0, "MXU")
    assert tc.bound_s(0, 3.35e12, 989.4e12) == (1.0, "HBM")
    assert tc.limit_of(0.01, 0.006, "HBM") == "launch"
    assert tc.limit_of(0.013, 0.006, "MXU") == "MXU"
    assert tc.profile_kernels(lambda: None, "cpu") == (None, None)
    out, n = tc.launches_of(lambda: 7, "cpu")
    assert out == 7 and not any(n.values())
    import chip_smoke
    assert tc.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
