"""Metadata channels (early and late inject): the port against the JAX
package.

The same synthetic memmap survey (one copy per package) and the same flax
weights (converted with the port's ``flax_to_torch_state_dict``) go
through the JAX ``GriddedRunner`` and the port's on the CPU (the port's
kernels run their plain versions), depth 3 / start_filts 8, float32
compute, the six channel families of ``config_meta_train.yaml``.  Stated
tolerances: ``crop_meta`` and the host builders equal; logits within
1e-5 relative; the written zero set identical and stored probabilities
within 2 float16 ulp; evaluation per-class counts identical and
|dAP| < 2e-3 (float32 sums in another order move a score by a float16
ulp, which shifts its bin).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.data.fixtures import make_survey_dir, make_zarr_survey
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.meta_channels import crop_meta as jax_crop_meta
from crimac_unet_tpu.models import torch_import
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    _build_meta_inputs as jax_build_meta_inputs
from crimac_unet_tpu.pipeline.inference import \
    _build_meta_slab_full as jax_build_meta_slab_full
from crimac_unet_tpu.pipeline.inference import \
    evaluate_reader as jax_evaluate_reader
from crimac_unet_tpu.pipeline.inference import \
    save_reader_predictions_memm as jax_save_memm
from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.meta_channels import crop_meta, get_in_channels
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models import weights
from crimac_unet_tpu_torch.models.fold_bn import fold_for_serving
from crimac_unet_tpu_torch.models.unet import UNet, build_unet
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.predict import (
    predict_reader, save_reader_predictions_memm)
from crimac_unet_tpu_torch.pipeline.runner import (GriddedRunner,
                                                   _build_meta_inputs,
                                                   _build_meta_slab_full)

H, W, SEED, PRELOAD = 120, 300, 23, 150
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 3,
       "start_filts": 8, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": PRELOAD, "transfer_dtype": "float32",
       "meta_channels": META_CHANNELS_ALL}
M = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("meta")
    out = {}
    for who in ("jax", "port"):
        make_survey_dir(root / who, year=2017, n_echograms=1, H=H, W=W,
                        seed=SEED)
        out[who] = next((root / who).iterdir())
    out["zarr"] = make_zarr_survey(root / "zarr", year=2017, n_echograms=1,
                                   H=H, W=W, seed=SEED)
    return out


def _flax(late, seed=12):
    cfg = dict(CFG, late_meta_inject=late)
    model = jax_build_unet(cfg)
    if late:
        v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 4)),
                       meta=jnp.zeros((1, 64, 64, M)), train=False)
    else:
        v = model.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 64, 64, 4 + M)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return cfg, model, v


@pytest.fixture(scope="module", params=[False, True], ids=["early", "late"])
def flax_model(request):
    return _flax(request.param)


def _assert_close_f16(got, want):
    """Identical zero set; |got - want| <= 2 float16 ulp of the larger."""
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want != 0).any()
    a, b = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(
        np.float32)
    bad = np.abs(a - b) > 2 * ulp
    assert not bad.any(), (bad.sum(), np.abs(a - b).max())


# ------------------------------------------------------------ host side
def test_meta_train_families_equal_yaml():
    import yaml
    with open(os.path.join(REPO, "crimac_unet_tpu", "configs",
                           "config_meta_train.yaml")) as f:
        want = yaml.safe_load(f)["meta_channels"]
    assert META_CHANNELS_ALL == want
    assert get_in_channels(META_CHANNELS_ALL) == M


@pytest.mark.parametrize("flags", [
    META_CHANNELS_ALL,
    dict(META_CHANNELS_ALL, portion_day=False, depth_rel=False),
    dict({k: False for k in META_CHANNELS_ALL}, portion_day=True)])
def test_crop_meta_matches_jax(surveys, flags):
    reader, jreader = Echogram(surveys["port"]), JaxEchogram(surveys["jax"])
    for center in ((60, 150), (0, 0), (119, 299), (30, -5), (200, 310)):
        for window in ((64, 64), (32, 16), (256, 256)):
            got = crop_meta(reader, center, window, flags)
            want = jax_crop_meta(jreader, center, window, flags)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    META_CHANNELS_ALL,
    dict(META_CHANNELS_ALL, portion_year=False, time_diff=False),
    dict({k: False for k in META_CHANNELS_ALL}, depth_abs_seabed=True)])
def test_host_meta_builders_match_jax(surveys, flags):
    """_build_meta_inputs (patch mode; per-pixel slab + per-patch
    constants) and _build_meta_slab_full (slab mode; per-column
    portion_day) in float64 host arithmetic, cast once."""
    reader, jreader = Echogram(surveys["port"]), JaxEchogram(surveys["jax"])
    runner = SimpleNamespace(meta_channels=flags, window=(64, 64))
    o, sw = 8, 48
    for Hp, Wp, row0, col0 in ((160, 304, -o, -o), (112, 208, -o, 142),
                               (64, 400, -o, 250)):
        C = (Wp - 2 * o) // sw
        centers = np.tile(col0 + o + np.arange(C) * sw, 3) - o - 1 + 32
        got = _build_meta_inputs(runner, reader, Hp, Wp, row0, col0,
                                 centers)
        want = jax_build_meta_inputs(runner, jreader, Hp, Wp, row0, col0,
                                     centers)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        got = _build_meta_slab_full(runner, reader, Hp, Wp, row0, col0)
        want = jax_build_meta_slab_full(runner, jreader, Hp, Wp, row0, col0)
        assert got.shape == (Hp, Wp, get_in_channels(flags))
        np.testing.assert_array_equal(got, want)


def test_meta_builders_raise_on_zarr(surveys):
    reader = DataReaderZarr(surveys["zarr"])
    runner = SimpleNamespace(meta_channels=META_CHANNELS_ALL, window=(64, 64))
    with pytest.raises(ValueError, match="memmap-only"):
        _build_meta_inputs(runner, reader, 64, 64, -8, -8, np.zeros(1))
    with pytest.raises(ValueError, match="memmap-only"):
        _build_meta_slab_full(runner, reader, 64, 64, -8, -8)


# --------------------------------------------------------------- model
def test_build_unet_meta_in_channels():
    early = build_unet(CFG)
    assert early.hparams["in_channels"] == 4 + M
    assert not early.late_meta_inject
    late = build_unet(dict(CFG, late_meta_inject=True))
    assert late.hparams["in_channels"] == 4
    assert late.conv_final.in_channels == 8 + 1
    assert late.post_processing_weights.main[0].in_features == M
    with pytest.raises(ValueError, match="late_meta_inject"):
        UNet(depth=2, start_filts=4, late_meta_inject=True)


def test_meta_mlp_weight_mapping():
    """meta_mlp/fc{1,2,3} Dense kernels (I, O) become the reference's
    post_processing_weights.main.{0,2,4} (O, I), as the JAX package's
    torch_import writes them; the BatchNorm fold carries them unchanged."""
    cfg, _, v = _flax(True, seed=3)
    sd = weights.flax_to_torch_state_dict(v)
    want = torch_import.flax_to_torch_state_dict(v)
    for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        k = f"post_processing_weights.main.{i}"
        kernel = v["params"]["meta_mlp"][fc]["kernel"]
        np.testing.assert_array_equal(sd[k + ".weight"], kernel.T)
        np.testing.assert_array_equal(sd[k + ".bias"],
                                      v["params"]["meta_mlp"][fc]["bias"])
        for s in (".weight", ".bias"):
            np.testing.assert_array_equal(sd[k + s], np.asarray(want[k + s]))
    assert set(sd) == set(want)
    model = build_unet(cfg)
    model.load_state_dict(weights.to_tensors(sd))
    folded, fsd = fold_for_serving(model, weights.to_tensors(sd),
                                   {"fold_bn": True})
    assert folded.late_meta_inject
    for k in sd:
        if k.startswith("post_processing_weights"):
            assert torch.equal(fsd[k], torch.tensor(sd[k]))
    folded.load_state_dict(fsd)


def test_meta_forward_matches_jax(flax_model):
    cfg, model, v = flax_model
    late = cfg["late_meta_inject"]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 64, 64, 4).astype(np.float32) * 3.0
    meta = rng.rand(2, 64, 64, M).astype(np.float32)
    net = build_unet(cfg)
    net.load_state_dict(weights.to_tensors(weights.flax_to_torch_state_dict(v)))
    net.eval()
    if late:
        want = np.asarray(model.apply(v, jnp.asarray(x),
                                      meta=jnp.asarray(meta), train=False))
        got = net(torch.from_numpy(x), torch.from_numpy(meta)).numpy()
        with pytest.raises(ValueError, match="meta"):
            net(torch.from_numpy(x))
    else:
        xm = np.concatenate([x, meta], axis=-1)
        want = np.asarray(model.apply(v, jnp.asarray(xm), train=False))
        got = net(torch.from_numpy(xm)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------- predict and eval
@pytest.mark.parametrize("mode", ["patch", "slab"])
def test_meta_predict_matches_jax(surveys, flax_model, tmp_path, mode):
    cfg, model, v = flax_model
    cfg = dict(cfg, infer_mode=mode)
    want = np.load(jax_save_memm(JaxRunner(model, v, cfg),
                                 JaxEchogram(surveys["jax"]),
                                 str(tmp_path / "jax.npy"), PRELOAD))
    runner = GriddedRunner(build_unet(cfg), weights.flax_to_torch_state_dict(v),
                           cfg, device="cpu")
    got = np.load(save_reader_predictions_memm(
        runner, Echogram(surveys["port"]), str(tmp_path / "port.npy"),
        PRELOAD))
    _assert_close_f16(got, want)
    assert runner.forwards == (2 if mode == "slab" else 4)


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_meta_eval_matches_jax(surveys, flax_model, transfer):
    cfg, model, v = flax_model
    cfg = dict(cfg, transfer_dtype=transfer)
    want = np.asarray(jax_evaluate_reader(
        JaxRunner(model, v, cfg), JaxEchogram(surveys["jax"]),
        jax_metrics.new_histogram(), eval_mode="region", chunk_cols=3))
    runner = GriddedRunner(build_unet(cfg), weights.flax_to_torch_state_dict(v),
                           cfg, device="cpu")
    got = evaluate_reader(runner, Echogram(surveys["port"]),
                          metrics.new_histogram(), eval_mode="region",
                          chunk_cols=3)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert want[0].sum() > 0 and want[1].sum() > 0
    aps = []
    for h in (got, want):
        curve = metrics.pr_curve_from_histogram(h)
        aps.append(-np.sum(np.diff(curve["recall"]) * curve["precision"][:-1]))
    assert abs(aps[0] - aps[1]) < 2e-3, aps


def test_meta_on_zarr_raises(surveys):
    cfg, _, v = _flax(False, seed=2)
    runner = GriddedRunner(build_unet(cfg), weights.flax_to_torch_state_dict(v),
                           cfg, device="cpu")
    reader = DataReaderZarr(surveys["zarr"])
    with pytest.raises(ValueError, match="memmap-only"):
        list(predict_reader(runner, reader, PRELOAD))
    with pytest.raises(ValueError, match="memmap-only"):
        evaluate_reader(runner, reader, metrics.new_histogram())
