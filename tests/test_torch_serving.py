"""The serving preset: slab mode, the static grid and uint8 in/out, the port
against the JAX package.

The same synthetic surveys (one copy per package) and the same weights go
through the JAX ``GriddedRunner`` and the port's on the CPU (the port's
kernels run their plain versions), depth 3 / start_filts 8, float32
compute.  Stated tolerances: the written zero set is identical and stored
float16 probabilities agree within 2 float16 ulp (float32 convolutions
summed in another order); the slab front end equals the JAX chain
bit for bit on uint8 codes and within rtol 1e-6 / atol 1e-5 on raw sv
(log10 implementations differ in the last ulp); the static grid in patch
mode is bit-identical to the per-chunk grid; static-grid evaluation keeps
per-class counts identical and |dAP| < 2e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.data.fixtures import (make_survey_dir,
                                           make_synthetic_echogram,
                                           make_zarr_survey,
                                           write_memmap_echogram)
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxZarrReader
from crimac_unet_tpu.data.zarrlite import ZGroup as JaxGroup
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.pipeline.infer_common import \
    _net_db_input as jax_net_db_input
from crimac_unet_tpu.pipeline.infer_common import \
    grid_height_for_reader as jax_grid_height
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    evaluate_reader as jax_evaluate_reader
from crimac_unet_tpu.pipeline.inference import \
    save_reader_predictions_memm as jax_save_memm
from crimac_unet_tpu.pipeline.inference import \
    save_survey_predictions_zarr as jax_save_zarr
from crimac_unet_tpu.pipeline.save_predict import \
    run_save_predictions as jax_run_save_predictions
from crimac_unet_tpu_torch.config import SERVING_PRESET, parse_config_options
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.partition import make_partition
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.data.zarrlite import ZGroup
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.ops import metrics
from crimac_unet_tpu_torch.ops.gather_db import gather_db
from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
from crimac_unet_tpu_torch.pipeline.infer_common import (
    _quantize_db_u8, grid_height_for_reader)
from crimac_unet_tpu_torch.pipeline.predict import (
    predict_reader, save_reader_predictions_memm,
    save_survey_predictions_zarr, static_grid_shape_for_reader)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from crimac_unet_tpu_torch.pipeline.save_predict import run_save_predictions

H, W, SEED, PRELOAD = 120, 300, 41, 150
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 3,
       "start_filts": 8, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": PRELOAD}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    out = {}
    for who in ("jax", "port"):
        make_survey_dir(root / f"memm_{who}", year=2017, n_echograms=1, H=H,
                        W=W, seed=SEED)
        out["memm_" + who] = next((root / f"memm_{who}").iterdir())
        out["zarr_" + who] = make_zarr_survey(root / f"zarr_{who}",
                                              year=2017, n_echograms=1, H=H,
                                              W=W, seed=SEED)
    return out


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(8), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(8)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


def _port_runner(v, cfg):
    return GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v), cfg,
                         device="cpu")


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


# ------------------------------------------------------------- slab mode
@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
def test_slab_memm_matches_jax(surveys, variables, tmp_path, transfer):
    model, v = variables
    cfg = dict(CFG, infer_mode="slab", transfer_dtype=transfer)
    want = np.load(jax_save_memm(JaxRunner(model, v, cfg),
                                 JaxEchogram(surveys["memm_jax"]),
                                 str(tmp_path / "jax.npy"), PRELOAD))
    runner = _port_runner(v, cfg)
    got = np.load(save_reader_predictions_memm(
        runner, Echogram(surveys["memm_port"]), str(tmp_path / "port.npy"),
        PRELOAD))
    _assert_close_f16(got, want)
    # one whole-chunk forward per chunk, no patches
    assert runner.forwards == 2 and runner.timer.counts["n_fwd_px"] == 2


@pytest.mark.parametrize("transfer,output", [("float32", "float16"),
                                             ("bfloat16", "float16"),
                                             ("uint8", "uint8")])
def test_slab_zarr_matches_jax(surveys, variables, tmp_path, transfer,
                               output):
    model, v = variables
    cfg = dict(CFG, infer_mode="slab", transfer_dtype=transfer,
               output_dtype=output)
    jax_save_zarr(JaxRunner(model, v, cfg), JaxZarrReader(surveys["zarr_jax"]),
                  str(tmp_path / "jax"), preload_n_pings=PRELOAD)
    runner = _port_runner(v, cfg)
    save_survey_predictions_zarr(runner, DataReaderZarr(surveys["zarr_port"]),
                                 str(tmp_path / "port"),
                                 preload_n_pings=PRELOAD)
    _assert_close_f16(ZGroup.open(str(tmp_path / "port"))["annotation"][:],
                      JaxGroup.open(str(tmp_path / "jax"))["annotation"][:])
    assert runner.forwards == 2


def _jax_slab_front_end(slab, Hp, Wp, H16, W16, border, scaled):
    """The JAX slab chain (runner.py _predict_slab): _pad_slab to the grid,
    _net_db_input, the border where, jnp.pad to the pooling alignment."""
    x = jax_net_db_input(JaxRunner._pad_slab(jnp.asarray(slab), Hp, Wp),
                         scaled)
    if border is not None:
        bm = JaxRunner._border_mask(jnp.asarray(border, jnp.int32), Hp, Wp)
        x = jnp.where(bm[:, :, None], 0.0, x)
    return np.asarray(jnp.pad(x, ((0, H16 - Hp), (0, W16 - Wp), (0, 0))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("border", [None, (8, 90, 11, 130)])
@pytest.mark.parametrize("scaled", [False, True])
def test_slab_front_end_matches_jax_chain(dtype, border, scaled):
    """gather_db at N = 1, start (0, 0), window (H16, W16) over a slab of
    Hs < Hp shipped rows and Wp < W16 columns is the JAX chain: rows in
    [Hs, Hp) raw zeros, everything outside the rectangle (the zarr
    rectangle is the grid) and the pad 0.0."""
    Hp, Wp, H16, W16, Hs = 112, 144, 116, 148, 97
    rng = np.random.RandomState(5)
    raw = rng.lognormal(np.log(1e-6), 2.0, (Hs, Wp, 4)).astype(np.float32)
    raw[5:9, 10:20, 0] = np.nan
    raw[50:52, :, 2] = np.inf
    raw[60:62, 3:40, 1] = -np.inf
    raw[70, 70:90, 3] = -1e-3
    if dtype == "uint8":
        slab_np = _quantize_db_u8(raw)
        slab_t = torch.from_numpy(slab_np)
    elif dtype == "bfloat16":
        slab_t = torch.from_numpy(raw).to(torch.bfloat16)
        slab_np = slab_t.float().numpy().astype(jnp.bfloat16)
    else:
        slab_np, slab_t = raw, torch.from_numpy(raw)
    want = _jax_slab_front_end(slab_np, Hp, Wp, H16, W16, border, scaled)
    origin = torch.zeros(1, dtype=torch.int32)
    got = gather_db(slab_t, origin, origin, (H16, W16),
                    border=border if border is not None else (0, Hp, 0, Wp),
                    scaled=scaled)[0].numpy()
    assert got.shape == want.shape == (H16, W16, 4)
    assert not got[Hp:].any() and not got[:, Wp:].any()
    if dtype == "uint8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------- static grid
def _varying_seabed_echograms(root, heights=(120, 120), W=145):
    """Two memmap echograms with pinned, very different seabeds (and
    optionally different range extents), so per-chunk grids vary in
    height and, at the tail chunk, in width."""
    rng = np.random.RandomState(7)
    dirs = []
    for i, (frac, row) in enumerate(((0.3, 30), (0.85, 95))):
        h = heights[i]
        row = min(row, h - 20)
        data, labels, heave, _ = make_synthetic_echogram(
            h, W, rng, n_schools=3, seabed_frac=frac)
        d = write_memmap_echogram(root, f"2019843-D2019042{7 + i}-T06261{i}",
                                  data, labels, heave)
        np.save(os.path.join(d, "seabed.npy"), np.full(W, row, np.int64))
        dirs.append(d)
    return dirs


SG_CFG = {"patch_size": [32, 32], "patch_overlap": 4,
          "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
          "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1,
          "transfer_dtype": "float32"}


@pytest.fixture(scope="module")
def sg_variables():
    model = jax_build_unet(SG_CFG)
    v = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 4)),
                   train=False)
    return model, jax.tree_util.tree_map(np.asarray, v)


def _spy_shapes(runner, name):
    seen = []
    real = getattr(runner, name)

    def spy(*args, **kwargs):
        R, C = (args[5], args[6]) if name == "_predict_patches" \
            else (args[2], args[3])
        seen.append((R, C))
        return real(*args, **kwargs)
    setattr(runner, name, spy)
    return seen


@pytest.mark.parametrize("mode", ["patch", "slab"])
def test_static_grid_matches_per_chunk_grid(tmp_path, sg_variables, mode):
    """One grid shape for every chunk; in patch mode the outputs are
    bit-identical to the per-chunk grid's (live patches read the same
    slab values); in slab mode masks are identical, kept pixels move by
    float16-level amounts only near the per-chunk grid's bottom and right
    edges, and the interior is exact (as the JAX package claims)."""
    d = _varying_seabed_echograms(tmp_path)[0]
    # a seabed ramp: chunk grid heights grow along the echogram, and the
    # 49-ping tail chunk of 145 needs one grid column more
    np.save(os.path.join(d, "seabed.npy"),
            np.linspace(20, 100, 145).astype(np.int64))
    _, v = sg_variables
    runs = {}
    for static in (False, True):
        runner = _port_runner(v, dict(SG_CFG, infer_mode=mode,
                                      static_grid=static))
        seen = _spy_shapes(runner, "_predict_patches" if mode == "patch"
                           else "_predict_slab")
        reader = Echogram(d)
        runs[static] = (list(predict_reader(runner, reader, 97,
                                            save_labels=True)), seen)
    (dyn, dyn_shapes), (sta, sta_shapes) = runs[False], runs[True]
    assert len(set(dyn_shapes)) > 1, dyn_shapes
    assert len(set(sta_shapes)) == 1, sta_shapes
    assert sta_shapes[0] == (max(r for r, _ in dyn_shapes),
                             max(c for _, c in dyn_shapes))
    assert len(dyn) == len(sta) > 1
    for k, ((s_d, e_d, p_d, l_d), (s_s, e_s, p_s, l_s)) in enumerate(
            zip(dyn, sta)):
        assert (s_d, e_d) == (s_s, e_s)
        np.testing.assert_array_equal(l_d, l_s)
        if mode == "patch" or dyn_shapes[k] == sta_shapes[0]:
            np.testing.assert_array_equal(p_d, p_s)
            continue
        np.testing.assert_array_equal(p_d == 0, p_s == 0)
        np.testing.assert_allclose(p_d, p_s, atol=2e-3)
        r_cut, w = dyn_shapes[k][0] * 24, e_d - s_d
        interior = (slice(None), slice(0, max(r_cut - 40, 0)),
                    slice(0, max(w - 40, 0)))
        np.testing.assert_array_equal(p_d[interior], p_s[interior])
    assert any((p != 0).any() for _, _, p, _ in dyn)


class _Survey:
    def __init__(self, readers):
        self.readers = readers

    def get_survey_readers(self, survey):
        return self.readers


@pytest.mark.parametrize("mode", ["patch", "slab"])
def test_static_grid_survey_predict_matches_jax(tmp_path, sg_variables,
                                                mode):
    """A two-echogram memm survey of different heights under static_grid:
    one grid shape for the survey, outputs as the JAX package's static
    grid, and (patch mode) bit-identical to the port's per-reader grids."""
    model, v = sg_variables
    cfg = dict(SG_CFG, infer_mode=mode, data_mode="memm",
               save_prediction_surveys=[2019], resume_writing=False,
               preload_n_pings=97)
    dirs = {who: _varying_seabed_echograms(tmp_path / who, heights=(120, 150))
            for who in ("jax", "port")}
    (tmp_path / "jax_out").mkdir()
    jax_run_save_predictions(
        dict(cfg, static_grid=True),
        JaxRunner(model, v, dict(cfg, static_grid=True)),
        _Survey([JaxEchogram(d) for d in dirs["jax"]]),
        str(tmp_path / "jax_out"))
    shapes = {}
    for static in (False, True):
        runner = _port_runner(v, dict(cfg, static_grid=static))
        shapes[static] = _spy_shapes(runner, "_predict_patches"
                                     if mode == "patch" else "_predict_slab")
        out = tmp_path / f"port_{static}"
        out.mkdir()
        pcfg = parse_config_options(dict(cfg, static_grid=static))
        data_obj = make_partition(
            dict(pcfg, path_to_echograms=str(tmp_path / "port")))
        run_save_predictions(pcfg, runner, data_obj, str(out))
    assert len(set(shapes[False])) > 1 and len(set(shapes[True])) == 1
    names = sorted(os.listdir(tmp_path / "jax_out"))
    assert names == sorted(os.listdir(tmp_path / "port_True")) and \
        len(names) == 2
    for name in names:
        got = np.load(tmp_path / "port_True" / name)
        _assert_close_f16(got, np.load(tmp_path / "jax_out" / name))
        if mode == "patch":
            np.testing.assert_array_equal(
                got, np.load(tmp_path / "port_False" / name))


def test_static_grid_survey_eval_matches_jax(tmp_path, sg_variables):
    """Evaluation under the survey's fixed_R: per-class counts identical
    to the JAX package's and exactly the per-reader histogram."""
    model, v = sg_variables
    dirs = {who: _varying_seabed_echograms(tmp_path / who, heights=(120, 150))
            for who in ("jax", "port")}
    jreaders = [JaxEchogram(d) for d in dirs["jax"]]
    readers = [Echogram(d) for d in dirs["port"]]
    fixed_R = max(grid_height_for_reader(r, 32, 4) for r in readers)
    assert fixed_R == max(jax_grid_height(r, 32, 4) for r in jreaders)
    assert len({grid_height_for_reader(r, 32, 4) for r in readers}) == 2
    jr = JaxRunner(model, v, dict(SG_CFG, static_grid=True))
    runner = _port_runner(v, dict(SG_CFG, static_grid=True))
    want = jax_metrics.new_histogram()
    got = metrics.new_histogram()
    own = metrics.new_histogram()
    for jreader, reader in zip(jreaders, readers):
        want = jax_evaluate_reader(jr, jreader, want, chunk_cols=3,
                                   fixed_R=fixed_R)
        got = evaluate_reader(runner, reader, got, chunk_cols=3,
                              fixed_R=fixed_R)
        own = evaluate_reader(runner, reader, own, chunk_cols=3)
    want = np.asarray(want)
    np.testing.assert_array_equal(got, own)
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    assert want[0].sum() > 0 and want[1].sum() > 0
    aps = []
    for h in (got, want):
        curve = metrics.pr_curve_from_histogram(h)
        aps.append(-np.sum(np.diff(curve["recall"]) * curve["precision"][:-1]))
    assert abs(aps[0] - aps[1]) < 2e-3, aps


def test_static_grid_shape_matches_jax(tmp_path):
    from crimac_unet_tpu.pipeline.inference import \
        static_grid_shape_for_reader as jax_static_shape
    d = _varying_seabed_echograms(tmp_path, heights=(120, 150))
    for reader, jreader in zip((Echogram(x) for x in d),
                               (JaxEchogram(x) for x in d)):
        for preload, start in ((97, 0), (50, 20), (0, 0)):
            assert static_grid_shape_for_reader(
                reader, (32, 32), 4, preload, start) == jax_static_shape(
                jreader, (32, 32), 4, preload, start)


# -------------------------------------------------------- serving preset
def test_serving_preset_equals_yaml():
    import yaml
    with open(os.path.join(REPO, "crimac_unet_tpu", "configs",
                           "config_serving.yaml")) as f:
        want = yaml.safe_load(f)
    assert SERVING_PRESET == want
    for key, value in (("infer_mode", "slab"), ("static_grid", True),
                       ("transfer_dtype", "uint8"), ("output_dtype", "uint8"),
                       ("data_mode", "zarr")):
        assert SERVING_PRESET[key] == value
