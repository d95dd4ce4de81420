"""Calls written for the JAX package, made in the port.

The port's public functions take the JAX package's positional order and
defaults (its own ``device`` / ``mesh`` / ``gen`` / ``cvt`` come after
them, with defaults), so a call written for the JAX package binds the
same fields in the port.  Each case makes the JAX-style call in both
packages on the same seeded inputs, on the CPU, and holds the results to
each other:

- the binding itself (``inspect.Signature.bind``): every JAX parameter
  gets the same value in the port, under its name or its rename
  (``tests/test_torch_surface.py``);
- readers, partitions, pools, patches, histograms, checkpoint bytes and
  the parameter count: bit-equal;
- losses: within 1e-6 (float32 reductions in another order);
- stored predictions: the written zero set identical and probabilities
  within 2 float16 ulp (``tests/test_torch_serving.py``).
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crimac_unet_tpu import config as jax_config
from crimac_unet_tpu.data import blosc_codec as jax_codec
from crimac_unet_tpu.data import device_pool as jax_pool
from crimac_unet_tpu.data import fixtures as jax_fixtures
from crimac_unet_tpu.data import partition as jax_partition
from crimac_unet_tpu.data import preprocess as jax_preprocess
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.memmap_reader import \
    get_echograms as jax_get_echograms
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
from crimac_unet_tpu.models import torch_import as jax_torch_import
from crimac_unet_tpu.models import unet as jax_unet
from crimac_unet_tpu.ops import label_ops as jax_label_ops
from crimac_unet_tpu.ops import metrics as jax_metrics
from crimac_unet_tpu.ops import patches as jax_patches
from crimac_unet_tpu.pipeline import cli_common as jax_cli
from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu.pipeline import save_predict as jax_save_predict
from crimac_unet_tpu.pipeline import segpipe as jax_segpipe
from crimac_unet_tpu.pipeline import train as jax_train
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu_torch import config
from crimac_unet_tpu_torch.data import blosc_codec, device_pool, fixtures
from crimac_unet_tpu_torch.data import partition, preprocess
from crimac_unet_tpu_torch.data.memmap_reader import Echogram, get_echograms
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.models import unet, weights
from crimac_unet_tpu_torch.ops import label_ops, metrics, patches
from crimac_unet_tpu_torch.pipeline import (cli_common, engine, save_predict,
                                            segpipe, train)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

FREQS = [18, 38, 120, 200]
WIN = (32, 32)
RENAMES = {"key": "gen", "rng": "gen", "variables": "state_dict",
           "platforms": "device", "sharding": "device"}
SMALL = {"patch_size": list(WIN), "patch_overlap": 4, "frequencies": FREQS,
         "fwd_batch": 8, "depth": 2, "start_filts": 4,
         "compute_dtype": "float32", "mesh_devices": 1}


SENTINEL = [object() for _ in range(12)]

# (JAX callable, port callable, number of positional arguments)
CALLS = [
    (jax_partition._DataPartition.__init__,
     partition._DataPartition.__init__, 11),
    (JaxReader.get_data_slice, DataReaderZarr.get_data_slice, 8),
    (JaxReader.get_label_slice, DataReaderZarr.get_label_slice, 8),
    (JaxReader.get_seabed_mask, DataReaderZarr.get_seabed_mask, 7),
    (JaxReader.get_seabed, DataReaderZarr.get_seabed, 6),
    (jax_save_predict.run_save_predictions,
     save_predict.run_save_predictions, 5),
    (jax_train.run_training, train.run_training, 5),
    (jax_segpipe.SegPipeUNet.__init__, segpipe.SegPipeUNet.__init__, 4),
    (jax_cli.load_eval_context, cli_common.load_eval_context, 4),
    (jax_engine.dice_loss, engine.dice_loss, 4),
    (jax_engine.init_train_state, engine.init_train_state, 4),
    (jax_engine.save_checkpoint, engine.save_checkpoint, 3),
    (jax_engine.load_checkpoint, engine.load_checkpoint, 2),
    (jax_metrics.update_pr_histogram, metrics.update_pr_histogram, 4),
    (jax_pool.DeviceSamplePool.__init__, device_pool.DeviceSamplePool.__init__,
     5),
    (jax_pool.ZarrSamplePool.__init__, device_pool.ZarrSamplePool.__init__,
     6),
    (jax_pool.DeviceSamplePool.gather, device_pool.DeviceSamplePool.gather,
     3),
    (jax_train.maybe_build_pool, train.maybe_build_pool, 4),
    (jax_patches.extract_patches_2d, patches.extract_patches_2d, 5),
    (jax_patches.pad_slab_3d, patches.pad_slab_3d, 6),
]


@pytest.mark.parametrize("jax_fn,port_fn,n", CALLS,
                         ids=[c[1].__qualname__ for c in CALLS])
def test_positional_call_binds_as_in_jax(jax_fn, port_fn, n):
    args = SENTINEL[:n]
    want = inspect.signature(jax_fn).bind_partial(*args).arguments
    got = inspect.signature(port_fn).bind_partial(*args).arguments
    assert len(got) == len(want)
    for name, value in want.items():
        assert got.get(name, got.get(RENAMES.get(name))) is value, name


# ------------------------------------------------------------ the surveys
@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """Per package: a memmap root of 2017 echograms and a zarr survey of
    two echograms of 90 and 110 range rows (the shorter one's pings end
    in 20 all-NaN range rows)."""
    root = tmp_path_factory.mktemp("jax_calls")
    out = {}
    for who, fx, pre, Ech in (
            ("jax", jax_fixtures, jax_preprocess, JaxEchogram),
            ("port", fixtures, preprocess, Echogram)):
        fx.make_survey_dir(root / who / "memm", year=2017, n_echograms=2,
                           H=90, W=120, seed=5)
        dirs = [fx.make_survey_dir(root / who / f"tmp{h}", year=2017,
                                   n_echograms=1, H=h, W=100, seed=h)[0]
                for h in (90, 110)]
        pre.echograms_to_zarr_survey([Ech(str(d)) for d in dirs],
                                     str(root / who / "zarr"), "S2017843",
                                     categories=[-1, 1, 27])
        out[who] = root / who
    return out


def _readers(surveys):
    path = "zarr/S2017843_sv.zarr"
    return (DataReaderZarr(str(surveys["port"] / path)),
            JaxReader(str(surveys["jax"] / path)))


# --------------------------------------------------- F2-F5: the zarr reader
@pytest.mark.parametrize("args", [(0, 100, 0, 110), (50, 100, 80, None),
                                  (0, None, None, None), (120, 40, 5, 100)])
def test_get_data_slice_drop_na_matches_jax(surveys, args):
    r, j = _readers(surveys)
    for freqs in (None, [38, 200]):
        got = r.get_data_slice(*args, freqs, True, True)
        want = j.get_data_slice(*args, freqs, True, True)
        np.testing.assert_array_equal(got, want)
        kept = r.get_data_slice(*args, freqs, False)
        np.testing.assert_array_equal(kept, j.get_data_slice(*args, freqs))
    if args == (0, 100, 0, 110):     # the 90-row echogram's pings
        assert got.shape[2] == 90 < kept.shape[2] == 110


@pytest.mark.parametrize("cats", [None, [27], [1, 27]])
def test_get_label_slice_positional_matches_jax(surveys, cats):
    r, j = _readers(surveys)
    np.testing.assert_array_equal(r.get_label_slice(20, 150, 3, 90, False,
                                                    cats, True),
                                  j.get_label_slice(20, 150, 3, 90, False,
                                                    cats, True))


@pytest.mark.parametrize("pad", [0, 7])
def test_get_seabed_mask_and_seabed_positional_match_jax(surveys, pad):
    r, j = _readers(surveys)
    np.testing.assert_array_equal(r.get_seabed_mask(10, 120, 0, 110, True,
                                                    pad),
                                  j.get_seabed_mask(10, 120, 0, 110, True,
                                                    pad))
    np.testing.assert_array_equal(r.get_seabed(17, 40, 0, 110, True),
                                  j.get_seabed(17, 40, 0, 110, True))


# ------------------------------------------------------ F1: the partition
PARTITION_ARGS = (FREQS, list(WIN), "selected surveys", [2017], [2017],
                  "selected surveys", [2017], [2017], "fish", 8)


def test_partition_positional_fields_match_jax(surveys):
    j = jax_partition.DataMemm(*PARTITION_ARGS, path_to_echograms=str(
        surveys["jax"] / "memm"))
    p = partition.DataMemm(*PARTITION_ARGS, path_to_echograms=str(
        surveys["port"] / "memm"))
    for name in ("frequencies", "window_size", "partition_train",
                 "train_surveys", "validation_surveys", "partition_predict",
                 "evaluation_surveys", "save_prediction_surveys",
                 "eval_mode", "patch_overlap"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.get_evaluation_surveys() == j.get_evaluation_surveys()


@pytest.mark.parametrize("mode", ["all", "region", "fish"])
def test_gridded_survey_sampler_matches_jax(surveys, mode):
    """``fish`` maps to the sampler's ``trace``; the centres equal the
    JAX sampler's."""
    args = PARTITION_ARGS[:8] + (mode, 8)
    j = jax_partition.DataMemm(*args, path_to_echograms=str(
        surveys["jax"] / "memm")).get_gridded_survey_sampler(2017)
    p = partition.DataMemm(*args, path_to_echograms=str(
        surveys["port"] / "memm")).get_gridded_survey_sampler(2017)
    assert len(p) == len(j) == 1 and len(p[0]) > 0
    np.testing.assert_array_equal(p[0].coords_list, j[0].coords_list)
    for i in (0, len(p[0]) - 1):
        (pc, pr), (jc, jr) = p[0].get_sample(i), j[0].get_sample(i)
        assert pc == jc and pr.name == jr.name
    if mode == "fish":
        trace = partition.DataMemm(
            *PARTITION_ARGS[:8], "trace", 8, path_to_echograms=str(
                surveys["port"] / "memm")).get_gridded_survey_sampler(2017)
        np.testing.assert_array_equal(p[0].coords_list,
                                      trace[0].coords_list)


# -------------------------------------------------- F13: the sample pools
def test_device_pool_positional_and_gather_match_jax(surveys):
    meta = dict(config.META_CHANNELS_ALL)
    readers = get_echograms(path_to_echograms=str(surveys["port"] / "memm"),
                            minimum_shape=32)
    jreaders = jax_get_echograms(path_to_echograms=str(
        surveys["jax"] / "memm"), minimum_shape=32)
    pool = device_pool.DeviceSamplePool(readers, FREQS, WIN, meta,
                                        device="cpu")
    jpool = jax_pool.DeviceSamplePool(jreaders, FREQS, WIN, meta)
    assert pool.meta_flags == jpool.meta_flags
    np.testing.assert_array_equal(pool.data.numpy(), np.asarray(jpool.data))
    idx = np.array([0, 1, 1, 0], np.int32)
    starts = np.array([[0, 0], [40, 90], [200, 300], [-5, 17]], np.int32)
    data, labels = pool.gather(idx, starts)
    jdata, jlabels = jpool.gather(idx, starts)
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_zarr_pool_positional_and_gather_match_jax(surveys):
    r, j = _readers(surveys)
    pool = device_pool.ZarrSamplePool([r], FREQS, WIN, None, 64,
                                      device="cpu")
    jpool = jax_pool.ZarrSamplePool([j], FREQS, WIN, None, 64)
    np.testing.assert_array_equal(pool.data.numpy(), np.asarray(jpool.data))
    idx = np.zeros(3, np.int32)
    starts = np.array([[3, 4], [60, 150], [100, 220]], np.int32)
    for got, want in zip(pool.gather(idx, starts), jpool.gather(idx, starts)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maybe_build_pool_positional_matches_jax(surveys):
    cfg = {"patch_size": list(WIN), "frequencies": FREQS,
           "use_device_pool": True}
    readers = get_echograms(path_to_echograms=str(surveys["port"] / "memm"),
                            minimum_shape=32)
    jreaders = jax_get_echograms(path_to_echograms=str(
        surveys["jax"] / "memm"), minimum_shape=32)
    pool = train.maybe_build_pool(dict(cfg, device="cpu"), readers, 64)
    jpool = jax_train.maybe_build_pool(cfg, jreaders, 64)
    assert pool.data.device.type == "cpu"
    np.testing.assert_array_equal(pool.labels.numpy(),
                                  np.asarray(jpool.labels))


# ---------------------------------------------- F9-F12: engine and metrics
def _logits_labels(seed=0, shape=(2, 16, 16)):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape, 3).astype(np.float32) * 3
    labels = rng.choice([0, 1, 2, -100], size=shape).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("w", [None, (10.0, 300.0, 250.0)])
def test_dice_loss_takes_class_weights_as_in_jax(w):
    logits, labels = _logits_labels()
    got = float(engine.dice_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels), w))
    want = float(jax_engine.dice_loss(jnp.asarray(logits),
                                      jnp.asarray(labels), w))
    assert abs(got - want) <= 1e-6
    assert float(engine.dice_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), w, 0.5)) == \
        pytest.approx(float(jax_engine.dice_loss(
            jnp.asarray(logits), jnp.asarray(labels), w, 0.5)), abs=1e-6)


def _histogram_inputs(seed, n=4000):
    """Probabilities over every bin edge case: zeros, ones, NaN, -0.0,
    negatives, above one; labels with every sentinel."""
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    special = np.array([0.0, 1.0, np.nan, -0.0, -0.25, 1.5, 6e-8, 0.99999],
                       np.float32)
    preds[:len(special) * 40] = np.repeat(special, 40)
    rng.shuffle(preds)
    labels = rng.choice([0, 1, 2, 3, -1, -100, -2, -3, -4, -5, 6],
                        size=n).astype(np.int32)
    return preds.reshape(40, -1), labels.reshape(40, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("impl", ["scatter", "sort", "matmul", None])
def test_update_pr_histogram_impls_bit_equal_to_jax(seed, impl):
    preds, labels = _histogram_inputs(seed)
    want = np.asarray(jax_metrics.update_pr_histogram(
        jax_metrics.new_histogram(), jnp.asarray(preds), jnp.asarray(labels),
        "scatter"))
    start = np.random.RandomState(seed + 9).randint(
        0, 5, want.shape).astype(np.int32)
    got = metrics.update_pr_histogram(
        torch.from_numpy(start.copy()), torch.from_numpy(preds),
        torch.from_numpy(labels), impl)
    np.testing.assert_array_equal(got.numpy(), start + want)
    if impl is not None:
        np.testing.assert_array_equal(np.asarray(
            jax_metrics.update_pr_histogram(
                jax_metrics.new_histogram(), jnp.asarray(preds),
                jnp.asarray(labels), impl)), want)


def test_update_pr_histogram_matmul_crosses_its_row_blocks(monkeypatch):
    """The one-hot products run in row blocks: more pixels than a block
    give the scatter's counts."""
    monkeypatch.setattr(metrics, "_MATMUL_ROWS", 1000)
    preds, labels = _histogram_inputs(4)
    want = metrics.update_pr_histogram(metrics.new_histogram(),
                                       torch.from_numpy(preds),
                                       torch.from_numpy(labels))
    got = metrics.update_pr_histogram(metrics.new_histogram(),
                                      torch.from_numpy(preds),
                                      torch.from_numpy(labels), "matmul")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="impl"):
        metrics.update_pr_histogram(metrics.new_histogram(),
                                    torch.from_numpy(preds),
                                    torch.from_numpy(labels), "gather")


@pytest.fixture(scope="module")
def flax_weights():
    model = jax_unet.build_unet(SMALL)
    v = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(4)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


TRAIN = dict(SMALL, lr=0.005, lr_step=100, lr_reduction=0.5,
             momentum=0.95)


def test_init_train_state_from_state_dict_matches_jax(flax_weights):
    """``state_dict`` seeds the weights, the momentum starts at zero."""
    model, v = flax_weights
    jstate = jax_engine.init_train_state(model, TRAIN,
                                         jax.random.PRNGKey(0), v)
    net = unet.build_unet(TRAIN)
    state = engine.init_train_state(net, TRAIN, None,
                                    weights.flax_to_torch_state_dict(v))
    payload = engine.checkpoint_payload(state)
    for k in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, payload[k],
                               jax.tree_util.tree_map(np.asarray,
                                                      getattr(jstate, k)))
    jax.tree_util.tree_map(
        np.testing.assert_array_equal, payload["opt_state"]["0"]["trace"],
        jax.tree_util.tree_map(np.asarray, jstate.opt_state[0].trace))
    assert state.step == int(jstate.step) == 0


def test_init_train_state_gen_draws_init_train(flax_weights):
    a = engine.init_train_state(unet.build_unet(TRAIN), TRAIN,
                                torch.Generator().manual_seed(7))
    b = unet.init_train_(unet.build_unet(TRAIN),
                         torch.Generator().manual_seed(7))
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n


def test_save_checkpoint_plain_weights_bytes_equal_jax(flax_weights,
                                                       tmp_path):
    """A ``{"params", "batch_stats"}`` tree and a state dict write the
    bytes the JAX package writes for the tree; both load back as the
    engine-level ``load_checkpoint``."""
    _, v = flax_weights
    jax_engine.save_checkpoint(tmp_path / "jax.msgpack", v)
    engine.save_checkpoint(tmp_path / "tree.msgpack", v)
    sd = weights.flax_to_torch_state_dict(v)
    engine.save_checkpoint(tmp_path / "sd.msgpack", weights.to_tensors(sd))
    want = (tmp_path / "jax.msgpack").read_bytes()
    assert (tmp_path / "tree.msgpack").read_bytes() == want
    assert (tmp_path / "sd.msgpack").read_bytes() == want
    got = engine.load_checkpoint(tmp_path / "tree.msgpack")
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k])


def test_load_checkpoint_template_restores_a_train_state(flax_weights,
                                                          tmp_path):
    _, v = flax_weights
    net = unet.build_unet(TRAIN)
    state = engine.init_train_state(net, TRAIN, None,
                                    weights.flax_to_torch_state_dict(v))
    state.step = 11
    engine.save_checkpoint(tmp_path / "s.msgpack", state)
    fresh = engine.init_train_state(unet.build_unet(TRAIN), TRAIN,
                                    torch.Generator().manual_seed(1))
    back = engine.load_checkpoint(tmp_path / "s.msgpack", fresh)
    assert back is fresh and back.step == 11
    for (n, x), (_, y) in zip(back.model.state_dict().items(),
                              net.state_dict().items()):
        assert torch.equal(x, y), n


# --------------------------------------------- F6-F8: the entry points
def _configs(surveys, **kw):
    base = dict(SMALL, data_mode="memm", partition_train="selected surveys",
                train_surveys=[2017], validation_surveys=[2017],
                partition_predict="selected surveys",
                evaluation_surveys=[2017], save_prediction_surveys=[2017],
                preload_n_pings=70, resume_writing=False, **kw)
    return ({who: dict(base, path_to_echograms=str(surveys[who] / "memm"))
             for who in ("jax", "port")})


def test_run_save_predictions_positional_matches_jax(surveys, flax_weights,
                                                     tmp_path):
    model, v = flax_weights
    cfg = _configs(surveys)
    jcfg = jax_config.parse_config_options(cfg["jax"])
    pcfg = config.parse_config_options(dict(cfg["port"], device="cpu"))
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
    jax_save_predict.run_save_predictions(
        jcfg, JaxRunner(model, v, jcfg), jax_partition.make_partition(jcfg),
        str(tmp_path / "jax"))
    runner = GriddedRunner(unet.build_unet(pcfg),
                           weights.flax_to_torch_state_dict(v), pcfg,
                           device="cpu")
    save_predict.run_save_predictions(pcfg, runner,
                                      partition.make_partition(pcfg),
                                      str(tmp_path / "port"), False)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 and sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        got = np.load(tmp_path / "port" / n).astype(np.float32)
        want = np.load(tmp_path / "jax" / n).astype(np.float32)
        np.testing.assert_array_equal(got == 0, want == 0)
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(
            np.float16)).astype(np.float32)
        assert (np.abs(got - want) <= 2 * ulp).all(), n


def test_run_training_positional_names_the_run(surveys, tmp_path):
    """``run_training(config, checkpoint_dir, experiment_name, logger)``:
    the name lands in ``SegPipeUNet.model_name``, as in the JAX package,
    and the logger slot stays the logger."""
    cfg = config.parse_config_options(dict(
        _configs(surveys)["port"], **TRAIN, device="cpu", iterations=2,
        test_iter=1, log_step=2, batch_size=2, num_workers=1,
        train_dtype="float32", use_device_pool=False))
    sp = train.run_training(cfg, tmp_path / "ck", "exp11", None, False)
    assert sp.model_name == "exp11" and sp.state.step == 2
    assert (tmp_path / "ck" / "last.msgpack").is_file()
    assert jax_segpipe.SegPipeUNet(cfg, None, "exp11").model_name == \
        segpipe.SegPipeUNet(cfg, None, "exp11").model_name == "exp11"
    assert segpipe.SegPipeUNet(cfg).model_name == "model"


def test_load_eval_context_mode_first_matches_jax(surveys, tmp_path):
    ck = tmp_path / "run7" / "best.msgpack"
    ck.parent.mkdir()
    ck.write_bytes(b"")
    ctx = {}
    for who, fn in (("jax", jax_cli.load_eval_context),
                    ("port", cli_common.load_eval_context)):
        yml = tmp_path / f"cfg_{who}.yaml"
        yml.write_text(yaml.safe_dump(_configs(surveys)[who]))
        ctx[who] = fn("eval", ["--yaml_path", str(yml),
                               "--checkpoint_path", str(ck),
                               "--save_path_metrics", str(tmp_path / who),
                               "--save_path_plot", str(tmp_path / who)],
                      True, False)
    j, p = ctx["jax"], ctx["port"]
    assert p.runner is None and j.runner is None
    assert (p.experiment_name, p.run_id) == ("cfg_port", "run7")
    assert j.run_id == p.run_id
    assert p.metrics_dir == str(tmp_path / "port" / "cfg_port" / "run7")
    assert p.plot_dir == p.metrics_dir
    assert [r.name for r in p.data_obj.get_survey_readers(2017)] == \
        [r.name for r in j.data_obj.get_survey_readers(2017)]


# ----------------------------------------------------- the added names
def test_count_params_on_the_flagship_shapes():
    flagship = {"depth": 5, "start_filts": 64, "frequencies": FREQS,
                "patch_size": [256, 256]}
    model = jax_unet.build_unet(flagship)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 4)))
    want = jax_unet.count_params(shapes["params"])
    net = unet.build_unet(flagship)
    assert unet.count_params(net) == want == 31_044_227
    np_params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    assert unet.count_params(np_params) == want


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_extract_patches_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(3)
    slab3 = (rng.randn(3, 70, 90) * 50).astype(dtype)
    y0s = np.array([0, 10, 38, 60, -4, 45], np.int32)   # the last two clamp
    x0s = np.array([0, 50, 58, 3, 20, 80], np.int32)
    want3 = np.asarray(jax_patches.extract_patches_3d(
        jnp.asarray(slab3), jnp.asarray(y0s), jnp.asarray(x0s), 32, 32))
    got3 = patches.extract_patches_3d(torch.from_numpy(slab3), y0s, x0s,
                                      32, 32)
    np.testing.assert_array_equal(got3.numpy(), want3)
    want2 = np.asarray(jax_patches.extract_patches_2d(
        jnp.asarray(slab3[1]), jnp.asarray(y0s), jnp.asarray(x0s), 20, 24))
    got2 = patches.extract_patches_2d(torch.from_numpy(slab3[1]),
                                      torch.from_numpy(y0s),
                                      torch.from_numpy(x0s), 20, 24)
    np.testing.assert_array_equal(got2.numpy(), want2)


def test_pad_slabs_bit_equal_to_jax():
    rng = np.random.RandomState(5)
    s3 = rng.randn(2, 7, 9).astype(np.float32)
    for args in ((1, 2, 3, 4, 0.0), (0, 5, 0, 1, np.nan)):
        np.testing.assert_array_equal(patches.pad_slab_3d(s3, *args),
                                      jax_patches.pad_slab_3d(s3, *args))
        np.testing.assert_array_equal(patches.pad_slab_2d(s3[0], *args),
                                      jax_patches.pad_slab_2d(s3[0], *args))


def test_small_names_match_jax(flax_weights):
    np.testing.assert_array_equal(label_ops.DISC_7X7,
                                  jax_label_ops.DISC_7X7)
    assert blosc_codec.scatter_cvt_available() == \
        jax_codec.scatter_cvt_available()
    _, v = flax_weights
    sd = weights.to_tensors(weights.flax_to_torch_state_dict(v))
    jax.tree_util.tree_map(
        np.testing.assert_array_equal, weights.torch_state_dict_to_flax(sd),
        jax_torch_import.torch_state_dict_to_flax(sd))
