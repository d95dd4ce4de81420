"""Memmap full-survey prediction: the port against the JAX package.

The same synthetic survey (one copy per package, so each computes its own
seabed and heave-reverted labels) and the same weights go through the JAX
``GriddedRunner`` + ``save_reader_predictions_memm`` and the port's
counterparts on the CPU (the port's kernels run their plain versions).
Stated tolerance: the written zero set is identical and the stored float16
probabilities agree within 2 float16 ulp (float32 convolutions summed in
another order move the softmax by ~1e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.data.fixtures import make_survey_dir
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    save_reader_predictions_memm as jax_save_memm
from crimac_unet_tpu_torch.data import fixtures as port_fixtures
from crimac_unet_tpu_torch.data.memmap_reader import Echogram, get_echograms
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.pipeline.predict import \
    save_reader_predictions_memm
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

H, W, SEED = 120, 300, 11
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
       "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": 150}


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    root = tmp_path_factory.mktemp("memm")
    dirs = {}
    for who in ("jax", "port", "cli"):
        make_survey_dir(root / who, year=2017, n_echograms=1, H=H, W=W,
                        seed=SEED)
        dirs[who] = root / who
    return dirs


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(4)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


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


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("output", ["float16", "uint8"])
def test_predict_matches_jax(surveys, variables, tmp_path, transfer,
                             output):
    model, v = variables
    cfg = dict(CFG, transfer_dtype=transfer, output_dtype=output)
    jax_reader = JaxEchogram(next(surveys["jax"].iterdir()))
    want = np.load(jax_save_memm(JaxRunner(model, v, cfg), jax_reader,
                                 str(tmp_path / "jax.npy"), 150))
    runner = GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v),
                           cfg, device="cpu")
    reader = Echogram(next(surveys["port"].iterdir()))
    got = np.load(save_reader_predictions_memm(
        runner, reader, str(tmp_path / "port.npy"), 150))
    assert got.shape == (2, H, W)
    _assert_close_f16(got, want)
    # the chunk grid: 2 chunks of 3 x 4 patches, fwd_batch 8 -> 2 x 8,
    # 4 of them pad
    px = cfg["patch_size"][0] * cfg["patch_size"][1]
    assert runner.timer.totals["n_fwd_px"] == 32 * px
    assert runner.timer.totals["n_pad_px"] == 8 * px
    assert runner.forwards == 4


def test_seabed_and_heave_labels_bit_equal(surveys):
    jax_reader = JaxEchogram(next(surveys["jax"].iterdir()))
    reader = Echogram(next(surveys["port"].iterdir()))
    np.testing.assert_array_equal(
        reader.get_seabed(save_to_file=False, ignore_saved=True),
        jax_reader.get_seabed(save_to_file=False, ignore_saved=True))
    np.testing.assert_array_equal(np.asarray(reader.label_memmap()),
                                  np.asarray(jax_reader.label_memmap()))
    # each package wrote its own labels_heave.dat
    assert reader.label_memmap().filename != \
        jax_reader.label_memmap().filename


def test_port_fixtures_write_the_jax_survey(tmp_path, surveys):
    """The port's copy of make_survey_dir writes the same echogram."""
    port_fixtures.make_survey_dir(tmp_path, year=2017, n_echograms=1, H=H,
                                  W=W, seed=SEED)
    mine = get_echograms(years=[2017], path_to_echograms=str(tmp_path),
                         minimum_shape=64)
    assert len(mine) == 1
    ref = JaxEchogram(next(surveys["jax"].iterdir()))
    assert mine[0].name == ref.name and mine[0].shape == ref.shape
    np.testing.assert_array_equal(mine[0].data_numpy(), ref.data_numpy())
    np.testing.assert_array_equal(mine[0].label_numpy(heave=False),
                                  ref.label_numpy(heave=False))
    assert [o["bounding_box"] for o in mine[0].objects] == \
        [o["bounding_box"] for o in ref.objects]


def test_cli_matches_jax_cli(surveys, variables, tmp_path, monkeypatch):
    """The port's CLI on a YAML + .pt writes the JAX CLI's _pred.npy."""
    import yaml
    from crimac_unet_tpu.pipeline.save_predict import main as jax_main
    from crimac_unet_tpu_torch.pipeline.save_predict import main

    _, v = variables
    ckpt = tmp_path / "model.pt"
    save_torch_checkpoint(v, ckpt)
    cfg = dict(CFG, data_mode="memm", save_prediction_surveys=[2017],
               partition_predict="selected surveys",
               transfer_dtype="float32", random_seed=3)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "setpyenv.json").write_text(
        '{"path_to_echograms": "%s"}' % surveys["cli"])
    monkeypatch.setenv("CRIMAC_SETPYENV", str(tmp_path / "setpyenv.json"))
    args = ["--yaml_path", str(tmp_path / "cfg.yaml"),
            "--checkpoint_path", str(ckpt)]
    jax_main(args + ["--save_predictions_path", str(tmp_path / "jax")])
    main(args + ["--save_predictions_path", str(tmp_path / "port"),
                 "--device", "cpu"])
    name = next(surveys["cli"].iterdir()).name + "_pred.npy"
    assert os.listdir(tmp_path / "port") == [name]
    _assert_close_f16(np.load(tmp_path / "port" / name),
                      np.load(tmp_path / "jax" / name))


def test_runner_rejects_unported_modes():
    """Unknown modes and malformed metadata flags raise; slab mode, the
    static grid and metadata channels are ported (tests/
    test_torch_serving.py, tests/test_torch_meta.py)."""
    sd = build_unet(CFG).state_dict()
    for extra, match in (({"infer_mode": "window"}, "infer_mode"),
                         ({"meta_channels": {"portion_year": True}},
                          "meta_channels keys"),
                         ({"output_dtype": "float32"}, "output_dtype")):
        with pytest.raises(ValueError, match=match):
            GriddedRunner(build_unet(CFG), sd, dict(CFG, **extra),
                          device="cpu")
    with pytest.raises(ValueError, match="transfer_dtype"):
        GriddedRunner(build_unet(CFG), sd,
                      dict(CFG, transfer_dtype="float16"), device="cpu")


def test_sub_batch_shape_matches_jax(variables):
    model, v = variables
    jr = JaxRunner(model, v, dict(CFG, fwd_batch=32))
    pr = GriddedRunner(build_unet(CFG), flax_to_torch_state_dict(v),
                       dict(CFG, fwd_batch=32), device="cpu")
    for n in (1, 7, 8, 20, 25, 32, 33, 64, 65, 100):
        assert pr._sub_batch_shape(n) == jr._sub_batch_shape(n)


def test_bfloat16_transfer_rounds_like_ml_dtypes():
    import ml_dtypes
    x = np.random.RandomState(0).lognormal(-15, 4, 4096).astype(np.float32)
    x[:4] = [np.nan, np.inf, -np.inf, 3.0e38]
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
