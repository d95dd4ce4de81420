"""The onboarding slice as a whole, and the port's examples.

One EK60 .raw/.bot/.snap trio (a seeded synthetic echogram written by the
port's ``fixtures.write_raw_trio``) goes through the JAX package's
onboarding (``convert_survey_raw`` -> ``convert_survey_tree`` ->
``batch_estimate_seabed``) and prediction (``GriddedRunner`` +
``save_reader_predictions_memm``), and through the port's counterparts on
the CPU, with the JAX variables carried into the port by
``models/weights.py``.  Stated tolerance: the onboarded echogram
directories equal (bytes; pickles unpickled; the ``.mat`` files loaded),
the write masks identical, the stored float16 probabilities within 2
float16 ulp (float32 convolutions summed in another order), as
tests/test_torch_predict.py holds.  The examples run on the CPU with
``--device cpu`` and raise without a card otherwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimac_unet_tpu.data import ek60 as jax_ek60
from crimac_unet_tpu.data.mat_to_memmap import \
    convert_survey_tree as jax_convert_tree
from crimac_unet_tpu.data.memmap_reader import Echogram as JaxEchogram
from crimac_unet_tpu.data.preprocess import \
    batch_estimate_seabed as jax_batch_seabed
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    save_reader_predictions_memm as jax_save_memm
from crimac_unet_tpu_torch.data import ek60, fixtures
from crimac_unet_tpu_torch.data.mat_to_memmap import convert_survey_tree
from crimac_unet_tpu_torch.data.memmap_reader import Echogram
from crimac_unet_tpu_torch.data.preprocess import batch_estimate_seabed
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.pipeline.predict import \
    save_reader_predictions_memm
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
from test_torch_ek60 import assert_same_tree
from test_torch_predict import _assert_close_f16

H, W, SEED = 140, 360, 17
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 3,
       "start_filts": 8, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": 200}
# the int16 power step of the RAW0 samples (half of 10*log10(2)/256 dB)
# plus float32 rounding of the stored sv and the datagram's float32 fields
SV_DB_TOL = 10 * np.log10(2) / 512 + 2e-6


@pytest.fixture(scope="module")
def onboarded(tmp_path_factory):
    """The raw trio onboarded by each package: {who: echogram dir}, and
    the source echogram."""
    root = tmp_path_factory.mktemp("onboard")
    src = Echogram(fixtures.make_survey_dir(root / "src", year=2017,
                                            n_echograms=1, H=H, W=W,
                                            seed=SEED)[0])
    cruise = root / "cruise"
    fixtures.write_raw_trio(src, cruise)
    out = {}
    for who, conv_raw, conv_tree, seabed, reader in (
            ("jax", jax_ek60.convert_survey_raw, jax_convert_tree,
             jax_batch_seabed, JaxEchogram),
            ("port", ek60.convert_survey_raw, convert_survey_tree,
             batch_estimate_seabed, Echogram)):
        scratch = root / who
        res = conv_raw(str(cruise), str(scratch))
        assert res == {src.name: "ok"}, res
        assert conv_tree(str(scratch)) == [src.name]
        ech_dir = scratch / "memmap" / src.name
        seabed([reader(str(ech_dir))])
        out[who] = ech_dir
    return out, src, root


def test_onboarded_directories_equal(onboarded):
    dirs, src, root = onboarded
    assert_same_tree(root / "port", root / "jax")
    assert sorted(os.listdir(dirs["port"])) == sorted(
        ["data_for_freq_18.dat", "data_for_freq_38.dat",
         "data_for_freq_120.dat", "data_for_freq_200.dat", "labels.dat",
         "frequencies.pkl", "range_vector.pkl", "time_vector.pkl",
         "data_dtype.pkl", "label_dtype.pkl", "shape.pkl", "depths.pkl",
         "heave.pkl", "objects.pkl", "seabed.npy"])


def test_onboarded_echogram_matches_its_source(onboarded):
    """Shape, year, sv within the int16 power step, labels nonzero
    exactly inside the snapped boxes, ping times and heave kept."""
    dirs, src, _ = onboarded
    e = Echogram(str(dirs["port"]))
    assert e.shape == (H, W) and e.year == 2017 and e.name == src.name
    got = e.data_numpy().astype(np.float64)
    want = src.data_numpy().astype(np.float64)
    assert np.abs(10 * np.log10(got) - 10 * np.log10(want)).max() \
        <= SV_DB_TOL
    boxes = np.zeros(src.shape, bool)
    for obj in src.objects:
        y0, y1, x0, x1 = obj["bounding_box"]
        boxes[y0:y1 + 1, x0:x1 + 1] = True
    labels = np.asarray(e.label_memmap(heave=False))
    np.testing.assert_array_equal(labels != 0, boxes)
    np.testing.assert_allclose(e.time_vector, src.time_vector, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(e.heave, src.heave, atol=1e-6)


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(5)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_onboarded_prediction_matches_jax(onboarded, variables, tmp_path,
                                          transfer):
    dirs, _, _ = onboarded
    model, v = variables
    cfg = dict(CFG, transfer_dtype=transfer)
    want = np.load(jax_save_memm(JaxRunner(model, v, cfg),
                                 JaxEchogram(str(dirs["jax"])),
                                 str(tmp_path / "jax.npy"), 200))
    runner = GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v),
                           cfg, device="cpu")
    got = np.load(save_reader_predictions_memm(
        runner, Echogram(str(dirs["port"])), str(tmp_path / "port.npy"),
        200))
    assert got.shape == (2, H, W)
    _assert_close_f16(got, want)
    assert runner.forwards > 0


def test_regrid_prediction_of_stored_map_is_identity(onboarded, tmp_path):
    from crimac_unet_tpu_torch.data.regrid import regrid_prediction
    dirs, _, _ = onboarded
    e = Echogram(str(dirs["port"]))
    pred = np.random.RandomState(2).rand(2, H, W).astype(np.float16)
    for k in range(2):
        out = regrid_prediction(pred[k], e)
        np.testing.assert_array_equal(out.astype(np.float16), pred[k])


EXAMPLES = ["example_ek60_onboarding", "example_zarr_reader",
            "example_samplers", "example_production_serving",
            "example_aot_deployment"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, capsys):
    import importlib
    mod = importlib.import_module(f"crimac_unet_tpu_torch.examples.{name}")
    mod.main(["--device", "cpu"])
    assert "cpu" in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_raises_without_cuda(name, monkeypatch):
    import importlib
    mod = importlib.import_module(f"crimac_unet_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
