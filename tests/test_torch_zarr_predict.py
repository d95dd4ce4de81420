"""Zarr full-survey prediction: the port against the JAX package.

The same zarr survey (one copy per package) and the same weights go
through the JAX ``save_survey_predictions_zarr`` and the port's on the
CPU (the port's kernels run their plain versions), and through both
packages' ``save_predict`` CLI and docker entry.  Stated tolerance: the
written zero set is identical, the stored float16 probabilities agree
within 2 float16 ulp (float32 convolutions summed in another order), and
the store's metadata, ``ping_time``, ``range``, ``category`` and the
masked labels are equal.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import crimac_unet_tpu_torch.data.zarrlite as port_zl
from crimac_unet_tpu.data.fixtures import make_zarr_survey
from crimac_unet_tpu.data.zarr_reader import DataReaderZarr as JaxReader
from crimac_unet_tpu.data.zarrlite import ZGroup as JaxGroup
from crimac_unet_tpu.models.torch_import import save_torch_checkpoint
from crimac_unet_tpu.models.unet import build_unet as jax_build_unet
from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner
from crimac_unet_tpu.pipeline.inference import \
    save_survey_predictions_zarr as jax_save_zarr
from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
from crimac_unet_tpu_torch.data.zarrlite import ZGroup
from crimac_unet_tpu_torch.models.unet import build_unet
from crimac_unet_tpu_torch.models.weights import flax_to_torch_state_dict
from crimac_unet_tpu_torch.pipeline.predict import (predict_reader,
                                                    save_survey_predictions_zarr)
from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

H, W, SEED, PRELOAD = 120, 300, 31, 150
CFG = {"patch_size": [64, 64], "patch_overlap": 8,
       "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
       "start_filts": 4, "compute_dtype": "float32", "mesh_devices": 1,
       "preload_n_pings": PRELOAD}


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    """One flat survey per package (its objects cache is its own) and a
    nested copy for the partition-driven entry points."""
    root = tmp_path_factory.mktemp("zarrpred")
    out = {}
    for who in ("jax", "port"):
        out[who] = make_zarr_survey(root / who, year=2017, n_echograms=1,
                                    H=H, W=W, seed=SEED)
        out[who + "_nested"] = root / f"{who}_nested"
        make_zarr_survey(out[who + "_nested"], year=2017, n_echograms=1,
                         H=H, W=W, seed=SEED, layout="nested")
    return out


@pytest.fixture(scope="module")
def variables():
    model = jax_build_unet(CFG)
    v = model.init(jax.random.PRNGKey(6), jnp.zeros((1, 64, 64, 4)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(6)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return model, v


def _port_runner(v, cfg):
    return GriddedRunner(build_unet(cfg), flax_to_torch_state_dict(v), cfg,
                         device="cpu")


def _meta(store, name):
    with open(os.path.join(store, name, ".zarray")) as f:
        meta = json.load(f)
    with open(os.path.join(store, name, ".zattrs")) as f:
        return meta, json.load(f)


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


def _assert_stores_match(got_path, want_path, labels=False):
    got, want = ZGroup.open(got_path), JaxGroup.open(want_path)
    assert sorted(got.array_names()) == sorted(want.array_names())
    assert got.attrs == want.attrs
    for name in got.array_names():
        assert _meta(got_path, name) == _meta(want_path, name), name
    _assert_close_f16(got["annotation"][:], want["annotation"][:])
    for name in ("category", "range", "ping_time") + (
            ("labels",) if labels else ()):
        np.testing.assert_array_equal(got[name][:], want[name][:])
    with open(os.path.join(got_path, ".zmetadata")) as f:
        meta = json.load(f)["metadata"]
    assert meta["annotation/.zarray"]["shape"] == list(
        got["annotation"].shape)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("output", ["float16", "uint8"])
def test_predict_zarr_matches_jax(surveys, variables, tmp_path, transfer,
                                  output):
    model, v = variables
    cfg = dict(CFG, transfer_dtype=transfer, output_dtype=output)
    jax_save_zarr(JaxRunner(model, v, cfg), JaxReader(surveys["jax"]),
                  str(tmp_path / "jax.zarr"), PRELOAD)
    runner = _port_runner(v, cfg)
    save_survey_predictions_zarr(runner, DataReaderZarr(surveys["port"]),
                                 str(tmp_path / "port.zarr"), PRELOAD)
    _assert_stores_match(tmp_path / "port.zarr", tmp_path / "jax.zarr")
    assert ZGroup.open(tmp_path / "port.zarr")["annotation"].shape == \
        (2, W, H)
    # 2 chunks of 4 grid columns x 3 grid rows, fwd_batch 8 -> 2 x 8,
    # 4 of them pad
    px = cfg["patch_size"][0] * cfg["patch_size"][1]
    assert runner.timer.totals["n_fwd_px"] == 32 * px
    assert runner.timer.totals["n_pad_px"] == 8 * px
    assert runner.forwards == 4
    assert runner.timer.summary()["zarr_write"]["n"] == 2


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
def test_predict_zarr_save_labels_matches_jax(surveys, variables, tmp_path,
                                              transfer):
    """save_labels: the masked float32 labels array equals the JAX one."""
    model, v = variables
    cfg = dict(CFG, transfer_dtype=transfer)
    jax_save_zarr(JaxRunner(model, v, cfg), JaxReader(surveys["jax"]),
                  str(tmp_path / "jax.zarr"), PRELOAD, save_labels=True)
    save_survey_predictions_zarr(_port_runner(v, cfg),
                                 DataReaderZarr(surveys["port"]),
                                 str(tmp_path / "port.zarr"), PRELOAD,
                                 save_labels=True)
    _assert_stores_match(tmp_path / "port.zarr", tmp_path / "jax.zarr",
                         labels=True)
    lab = ZGroup.open(tmp_path / "port.zarr")["labels"]
    assert lab.dtype == np.float32 and (lab[:] > 0).any()


@pytest.mark.parametrize("zarr", [False, True])
def test_keep_row_bound_matches_jax(zarr):
    """The host's d2h crop bound under the memmap law and the zarr band
    law equals the JAX package's on random predicates and seabeds."""
    from crimac_unet_tpu.pipeline.predict import \
        _keep_row_bound as jax_bound
    from crimac_unet_tpu_torch.pipeline.predict import _keep_row_bound
    rng = np.random.RandomState(8)
    sh, o = 48, 8
    for nr, density in ((96, 0.2), (144, 0.02), (144, 0.0), (100, 0.9)):
        for _ in range(10):
            fin = rng.rand(nr, 64) < 0.9
            zero = rng.rand(nr, 64) > density
            sb = rng.randint(0, nr + 20, 64).astype(np.int64)
            sb[rng.rand(64) < 0.2] = 10 ** 7
            row_cut = int(rng.randint(nr // 2, nr + 1))
            assert _keep_row_bound(fin, zero, sb, row_cut, nr,
                                   (sh, o) if zarr else None) == \
                jax_bound(fin, zero, sb, row_cut, sh, o, zarr, nr)


def test_predict_reader_labels_follow_the_write_mask(surveys, variables):
    """save_labels yields each chunk's labels masked by the device write
    mask: nonzero only where a probability may be written, and every
    written pixel below the seabed band carries a label of 0."""
    _, v = variables
    runner = _port_runner(v, dict(CFG, transfer_dtype="float32"))
    reader = DataReaderZarr(surveys["port"])
    n = 0
    for s, e, out, lab in predict_reader(runner, reader, 80,
                                         save_labels=True):
        assert out.shape == (2, H, e - s) and lab.shape == (H, e - s)
        assert lab.dtype == np.float32
        raw = np.nan_to_num(reader.get_label_slice(s, e - s).T, nan=0.0)
        np.testing.assert_array_equal(lab[lab != 0], raw[lab != 0])
        n += int((lab != 0).sum())
    assert n > 0


def test_resume_after_truncation_equals_full_run(surveys, variables,
                                                  tmp_path):
    """A store holding only the first chunk, resumed, equals a full run."""
    _, v = variables
    runner = _port_runner(v, dict(CFG, transfer_dtype="float32"))
    reader = DataReaderZarr(surveys["port"])
    full = str(tmp_path / "full.zarr")
    save_survey_predictions_zarr(runner, reader, full, PRELOAD)
    part = str(tmp_path / "part.zarr")
    save_survey_predictions_zarr(runner, reader, part, PRELOAD)
    g = ZGroup.open(part)
    g["annotation"].resize([2, PRELOAD, H])
    g["ping_time"].resize([PRELOAD])
    save_survey_predictions_zarr(runner, reader, part, PRELOAD,
                                 resume_writing=True)
    a, b = ZGroup.open(part), ZGroup.open(full)
    for name in ("annotation", "ping_time"):
        np.testing.assert_array_equal(a[name][:], b[name][:])
    assert os.path.isfile(os.path.join(part, ".zmetadata"))


def test_crash_between_appends_resumes_identical(surveys, variables,
                                                 tmp_path, monkeypatch):
    """A crash between chunk 2's annotation append and its ping_time
    append leaves the arrays at different lengths and no consolidated
    snapshot; a resume truncates to the joint commit point and ends equal
    to an uninterrupted run."""
    _, v = variables
    runner = _port_runner(v, dict(CFG, transfer_dtype="float32"))
    reader = DataReaderZarr(surveys["port"])
    ref = str(tmp_path / "ref.zarr")
    save_survey_predictions_zarr(runner, reader, ref, 60)

    class _Crash(RuntimeError):
        pass

    orig_append = port_zl.ZArray.append
    state = {"ann": 0}

    def flaky_append(self, value, axis=0):
        if self.path.name == "annotation":
            state["ann"] += 1
        if self.path.name == "ping_time" and state["ann"] == 2:
            raise _Crash()
        return orig_append(self, value, axis)

    target = str(tmp_path / "crash.zarr")
    monkeypatch.setattr(port_zl.ZArray, "append", flaky_append)
    with pytest.raises(_Crash):
        save_survey_predictions_zarr(runner, reader, target, 60)
    monkeypatch.setattr(port_zl.ZArray, "append", orig_append)
    crashed = ZGroup.open(target)
    assert crashed["annotation"].shape[1] > crashed["ping_time"].shape[0]
    assert not os.path.isfile(os.path.join(target, ".zmetadata"))
    save_survey_predictions_zarr(runner, reader, target, 60,
                                 resume_writing=True)
    got, want = ZGroup.open(target), ZGroup.open(ref)
    for name in ("annotation", "ping_time"):
        np.testing.assert_array_equal(got[name][:], want[name][:])
    assert os.path.isfile(os.path.join(target, ".zmetadata"))


def test_resume_missing_store_starts_fresh(surveys, variables, tmp_path):
    _, v = variables
    runner = _port_runner(v, dict(CFG, transfer_dtype="float32"))
    reader = DataReaderZarr(surveys["port"])
    fresh, resumed = str(tmp_path / "a.zarr"), str(tmp_path / "b.zarr")
    save_survey_predictions_zarr(runner, reader, fresh, PRELOAD)
    save_survey_predictions_zarr(runner, reader, resumed, PRELOAD,
                                 resume_writing=True)
    for name in ("annotation", "ping_time"):
        np.testing.assert_array_equal(ZGroup.open(fresh)[name][:],
                                      ZGroup.open(resumed)[name][:])


def test_resume_label_mismatches_raise(surveys, variables, tmp_path):
    """Resuming with a save_labels flag the store disagrees with, or over
    a float16 labels array, raises before anything is written."""
    _, v = variables
    runner = _port_runner(v, dict(CFG, transfer_dtype="float32"))
    reader = DataReaderZarr(surveys["port"])
    no_labels = str(tmp_path / "nolab.zarr")
    save_survey_predictions_zarr(runner, reader, no_labels, PRELOAD)
    with pytest.raises(ValueError, match="no 'labels' array"):
        save_survey_predictions_zarr(runner, reader, no_labels, PRELOAD,
                                     resume_writing=True, save_labels=True)
    with_labels = str(tmp_path / "lab.zarr")
    save_survey_predictions_zarr(runner, reader, with_labels, PRELOAD,
                                 save_labels=True)
    with pytest.raises(ValueError, match="pass save_labels=True"):
        save_survey_predictions_zarr(runner, reader, with_labels, PRELOAD,
                                     resume_writing=True)
    old = ZGroup.open(with_labels)["labels"][:]
    shutil.rmtree(os.path.join(with_labels, "labels"))
    ZGroup.open(with_labels).create_array(
        "labels", (0, H), (PRELOAD, H), np.float16, fill_value=0,
        dims=["ping_time", "range"]).append(old.astype(np.float16), axis=0)
    with pytest.raises(ValueError, match="float16"):
        save_survey_predictions_zarr(runner, reader, with_labels, PRELOAD,
                                     resume_writing=True, save_labels=True)


def _yaml(tmp_path, cfg):
    import yaml
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_save_predict_cli_zarr_matches_jax(surveys, variables, tmp_path):
    """``save_predict`` with ``data_mode: zarr`` on a nested survey root:
    the port's CLI writes the JAX CLI's ``<survey>_pred.zarr``."""
    from crimac_unet_tpu.pipeline.save_predict import main as jax_main
    from crimac_unet_tpu_torch.pipeline.save_predict import main
    _, v = variables
    ckpt = tmp_path / "model.pt"
    save_torch_checkpoint(v, ckpt)
    stores = {}
    for who, run in (("jax", jax_main), ("port", main)):
        cfg = dict(CFG, data_mode="zarr", save_prediction_surveys=[2017],
                   path_to_zarr_files=str(surveys[who + "_nested"]),
                   transfer_dtype="float32", random_seed=3,
                   save_labels=True)
        (tmp_path / who).mkdir()
        args = ["--yaml_path", str(_yaml(tmp_path / who, cfg)),
                "--checkpoint_path", str(ckpt),
                "--save_predictions_path", str(tmp_path / who / "out")]
        run(args + (["--device", "cpu"] if who == "port" else []))
        stores[who] = tmp_path / who / "out" / "S2017843_pred.zarr"
    assert os.listdir(tmp_path / "port" / "out") == ["S2017843_pred.zarr"]
    _assert_stores_match(stores["port"], stores["jax"], labels=True)
    assert ZGroup.open(stores["port"]).attrs["description"] == \
        "cfg predictions"


def _hz_copy(src, dst):
    """A copy of a flat survey whose frequency coordinate is in Hz, as
    production stores carry it."""
    shutil.copytree(os.path.dirname(src), dst)
    sv = os.path.join(dst, os.path.basename(src))
    freq = port_zl.ZGroup.open(sv)["frequency"]
    freq[:] = freq[:] * 1000
    return sv


@pytest.mark.parametrize("save_labels", [None, True])
def test_docker_entry_matches_jax(surveys, variables, tmp_path, monkeypatch,
                                  save_labels):
    """The docker entry through MODELWEIGHTS / SURVEY_PATH / CONFIG_PATH /
    OUTPUT_DIR / PRED_FILE on the same ``.pt``: the kHz config reads the
    Hz store, and ``save_labels`` applies only when the YAML sets it."""
    from crimac_unet_tpu.pipeline import dockerscript as jax_docker
    from crimac_unet_tpu_torch.pipeline import dockerscript
    _, v = variables
    ckpt = tmp_path / "model.pt"
    save_torch_checkpoint(v, ckpt)
    cfg = dict(CFG, transfer_dtype="float32", device="cpu")
    if save_labels is not None:
        cfg["save_labels"] = save_labels
    monkeypatch.setenv("MODELWEIGHTS", str(ckpt))
    monkeypatch.setenv("CONFIG_PATH", str(_yaml(tmp_path, cfg)))
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    for who, entry in (("jax", jax_docker), ("port", dockerscript)):
        monkeypatch.setenv("SURVEY_PATH",
                           _hz_copy(surveys[who], tmp_path / f"{who}_in"))
        monkeypatch.setenv("PRED_FILE", f"{who}.zarr")
        entry.main()
    _assert_stores_match(tmp_path / "port.zarr", tmp_path / "jax.zarr",
                         labels=bool(save_labels))
    assert ("labels" in ZGroup.open(tmp_path / "port.zarr")) == \
        bool(save_labels)
    assert ZGroup.open(tmp_path / "port.zarr").attrs["description"] == \
        "docker predictions"
