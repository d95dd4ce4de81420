"""The port's training entry points on the CPU (``device: cpu``).

``run_training`` and the ``train`` CLI at a tiny size (depth 3,
start_filts 8, patch 64) on synthetic memmap surveys: best and last
checkpoints with their sidecars, resume continuing the step count, the
overwrite protection, the device pool on and off giving the same
training.  Zarr surveys (pooled and from host crops, the same training)
and metadata channels (early and late inject, pooled and from host
crops) at depth 2, start_filts 4, patch 32.  What the port refuses:
metadata on zarr surveys (``ValueError``, memmap-only) and a mesh of more
devices than the process group holds (``ValueError`` from ``get_mesh``).  The JAX package
loads the port's ``best.msgpack`` for serving.
"""

import json

import numpy as np
import pytest
import torch

from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu_torch.config import (META_CHANNELS_ALL,
                                         parse_config_options)
from crimac_unet_tpu_torch.data.fixtures import (make_survey_dir,
                                                 make_zarr_survey)
from crimac_unet_tpu_torch.pipeline import train
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet


@pytest.fixture(scope="module")
def zarr_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli_zarr")
    make_zarr_survey(root, year=2017, n_echograms=2, H=100, W=200, seed=41,
                     n_schools=4, layout="nested")
    make_zarr_survey(root, year=2016, n_echograms=1, H=100, W=200, seed=42,
                     n_schools=4, layout="nested")
    return root


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    make_survey_dir(root, year=2017, n_echograms=2, H=150, W=400, seed=41,
                    n_schools=4)
    make_survey_dir(root, year=2016, n_echograms=1, H=150, W=300, seed=42,
                    n_schools=4)
    return root


def _cfg(survey, **kw):
    return parse_config_options(dict({
        "path_to_echograms": str(survey), "patch_size": [64, 64],
        "depth": 3, "start_filts": 8, "batch_size": 4, "iterations": 8,
        "test_iter": 2, "log_step": 4, "lr_step": 4, "checkpoint_every": 4,
        "train_surveys": [2017], "validation_surveys": [2016],
        "num_workers": 2, "device": "cpu", "train_dtype": "float32"}, **kw))


class _Logger:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step):
        self.rows.append((tag, float(value), int(global_step)))


def test_run_training_writes_best_and_last_and_resumes(survey, tmp_path):
    log = _Logger()
    ck = tmp_path / "ck"
    sp = train.run_training(_cfg(survey), ck, logger=log, progress=False)
    assert sp.state.step == 8
    for name in ("best.msgpack", "last.msgpack"):
        assert (ck / name).is_file()
        side = json.loads((ck / (name + ".json")).read_text())
        assert side["best_f1"] == pytest.approx(sp.best_F1_val)
    losses = [v for t, v, _ in log.rows if t == "train/loss"]
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert [s for t, _, s in log.rows if t == "test/F1_score"] == [4, 8]
    assert [v for t, v, _ in log.rows if t == "learning_rate_0"] == \
        [0.0025, 0.00125]
    # the JAX package serves the port's best checkpoint
    payload = jax_engine.load_checkpoint(ck / "best.msgpack")
    assert set(payload) == {"params", "batch_stats", "opt_state", "step"}

    # resume: the step count continues to the configured iterations
    sp2 = train.run_training(
        _cfg(survey, iterations=12, resume_checkpoint=str(ck /
                                                          "last.msgpack")),
        ck, progress=False)
    assert sp2.state.step == 12
    assert sp2.best_F1_val >= sp.best_F1_val

    # a fresh run into the same directory refuses to overwrite it
    with pytest.raises(FileExistsError):
        train.run_training(_cfg(survey), ck, progress=False)


def test_pool_and_host_crops_train_alike(survey, tmp_path):
    """The device pool ships coordinates, the host path crops: the same
    draws, the same crops, so the same weights after training."""
    nets = []
    for mode in (True, False):
        sp = train.run_training(
            _cfg(survey, use_device_pool=mode, iterations=4, log_step=4,
                 num_workers=1),
            tmp_path / f"ck_{mode}", progress=False)
        assert (sp.pool is not None) == mode
        nets.append(sp.model.state_dict())
    for k in nets[0]:
        assert torch.equal(nets[0][k], nets[1][k]), k


def test_train_cli_main(survey, tmp_path, monkeypatch):
    cfg = {k: v for k, v in _cfg(survey).items()
           if k not in ("yaml_path", "device")}
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(json.dumps(cfg))     # JSON is YAML
    monkeypatch.chdir(tmp_path)
    train.main(["--yaml_path", str(yaml_path), "--device", "cpu"])
    (run,) = (tmp_path / "saved_models" / "tiny").iterdir()
    assert {p.name for p in run.iterdir()} >= {"best.msgpack",
                                               "last.msgpack"}


def _small(**kw):
    return _cfg(None, **dict({"patch_size": [32, 32], "depth": 2,
                              "start_filts": 4, "batch_size": 2,
                              "iterations": 4, "log_step": 2, "lr_step": 2,
                              "checkpoint_every": 0, "num_workers": 1},
                             **kw))


def test_zarr_training_pool_and_host_crops_train_alike(zarr_root, tmp_path):
    """Zarr surveys: ZarrSamplePool for train and validation, or host
    crops; the same draws and crops, so the same weights."""
    nets = []
    for mode in (True, False):
        ck = tmp_path / f"ck_{mode}"
        sp = train.run_training(
            _small(data_mode="zarr", path_to_zarr_files=str(zarr_root),
                   use_device_pool=mode), ck, progress=False)
        assert sp.state.step == 4
        assert (type(sp.pool).__name__ if mode else sp.pool) == \
            ("ZarrSamplePool" if mode else None)
        assert (sp.pool_val is not None) == mode
        assert {p.name for p in ck.iterdir()} >= {"best.msgpack",
                                                 "last.msgpack"}
        nets.append(sp.model.state_dict())
    for k in nets[0]:
        assert torch.equal(nets[0][k], nets[1][k]), k


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("pooled", [True, False])
def test_meta_training_runs(survey, tmp_path, late, pooled):
    log = _Logger()
    ck = tmp_path / "ck"
    sp = train.run_training(
        _small(path_to_echograms=str(survey),
               meta_channels=META_CHANNELS_ALL, late_meta_inject=late,
               use_device_pool=pooled), ck, logger=log, progress=False)
    assert sp.state.step == 4
    assert (sp.pool is not None) == pooled
    if pooled:
        assert sp.pool.meta_flags == sp.pool_val.meta_flags and \
            len(sp.pool.meta_flags) == 6
    losses = [v for t, v, _ in log.rows if t == "train/loss"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    payload = jax_engine.load_checkpoint(ck / "best.msgpack")
    assert ("meta_mlp" in payload["params"]) == late
    assert payload["params"]["down0"]["unit1"]["conv"]["kernel"].shape[2] \
        == (4 if late else 11)


@pytest.mark.parametrize("change,exc,match", [
    ({"data_mode": "zarr", "meta_channels": META_CHANNELS_ALL,
      "use_device_pool": "auto"}, ValueError, "memmap-only"),
    ({"data_mode": "zarr", "meta_channels": META_CHANNELS_ALL,
      "use_device_pool": True}, ValueError, "cannot pool"),
    ({"mesh_devices": 2}, ValueError, r"get_mesh\(2\) but only 1 process")])
def test_untrained_configs_raise(zarr_root, tmp_path, change, exc, match):
    with pytest.raises(exc, match=match):
        train.run_training(_small(path_to_zarr_files=str(zarr_root),
                                  **change), tmp_path / "ck",
                           progress=False)


def test_train_entry_raises_without_cuda(survey, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run_training(_cfg(survey, device=None), tmp_path / "ck",
                           progress=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegPipeUNet(_cfg(survey, device=None))
