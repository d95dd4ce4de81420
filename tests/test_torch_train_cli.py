"""The port's training entry points on the CPU (``device: cpu``).

``run_training`` and the ``train`` CLI at a tiny size (depth 3,
start_filts 8, patch 64) on synthetic memmap surveys: best and last
checkpoints with their sidecars, resume continuing the step count, the
overwrite protection, the device pool on and off giving the same
training, and the configurations this slice does not train raising
``NotImplementedError`` naming ROADMAP A1b or A3.  The JAX package loads
the port's ``best.msgpack`` for serving.
"""

import json

import numpy as np
import pytest
import torch

from crimac_unet_tpu.pipeline import engine as jax_engine
from crimac_unet_tpu_torch.config import (META_CHANNELS_ALL,
                                         parse_config_options)
from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
from crimac_unet_tpu_torch.pipeline import train
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet


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


@pytest.mark.parametrize("change,item", [
    ({"data_mode": "zarr"}, "A1b"),
    ({"meta_channels": META_CHANNELS_ALL}, "A1b"),
    ({"late_meta_inject": True}, "A1b"),
    ({"mesh_devices": 2}, "A3")])
def test_untrained_configs_raise(survey, tmp_path, change, item):
    with pytest.raises(NotImplementedError, match=item):
        train.run_training(_cfg(survey, **change), tmp_path / "ck",
                           progress=False)


def test_train_entry_raises_without_cuda(survey, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run_training(_cfg(survey, device=None), tmp_path / "ck",
                           progress=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegPipeUNet(_cfg(survey, device=None))
