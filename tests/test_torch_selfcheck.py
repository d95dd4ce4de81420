"""The port's deployment surface on the CPU: the selfcheck CLI
(crimac_unet_tpu_torch/selfcheck.py), the import facade
(pipeline/inference.py) against the JAX package's, the AOT deployment
example and the profiler hook of the save_predict CLI."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import crimac_unet_tpu.pipeline.inference as jax_inference
from crimac_unet_tpu_torch import selfcheck
from crimac_unet_tpu_torch.pipeline import inference

REPO = Path(__file__).resolve().parent.parent


def _run(module, args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", module, *args],
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=600)


def test_selfcheck_cli_skip_device(tmp_path):
    """--skip-device passes on this box and reports every required line
    (the lines tests/test_cli.py asks of the JAX selfcheck)."""
    proc = _run("crimac_unet_tpu_torch.selfcheck", ["--skip-device"],
                tmp_path)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr[-3000:]
    assert "SELFCHECK PASSED" in out
    for name in ("python", "torch", "torch cuda", "numpy", "blosc backend",
                 "zarr store", "zarr reopen", "end-to-end predict",
                 "school detection (store)"):
        assert f"] {name} " in out, (name, out)
    assert "[FAIL]" not in out
    assert "on cpu" in out


def test_selfcheck_without_a_card_fails(monkeypatch, capsys):
    """Without --skip-device and without a card the device line fails and
    the exit code is 1: the check never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert selfcheck.main([]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] device" in out
    assert "[FAIL] end-to-end predict" in out
    assert "CUDA is not available" in out
    assert "SELFCHECK FAILED" in out


def test_inference_facade_names():
    """Every name the JAX facade re-exports is re-exported by the port's,
    except _net_db_input (ops.data_ops.net_db_input in the port), and the
    names are the implementing modules' own objects."""
    from crimac_unet_tpu_torch.pipeline import (eval_gridded, predict,
                                                runner)
    jax_names = {n for n in vars(jax_inference) if not n.startswith("__")
                 and n not in ("annotations",)}
    jax_names = {n for n in jax_names
                 if not isinstance(getattr(jax_inference, n),
                                   type(sys))}
    missing = jax_names - set(vars(inference))
    assert missing == {"_net_db_input"}, missing
    assert "_net_db_input" in inference.__doc__
    assert set(inference.__all__) == set(jax_inference.__all__)
    assert inference.GriddedRunner is runner.GriddedRunner
    assert inference.predict_reader is predict.predict_reader
    assert inference.evaluate_reader is eval_gridded.evaluate_reader


def test_aot_deployment_example_on_cpu():
    from crimac_unet_tpu_torch.examples.example_aot_deployment import main
    probs = main(["--device", "cpu"])
    assert probs.shape == (1, 128, 256, 3) and np.isfinite(probs).all()


def test_save_predict_cli_writes_a_profiler_trace(tmp_path, monkeypatch):
    """CRIMAC_PROFILE_DIR wraps the save_predict CLI's run in
    utils.profiling.device_trace: one chrome trace of the run."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.models.unet import UNet
    from crimac_unet_tpu_torch.pipeline.save_predict import main
    make_survey_dir(tmp_path / "memm", year=2017, n_echograms=1, H=64,
                    W=96, seed=1)
    torch.save(UNet(depth=2, start_filts=4).state_dict(), tmp_path / "m.pt")
    (tmp_path / "c.yaml").write_text(
        "depth: 2\nstart_filts: 4\ncompute_dtype: float32\n"
        "patch_size: [32, 32]\npatch_overlap: 4\n"
        "save_prediction_surveys: [2017]\n"
        f"path_to_echograms: {tmp_path / 'memm'}\n")
    monkeypatch.setenv("CRIMAC_PROFILE_DIR", str(tmp_path / "prof"))
    main(["--yaml_path", str(tmp_path / "c.yaml"), "--checkpoint_path",
          str(tmp_path / "m.pt"), "--save_predictions_path",
          str(tmp_path / "out"), "--device", "cpu"])
    assert len(list((tmp_path / "out").glob("*_pred.npy"))) == 1
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json.gz"))) == 1


@pytest.mark.parametrize("module", ["crimac_unet_tpu_torch.selfcheck",
                                    "crimac_unet_tpu_torch.pipeline.export"])
def test_new_cli_help(module, tmp_path):
    proc = _run(module, ["--help"], tmp_path)
    assert proc.returncode == 0 and "usage" in proc.stdout
