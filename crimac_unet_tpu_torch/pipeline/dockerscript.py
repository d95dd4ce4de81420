"""Docker/production entry point of the port.

    python -m crimac_unet_tpu_torch.pipeline.dockerscript

Honours the reference container contract (crimac_unet/dockerscript.py:1-82),
as the JAX package's ``crimac_unet_tpu/pipeline/dockerscript.py`` does:

    env MODEL    -> /model/<MODEL>            checkpoint (.pt or .msgpack)
    env SURVEY   -> /datain/<SURVEY>/ACOUSTIC/GRIDDED/<SURVEY>_sv.zarr
    env CONFIG   -> /configs/<CONFIG>         yaml config
    env ZARRFILE -> /dataout/<ZARRFILE>       prediction store

with the config's kHz frequencies converted to Hz for zarr survey data
(dockerscript.py:58-60).  Generalized overrides for non-container use:
MODELWEIGHTS / SURVEY_PATH / CONFIG_PATH / OUTPUT_DIR / PRED_FILE.  With
no config file the defaults apply (the flagship U-Net at the baseline
geometry, ``config.CONFIG_DEFAULTS``) and no ``yaml`` is needed.  It runs
on ``cuda`` unless the config sets ``device``.
"""

from __future__ import annotations

import json
import os
import time

from ..config import load_yaml_config, parse_config_options
from ..data import blosc_codec
from ..data.zarr_reader import DataReaderZarr
from ..models import build_model
from ..models.weights import load_checkpoint
from ..ops import cuda_lib
from ..parallel.mesh import init_distributed
from ..utils.general import fix_seeds
from .predict import save_survey_predictions_zarr
from .runner import GriddedRunner, resolve_device
from .save_predict import should_save_labels


def resolve_paths() -> dict:
    """Reference mount-point layout with generalized overrides."""
    if os.environ.get("MODELWEIGHTS"):
        return {
            "model": os.environ["MODELWEIGHTS"],
            "sv": os.environ["SURVEY_PATH"],
            "config": os.environ.get("CONFIG_PATH"),
            "target": os.path.join(os.environ.get("OUTPUT_DIR", "."),
                                   os.environ.get("PRED_FILE",
                                                  "predictions.zarr")),
        }
    survey = os.environ["SURVEY"]
    return {
        "model": os.path.join("/model", os.environ["MODEL"]),
        "sv": os.path.join("/datain", survey, "ACOUSTIC", "GRIDDED",
                           f"{survey}_sv.zarr"),
        "config": os.path.join("/configs", os.environ["CONFIG"]),
        "target": os.path.join("/dataout", os.environ["ZARRFILE"]),
    }


def main():
    start = time.time()
    paths = resolve_paths()
    print("Files:")
    for k, v in paths.items():
        print(f"  {k}: {v}")

    # `or {}` twice: an unset config path and an empty/comments-only YAML
    # (safe_load returns None) are both legal all-defaults configs
    raw_yaml = (load_yaml_config(paths["config"]) or {}) \
        if paths["config"] else {}
    config = parse_config_options(raw_yaml, None)
    fix_seeds(config["random_seed"])

    reader = DataReaderZarr(paths["sv"])
    print(f"Blosc codec backend: {blosc_codec.backend()}; survey store "
          f"compressor: {reader.sv.compressor}")
    # zarr production data stores Hz; configs use kHz (dockerscript.py:58-60)
    # — the len guard keeps an empty frequency coordinate from vacuously
    # triggering the conversion and masking the real error
    if len(reader.frequencies) and all(f > 10000
                                       for f in reader.frequencies):
        config["frequencies"] = [f * 1000 for f in config["frequencies"]]

    init_distributed(device=resolve_device(config.get("device")))
    runner = GriddedRunner(build_model(config),
                           load_checkpoint(paths["model"]), config,
                           device=config.get("device"))

    # container output contract: the reference dockerscript writes only
    # predictions.  save_labels defaults True in the shared config schema,
    # so it is honoured only when the YAML sets the key explicitly — an
    # implicit default must not grow the production store an extra array
    save_labels = ("save_labels" in raw_yaml
                   and should_save_labels(config, reader))
    save_survey_predictions_zarr(
        runner, reader, paths["target"],
        preload_n_pings=config["preload_n_pings"],
        resume_writing=config["resume_writing"],
        model_name="docker", progress=True,
        save_labels=save_labels)
    print(runner.timer.report())
    # which kernels carried the run, and whether this process had to
    # build them (an image ships them prebuilt: Dockerfile.torch)
    print(f"Kernel launches: {json.dumps(cuda_lib.launches)}")
    print(f"U-Net forwards: {runner.forwards}; kernel library "
          f"{cuda_lib.library_path()}, built by this process: "
          f"{'yes' if cuda_lib.build_log else 'no'}")
    print(f"Executed time (hours): {(time.time() - start) / 3600:.2f}")
    return runner


if __name__ == "__main__":
    main()
