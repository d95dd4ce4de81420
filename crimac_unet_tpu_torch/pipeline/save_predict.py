"""Prediction-saving entry point of the port.

    python -m crimac_unet_tpu_torch.pipeline.save_predict --yaml_path ... \
        --checkpoint_path model.pt --save_predictions_path ... [--device cpu]

Reference surface (pipeline_train_predict/save_predict.py:268-330): per
``save_prediction_surveys`` survey, sliding-window softmax predictions
written per reader as ``<name>_pred.zarr`` (``data_mode: zarr``,
resume/append supported) or ``<name>_pred.npy`` (``data_mode: memm``).
"""

from __future__ import annotations

import os
from pathlib import Path

from ..config import (get_argparse_parser, load_yaml_config,
                      parse_config_options)
from ..data.partition import make_partition
from ..models import build_model
from ..models.weights import load_checkpoint
from ..parallel.mesh import init_distributed
from ..utils.general import fix_seeds
from .predict import (save_reader_predictions_memm,
                      save_survey_predictions_zarr, survey_static_grid)
from .runner import GriddedRunner, resolve_device


def run_save_predictions(config, runner, data_obj, predictions_dir,
                         progress=False):
    """Predict every reader of each ``save_prediction_surveys`` year into
    ``predictions_dir``.  Readers come from ``data_obj``, the data
    partition of ``config['data_mode']`` (``make_partition``)."""
    if not config.get("save_prediction_surveys"):
        print("WARNING: save_prediction_surveys is empty — nothing to "
              "predict; set it in the YAML (year numbers, e.g. [2017])")
        return
    for survey in config["save_prediction_surveys"]:
        readers = data_obj.get_survey_readers(survey)
        print(f"Saving predictions for survey {survey}, "
              f"{len(readers)} data reader(s)")
        fixed_R, fixed_C = survey_static_grid(runner, readers,
                                              config["preload_n_pings"])
        for reader in readers:
            if config["data_mode"] == "memm":
                save_reader_predictions_memm(
                    runner, reader,
                    os.path.join(predictions_dir, reader.name + "_pred.npy"),
                    preload_n_pings=config["preload_n_pings"],
                    resume_writing=config["resume_writing"],
                    progress=progress, fixed_R=fixed_R, fixed_C=fixed_C)
            else:
                save_survey_predictions_zarr(
                    runner, reader,
                    os.path.join(predictions_dir, reader.name + "_pred.zarr"),
                    preload_n_pings=config["preload_n_pings"],
                    resume_writing=config["resume_writing"],
                    model_name=runner_model_name(config),
                    progress=progress,
                    save_labels=should_save_labels(config, reader),
                    fixed_R=fixed_R, fixed_C=fixed_C)


def should_save_labels(config, reader) -> bool:
    """save_labels gating shared by the CLI and docker entries: the
    config must ask for it, labels must be declared available, and a zarr
    reader must actually carry an annotation store — a production mount
    shipping only _sv.zarr would otherwise emit an all-background
    'labels' array that reads as real annotation."""
    if not (config.get("save_labels")
            and config.get("labels_available", True)):
        return False
    if reader.data_format == "zarr" and \
            getattr(reader, "annotation", None) is None:
        print(f"{reader.name}: no labels store — skipping save_labels")
        return False
    return True


def runner_model_name(config):
    return Path(config["yaml_path"]).stem if "yaml_path" in config else \
        "model"


def main(argv=None):
    args = get_argparse_parser("save_predict").parse_args(argv)
    configuration = load_yaml_config(args.yaml_path)
    config = parse_config_options(configuration, args)

    predictions_dir = str(config["save_predictions_path"])
    os.makedirs(predictions_dir, exist_ok=True)

    fix_seeds(config["random_seed"])
    # under torchrun every rank joins; mesh_devices (0 = all) shares the
    # device work and rank 0 writes
    init_distributed(device=resolve_device(config.get("device")))
    state_dict = load_checkpoint(config["checkpoint_path"])
    runner = GriddedRunner(build_model(config), state_dict, config,
                           device=config.get("device"))
    data_obj = make_partition(config)
    # a torch.profiler trace of the run when CRIMAC_PROFILE_DIR is set,
    # with the runner's phases as spans beside the device's rows
    from ..utils.profiling import device_trace
    with device_trace(timer=runner.timer) as trace_dir:
        run_save_predictions(config, runner, data_obj, predictions_dir,
                             progress=True)
    if trace_dir:
        print(f"profiler trace written to {trace_dir}")
    print(runner.timer.report())


if __name__ == "__main__":
    main()
