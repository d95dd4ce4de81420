"""Prediction-saving entry point of the port (memmap surveys).

    python -m crimac_unet_tpu_torch.pipeline.save_predict --yaml_path ... \
        --checkpoint_path model.pt --save_predictions_path ... [--device cpu]

Reference surface (pipeline_train_predict/save_predict.py:268-330): per
``save_prediction_surveys`` survey, sliding-window softmax predictions
written per echogram as ``<name>_pred.npy``.  The zarr store path
(``data_mode: zarr``) is not ported yet.
"""

from __future__ import annotations

import os

from ..config import (get_argparse_parser, load_yaml_config,
                      parse_config_options)
from ..data.memmap_reader import get_echograms
from ..models.unet import build_unet
from ..models.weights import load_checkpoint
from ..utils.general import fix_seeds
from .predict import save_reader_predictions_memm
from .runner import GriddedRunner


def run_save_predictions(config, runner, predictions_dir, progress=False,
                         path_to_echograms=None):
    """Predict every echogram of each ``save_prediction_surveys`` year into
    ``predictions_dir``.  Echograms are discovered under
    ``path_to_echograms`` (default: ``setpyenv.json``), with the same
    filters as the JAX package's memmap partition."""
    if config["data_mode"] != "memm":
        raise NotImplementedError(
            "data_mode 'zarr' is not ported yet (ROADMAP.md queue A: "
            "zarr I/O and save_survey_predictions_zarr/dockerscript)")
    if not config.get("save_prediction_surveys"):
        print("WARNING: save_prediction_surveys is empty — nothing to "
              "predict; set it in the YAML (year numbers, e.g. [2017])")
        return
    for survey in config["save_prediction_surveys"]:
        readers = get_echograms(
            years=[survey], path_to_echograms=path_to_echograms,
            frequencies=sorted(config["frequencies"]),
            minimum_shape=config["patch_size"][0])
        print(f"Saving predictions for survey {survey}, "
              f"{len(readers)} data reader(s)")
        for reader in readers:
            target = os.path.join(predictions_dir, reader.name + "_pred.npy")
            save_reader_predictions_memm(
                runner, reader, target,
                preload_n_pings=config["preload_n_pings"],
                resume_writing=config["resume_writing"], progress=progress)


def main(argv=None):
    args = get_argparse_parser("save_predict").parse_args(argv)
    configuration = load_yaml_config(args.yaml_path)
    config = parse_config_options(configuration, args)

    predictions_dir = str(config["save_predictions_path"])
    os.makedirs(predictions_dir, exist_ok=True)

    fix_seeds(config["random_seed"])
    state_dict = load_checkpoint(config["checkpoint_path"])
    runner = GriddedRunner(build_unet(config), state_dict, config,
                           device=config.get("device"))
    run_save_predictions(config, runner, predictions_dir, progress=True)
    print(runner.timer.report())


if __name__ == "__main__":
    main()
