"""Preamble of the checkpoint-consuming CLIs, ``evaluate`` and
``school_eval`` (argparse -> YAML merge -> seed -> checkpoint ->
model/runner -> partition -> output directories named after the
checkpoint's run), as the JAX package's
``crimac_unet_tpu/pipeline/cli_common.py``."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path


@dataclass
class EvalContext:
    config: dict
    experiment_name: str
    run_id: str
    runner: object
    data_obj: object
    metrics_dir: str | None
    plot_dir: str | None


def checkpoint_run_id(checkpoint_path) -> str:
    """Output-directory component for a checkpoint: its parent directory
    name (the training run's timestamp), falling back to the file stem for
    a bare filename (reference evaluate.py derives the same nesting from
    its checkpoint_dir layout)."""
    parts = os.path.normpath(str(checkpoint_path)).split(os.path.sep)
    if len(parts) >= 2 and parts[-2]:
        return parts[-2]
    return os.path.splitext(parts[-1])[0]


def load_eval_context(mode: str, argv=None, want_plots: bool = False,
                      need_runner=True) -> EvalContext:
    """Parse the ``mode`` flag set (``config.get_argparse_parser``: the
    CLIs pass ``eval``), load the checkpoint
    into a GriddedRunner on ``config['device']`` (cuda when absent),
    build the data partition and create the per-run metrics (and, with
    ``want_plots``, plot) directories.

    ``need_runner`` is a bool or a ``callable(config) -> bool`` decided
    after the YAML merge: when False no checkpoint is loaded, no model is
    built, no device is touched and ``ctx.runner`` is None (school_eval's
    from-predictions mode)."""
    from ..config import (get_argparse_parser, load_yaml_config,
                          parse_config_options)
    from ..data.partition import make_partition
    from ..utils.general import fix_seeds

    args = get_argparse_parser(mode).parse_args(argv)
    config = parse_config_options(load_yaml_config(args.yaml_path), args)
    experiment_name = Path(config["yaml_path"]).stem

    fix_seeds(config["random_seed"])
    if callable(need_runner):
        need_runner = bool(need_runner(config))
    runner = None
    if need_runner:
        from ..models import build_model
        from ..models.weights import load_checkpoint
        from ..parallel.mesh import init_distributed
        from .runner import GriddedRunner, resolve_device
        init_distributed(device=resolve_device(config.get("device")))
        runner = GriddedRunner(build_model(config),
                               load_checkpoint(config["checkpoint_path"]),
                               config, device=config.get("device"))

    print(f'\nLoading {config["data_mode"]} data partition object...')
    start = time.time()
    data_obj = make_partition(config)
    print("Executed time for loading data partition object (min):"
          f" {round((time.time() - start) / 60, 2)}")

    run_id = checkpoint_run_id(config["checkpoint_path"])
    metrics_dir = plot_dir = None
    if config.get("save_path_metrics") is not None:
        metrics_dir = os.path.join(str(config["save_path_metrics"]),
                                   experiment_name, run_id)
        os.makedirs(metrics_dir, exist_ok=True)
        print("Metrics directory:", metrics_dir)
    if want_plots and config.get("save_path_plot") is not None:
        plot_dir = os.path.join(str(config["save_path_plot"]),
                                experiment_name, run_id)
        os.makedirs(plot_dir, exist_ok=True)
        print("Plot directory:", plot_dir, "\n")

    return EvalContext(config=config, experiment_name=experiment_name,
                       run_id=run_id, runner=runner, data_obj=data_obj,
                       metrics_dir=metrics_dir, plot_dir=plot_dir)
