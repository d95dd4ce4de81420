"""Config system: YAML file merged with argparse overrides (argparse wins).

Mirrors the reference public surface (crimac_unet/utils/general.py:33-144):
``load_yaml_config``, per-mode ``get_argparse_parser`` with the same flag
names, and ``parse_config_options`` shallow-merge semantics, plus TPU-only
extensions (mesh size, compute dtype) with safe defaults so reference YAML
files work unmodified.
"""

from __future__ import annotations

import argparse
from pathlib import Path

# Defaults applied for keys a YAML may omit.  Values mirror
# crimac_unet/configs/config_baseline.yaml:1-74.
CONFIG_DEFAULTS = {
    "random_seed": 10,
    "frequencies": [18, 38, 120, 200],
    "data_mode": "memm",
    "num_workers": 4,
    "patch_size": [256, 256],
    "meta_channels": [],
    "late_meta_inject": False,
    "loss_type": "CE",
    "batch_size": 4,
    "lr": 0.005,
    "lr_reduction": 0.5,
    "momentum": 0.95,
    "test_iter": 1000,
    "log_step": 2500,
    "lr_step": 1000,
    "iterations": 15000,
    "partition_train": "selected surveys",
    # the baseline YAML's survey lists (config_baseline.yaml:26-27) —
    # empty defaults made a YAML omitting these keys select ZERO readers
    "train_surveys": [2011, 2013, 2014, 2015, 2016],
    "validation_surveys": [2017],
    "save_model_params": True,
    "eval_mode": "all",
    "partition_predict": "all surveys",
    "evaluation_surveys": [],
    "labels_available": True,
    "patch_overlap": 20,
    "preload_n_pings": 1000,
    "save_prediction_surveys": [],
    "resume_writing": False,
    "save_labels": True,
    # --- TPU-native extensions (not in the reference YAML) ---
    "mesh_devices": 0,           # 0 = all visible devices
    "compute_dtype": "bfloat16",  # dtype of conv compute; params stay float32
    # bf16 conv compute with f32 master params + f32 loss: measured
    # 1.19-1.24x faster per step AND end-to-end on the full reference
    # recipe with best-F1 parity (f32 0.7127 vs bf16 0.7155 on the A/B
    # fixture — BASELINE.md round 3); set float32 for exact-parity runs
    "train_dtype": "bfloat16",    # compute dtype used by the train step
    "prediction_batch_pings": 0,  # 0 = derive from preload_n_pings
    "prefetch_depth": 2,          # host->device double buffering depth
    "class_weights": [10.0, 300.0, 250.0],
    "depth": 5,
    "start_filts": 64,
    # --- PyTorch port ---
    "device": None,               # None = cuda (raises without a card)
}

# The production serving preset, the port's
# crimac_unet_tpu_torch/configs/config_serving.yaml, as a dict for hosts
# without pyyaml: zarr surveys, the fully-convolutional slab forward, one
# grid shape per survey, uint8 dB codes in and uint8 probability codes out.
SERVING_PRESET = {
    "random_seed": 10, "frequencies": [18, 38, 120, 200],
    "data_mode": "zarr", "num_workers": 4, "patch_size": [256, 256],
    "meta_channels": [], "late_meta_inject": False, "loss_type": "CE",
    "batch_size": 4, "lr": 0.005, "lr_reduction": 0.5, "momentum": 0.95,
    "test_iter": 1000, "log_step": 2500, "lr_step": 1000,
    "iterations": 15000, "partition_train": "selected surveys",
    "train_surveys": [2011, 2013, 2014, 2015, 2016],
    "validation_surveys": [2017], "save_model_params": True,
    "eval_mode": "all", "partition_predict": "all surveys",
    "evaluation_surveys": [], "labels_available": True,
    "patch_overlap": 20, "preload_n_pings": 1000,
    "save_prediction_surveys": [], "resume_writing": True,
    "save_labels": False, "mesh_devices": 0, "compute_dtype": "bfloat16",
    "train_dtype": "bfloat16", "fwd_batch": 32, "prefetch_depth": 2,
    "use_device_pool": "auto", "device_pool_budget_mb": 2048,
    "checkpoint_every": 0, "fold_bn": True, "pipeline_depth": 3,
    "static_grid": True, "infer_mode": "slab", "transfer_dtype": "uint8",
    "output_dtype": "uint8", "dts_upsample": False,
    "alignment_warning": False,
}

# The six metadata channel families of
# crimac_unet_tpu_torch/configs/config_meta_train.yaml (7 input bands).
META_CHANNELS_ALL = {
    "portion_year": True, "portion_day": True, "time_diff": True,
    "depth_rel": True, "depth_abs_surface": True, "depth_abs_seabed": True,
}


def load_yaml_config(path):
    """Load a YAML config file into a dict (reference utils/general.py:33).
    ``yaml`` is imported here, not at module import: hosts that drive the
    port from a dict config need no pyyaml."""
    import yaml
    with open(path, "r") as stream:
        return yaml.safe_load(stream)


def get_argparse_parser(mode: str = "train") -> argparse.ArgumentParser:
    """Per-mode CLI parser with the reference flag set
    (reference utils/general.py:38-117)."""
    if mode not in ("train", "eval", "save_predict", "docker_predict"):
        raise ValueError(f"unknown CLI mode {mode!r}")

    parser = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
    if mode == "docker_predict":
        parser.add_argument("--save_model_params", action="store_true",
                            default=False)
        return parser

    parser.add_argument("--num_workers", dest="num_workers", required=False,
                        type=int)
    parser.add_argument("--depth", dest="depth", required=False, type=int)
    parser.add_argument("--batch_size", dest="batch_size", required=False,
                        type=int)
    parser.add_argument("--data_mode", dest="data_mode", required=False,
                        choices=["memm", "zarr"], type=str)
    parser.add_argument("--yaml_path", dest="yaml_path",
                        type=lambda p: Path(p).resolve(strict=True),
                        required=True)
    if mode == "train":
        # capability extension: the reference cannot resume training at
        # all (its checkpoints are bare state_dicts, SURVEY.md §5); ours
        # carry optimizer state + step counter
        parser.add_argument("--resume_checkpoint", dest="resume_checkpoint",
                            type=lambda p: Path(p).resolve(strict=True),
                            required=False)

    if mode in ("eval", "save_predict"):
        parser.add_argument("--checkpoint_path", dest="checkpoint_path",
                            type=lambda p: Path(p).resolve(strict=True),
                            required=True)
        parser.add_argument("--save_model_params", action="store_true",
                            default=False)
        # OUTPUT paths resolve non-strict: the entry points makedirs them
        # (evaluate.py/save_predict.py); strict=True made a fresh output
        # root die in argparse with a raw FileNotFoundError (inputs like
        # --checkpoint_path stay strict — they must exist)
        if mode == "eval":
            parser.add_argument("--save_path_metrics", dest="save_path_metrics",
                                type=lambda p: Path(p).resolve(),
                                required=True)
            parser.add_argument("--save_path_plot", dest="save_path_plot",
                                type=lambda p: Path(p).resolve(),
                                required=True)
        else:
            parser.add_argument("--save_predictions_path",
                                dest="save_predictions_path",
                                type=lambda p: Path(p).resolve(),
                                required=True)
    # torch device of the port's entry points ('cuda' when absent)
    parser.add_argument("--device", dest="device", required=False, type=str)
    return parser


def parse_config_options(configuration: dict, argparse_args=None) -> dict:
    """Shallow merge: defaults < YAML < argparse (argparse wins;
    reference utils/general.py:136-144)."""
    args_dict = dict(CONFIG_DEFAULTS)
    sources = [configuration or {}]
    if argparse_args is not None:
        sources.append(vars(argparse_args))
    for configs in sources:
        for k, v in configs.items():
            args_dict[k] = v
    return args_dict


def get_experiment_name_from_args(argparse_args) -> str:
    """Experiment name from the YAML stem + non-default argparse overrides
    (reference utils/general.py:155-175)."""
    from collections import OrderedDict
    args_subset = OrderedDict(vars(argparse_args))
    for k in ("save_model_params", "checkpoint_path", "num_workers"):
        args_subset.pop(k, None)
    if "yaml_path" in args_subset:
        args_subset["yaml_path"] = Path(args_subset["yaml_path"]).stem
    # reference format: comma-joined k=v pairs (utils/general.py:166-168)
    # — value-only names collide across flag sets (review finding r3)
    return ",".join(f"{k}={v}" for k, v in args_subset.items())


def config_args_to_markdown(config_args: dict) -> str:
    """Config rendered as a markdown table for logging
    (reference utils/general.py:147-152)."""
    rows = ["| Variable | Value |", "| ---- | ---------- |"]
    for k, w in config_args.items():
        if not str(k).startswith("_"):
            rows.append(f"|{k}|{w}|")
    return "\n".join(rows)
