"""Training entry point of the port.

    python -m crimac_unet_tpu_torch.pipeline.train --yaml_path cfg.yaml \
        [--resume_checkpoint last.msgpack] [--device cpu]

The reference CLI surface (pipeline_train_predict/train.py:113-158), as
the JAX package's ``crimac_unet_tpu/pipeline/train.py``: YAML + argparse
merge, experiment dirs ``saved_models/<exp>/<ts>`` and
``tensorboard_logs/<exp>/<ts>``, training with periodic best-F1
validation checkpointing (``best.msgpack`` / ``last.msgpack``, readable
and resumable by either package).  Runs on ``cuda`` unless the config or
``--device`` names another device.  This slice trains memmap surveys
without metadata channels (``config_baseline.yaml``'s path); zarr and
metadata training raise ``NotImplementedError`` naming ROADMAP A1b.
"""

from __future__ import annotations

import itertools
import shutil
import time
from pathlib import Path

import numpy as np

from ..config import (config_args_to_markdown, get_argparse_parser,
                      load_yaml_config, parse_config_options)
from ..data import device_pool as dp
from ..data.dataset import BatchPrefetcher, RandomPatchDataset
from ..data.meta_channels import get_in_channels
from ..data.partition import ZARR_TRAINING, make_partition
from ..utils.general import fix_seeds, get_datetime_str
from .runner import resolve_device
from .segpipe import SegPipeUNet

META_TRAINING = ("training with metadata channels (meta_channels, "
                 "late_meta_inject) is ROADMAP.md queue A, A1b")


def check_trainable(config) -> None:
    """Raise for the training configurations this slice does not run."""
    if config.get("data_mode") == "zarr":
        raise NotImplementedError(ZARR_TRAINING)
    if get_in_channels(config.get("meta_channels")) > 0 or \
            config.get("late_meta_inject"):
        raise NotImplementedError(META_TRAINING)


def make_datasets(config, data_obj):
    """Partition + sampler battery -> train/test dataset factories
    (reference train.py:35-110), and the train and validation readers for
    the device sample pools."""
    readers_train, readers_test = data_obj.partition_data_train()
    samplers_train, samplers_test, probs = data_obj.get_samplers_train(
        readers_train, readers_test)

    def train_factory(seed_offset=0):
        return RandomPatchDataset(samplers_train, config["patch_size"],
                                  sorted(config["frequencies"]),
                                  sampler_probs=probs,
                                  seed=config["random_seed"] + seed_offset)

    def test_factory(seed_offset=0):
        return RandomPatchDataset(samplers_test, config["patch_size"],
                                  sorted(config["frequencies"]),
                                  sampler_probs=probs,
                                  seed=config["random_seed"] + 10_000
                                  + seed_offset)
    return train_factory, test_factory, readers_train, readers_test


def maybe_build_pool(config, readers, device, budget_mb=None, role="train"):
    """Device sample pool when enabled and within the budget.

    ``use_device_pool``: ``"auto"`` (default) pools whenever the readers
    fit ``device_pool_budget_mb`` (default 2048); ``True`` forces pooling
    (raises if over budget); ``False`` keeps host crops.  ``role``:
    'train' (forced mode raises when over budget) or 'validation'
    (always falls back to host crops)."""
    mode = config.get("use_device_pool", "auto")
    if not mode or not readers:
        return None
    window = tuple(config["patch_size"])
    freqs = sorted(config["frequencies"])
    if budget_mb is None:
        budget_mb = config.get("device_pool_budget_mb", 2048)
    if not dp.fits_budget(readers, freqs, window, budget_mb):
        mb = dp.pool_bytes(readers, freqs, window) / 2 ** 20
        if mode == "auto" or role != "train":
            print(f"{role} device pool would need {mb:.0f} MB > "
                  f"{budget_mb:.0f} MB available (device_pool_budget_mb="
                  f"{config.get('device_pool_budget_mb', 2048)}); "
                  f"{role} uses host crops")
            return None
        raise ValueError(
            f"use_device_pool: true but the pool needs {mb:.0f} MB "
            f"> device_pool_budget_mb={budget_mb}; raise the budget, "
            "reduce the survey set, or set use_device_pool: auto/false")
    return dp.DeviceSamplePool(readers, freqs, window, device)


def run_training(config, checkpoint_dir, logger=None, progress=True):
    check_trainable(config)
    device = resolve_device(config.get("device"))
    fix_seeds(config["random_seed"])
    data_obj = make_partition(config)
    train_factory, test_factory, readers_train, readers_test = \
        make_datasets(config, data_obj)

    pool = maybe_build_pool(config, readers_train, device)
    if pool is not None:
        base_factory = train_factory

        def train_factory(seed_offset=0):  # noqa: F811 — pooled wrapper
            return base_factory(seed_offset).use_pool(pool)

    # the validation pool is gated against the budget REMAINING after the
    # train pool: both are resident at once
    budget = int(config.get("device_pool_budget_mb", 2048))
    if pool is not None:
        budget -= int(dp.pool_bytes(readers_train,
                                    sorted(config["frequencies"]),
                                    tuple(config["patch_size"])) / 2 ** 20)
    pool_val = maybe_build_pool(config, readers_test, device,
                                budget_mb=max(budget, 0), role="validation")
    if pool_val is not None:
        base_test_factory = test_factory

        def test_factory(seed_offset=0):  # noqa: F811 — pooled wrapper
            return base_test_factory(seed_offset).use_pool(
                pool_val, with_seabed=True)

    segpipe = SegPipeUNet(dict(config, device=str(device)),
                          checkpoint_dir=checkpoint_dir)
    if pool is not None:
        segpipe.attach_pool(pool)
    if pool_val is not None:
        segpipe.attach_pool_val(pool_val)

    n_batches = int(config["iterations"])
    if config.get("resume_checkpoint"):
        # only the remaining iterations are run
        segpipe.resume_from(config["resume_checkpoint"])
        resume_step = segpipe.state.step
        n_batches = max(0, n_batches - resume_step)
        # salt the sampler seeds with the resumed step so the continued
        # run draws fresh samples instead of replaying the start of the
        # seeded stream (the samplers' RNG state is not in the checkpoint)
        resumed_factory = train_factory

        def train_factory(seed_offset=0):  # noqa: F811
            return resumed_factory(seed_offset + 100003 * resume_step)
        print(f"Resumed from step {resume_step}; "
              f"{n_batches} iterations remaining")

    train_batches = BatchPrefetcher(
        train_factory, config["batch_size"], n_batches,
        num_workers=config.get("num_workers", 4))

    # fresh validation draws EVERY pass (the reference's Dataset advances
    # the global RNG between validations, train.py:84-110); pass k always
    # draws the same crops for a given random_seed
    val_pass = itertools.count()

    def make_test_batches():
        ds = test_factory(seed_offset=777 + 1009 * next(val_pass))
        return (ds.batch(config["batch_size"])
                for _ in range(int(config["test_iter"])))

    try:
        segpipe.train_model(train_batches, make_test_batches, logger,
                            progress=progress)
    finally:
        train_batches.close()
    return segpipe


def main(argv=None):
    args = get_argparse_parser("train").parse_args(argv)
    config = parse_config_options(load_yaml_config(args.yaml_path), args)

    experiment_name = Path(config["yaml_path"]).stem
    experiment_id = get_datetime_str()
    checkpoint_dir = Path("saved_models", experiment_name, experiment_id)
    log_dir = Path("tensorboard_logs", experiment_name, experiment_id)

    logger = None
    try:  # TensorBoard is optional
        from torch.utils.tensorboard import SummaryWriter
        logger = SummaryWriter(log_dir=str(log_dir))
        logger.add_text("Config", config_args_to_markdown(config),
                        global_step=0)
        shutil.copy(args.yaml_path, log_dir)
    except Exception as exc:  # noqa: BLE001 — logging must not stop a run
        logger = None  # a half-initialized writer must not half-log
        print(f"TensorBoard logging disabled: {exc}")

    print("Data mode:", config["data_mode"])
    start = time.time()
    run_training(config, checkpoint_dir, logger)
    print(f"Executed time for training (h): "
          f"{np.round((time.time() - start) / 3600, 2)}")


if __name__ == "__main__":
    main()
