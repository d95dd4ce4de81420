"""Training entry point of the port.

    python -m crimac_unet_tpu_torch.pipeline.train --yaml_path cfg.yaml \
        [--resume_checkpoint last.msgpack] [--device cpu]
    torchrun --nproc_per_node N -m crimac_unet_tpu_torch.pipeline.train \
        --yaml_path cfg.yaml             # data parallel over N devices

The reference CLI surface (pipeline_train_predict/train.py:113-158), as
the JAX package's ``crimac_unet_tpu/pipeline/train.py``: YAML + argparse
merge, experiment dirs ``saved_models/<exp>/<ts>`` and
``tensorboard_logs/<exp>/<ts>``, training with periodic best-F1
validation checkpointing (``best.msgpack`` / ``last.msgpack``, readable
and resumable by either package).  Runs on ``cuda`` unless the config or
``--device`` names another device.  Trains memmap and zarr surveys
(``data_mode``), with metadata channels early or late injected on memmap
surveys (``meta_channels``, ``late_meta_inject``).  Under torchrun every
rank joins the process group (``init_distributed``) and ``mesh_devices``
(0 = all ranks) trains data parallel (pipeline/segpipe.py); rank 0 writes
the run's checkpoints and logs.
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
from ..data.partition import make_partition
from ..parallel.mesh import (broadcast_object, get_mesh, init_distributed,
                             is_writer, shutdown_distributed)
from ..utils.general import fix_seeds, get_datetime_str
from .runner import resolve_device
from .segpipe import SegPipeUNet


def enabled_meta(config):
    """The config's ``meta_channels`` when any family is on, else None
    (an all-off flag dict trains as no metadata, as the steps do)."""
    mc = config.get("meta_channels")
    return mc if get_in_channels(mc) > 0 else None


def make_datasets(config, data_obj):
    """Partition + sampler battery -> train/test dataset factories
    (reference train.py:35-110), and the train and validation readers for
    the device sample pools."""
    readers_train, readers_test = data_obj.partition_data_train()
    samplers_train, samplers_test, probs = data_obj.get_samplers_train(
        readers_train, readers_test)
    meta = enabled_meta(config)

    def train_factory(seed_offset=0):
        return RandomPatchDataset(samplers_train, config["patch_size"],
                                  sorted(config["frequencies"]),
                                  sampler_probs=probs, meta_channels=meta,
                                  seed=config["random_seed"] + seed_offset)

    def test_factory(seed_offset=0):
        return RandomPatchDataset(samplers_test, config["patch_size"],
                                  sorted(config["frequencies"]),
                                  sampler_probs=probs, meta_channels=meta,
                                  seed=config["random_seed"] + 10_000
                                  + seed_offset)
    return train_factory, test_factory, readers_train, readers_test


def maybe_build_pool(config, readers_train, budget_mb=None, role="train",
                     device=None):
    """Device sample pool when enabled and within the budget:
    ``DeviceSamplePool`` for memmap readers (with the metadata vectors
    when ``meta_channels`` are on), ``ZarrSamplePool`` for zarr readers.

    ``use_device_pool``: ``"auto"`` (default) pools whenever the readers
    fit ``device_pool_budget_mb`` (default 2048); ``True`` forces pooling
    (raises if over budget or impossible); ``False`` keeps host crops.
    ``role``: 'train' (forced mode raises) or 'validation' (always falls
    back to host crops).  Metadata channels on zarr surveys cannot pool
    (metadata is memmap-only): they fall back to host crops, where
    ``crop_meta`` raises the memmap-only ``ValueError``.  ``device``
    (default: the config's, as ``resolve_device`` reads it) holds the
    pool."""
    readers = readers_train
    mode = config.get("use_device_pool", "auto")
    if not mode or not readers:
        return None
    meta = enabled_meta(config)
    zarr = readers[0].data_format != "memmap"
    if meta and zarr:
        if mode is True and role == "train":
            raise ValueError(
                "use_device_pool: true with meta_channels on zarr surveys "
                "cannot pool (metadata channels are memmap-only, reference "
                "dataset.py:245-252); set use_device_pool: auto/false or "
                "drop meta_channels")
        print(f"{role} device pool disabled: meta_channels on zarr "
              "surveys use host crops (metadata is memmap-only)")
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
    if device is None:
        device = resolve_device(config.get("device"))
    cls = dp.ZarrSamplePool if zarr else dp.DeviceSamplePool
    return cls(readers, freqs, window, meta_channels=meta, device=device)


def run_training(config, checkpoint_dir, experiment_name=None,
                 logger=None, progress=True):
    device = resolve_device(config.get("device"))
    # a mesh larger than the process group raises before any survey is
    # read (SegPipeUNet takes the same mesh)
    get_mesh(int(config.get("mesh_devices", 0) or 0))
    fix_seeds(config["random_seed"])
    data_obj = make_partition(config)
    train_factory, test_factory, readers_train, readers_test = \
        make_datasets(config, data_obj)

    pool = maybe_build_pool(config, readers_train, device=device)
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
    pool_val = maybe_build_pool(config, readers_test,
                                budget_mb=max(budget, 0), role="validation",
                                device=device)
    if pool_val is not None:
        base_test_factory = test_factory

        def test_factory(seed_offset=0):  # noqa: F811 — pooled wrapper
            return base_test_factory(seed_offset).use_pool(
                pool_val, with_seabed=True)

    segpipe = SegPipeUNet(dict(config, device=str(device)),
                          checkpoint_dir=checkpoint_dir,
                          experiment_name=experiment_name or "model")
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

    init_distributed(device=resolve_device(config.get("device")))
    experiment_name = Path(config["yaml_path"]).stem
    # every rank names the run as rank 0 does
    experiment_id = broadcast_object(get_datetime_str())
    checkpoint_dir = Path("saved_models", experiment_name, experiment_id)
    log_dir = Path("tensorboard_logs", experiment_name, experiment_id)

    logger = None
    if is_writer():  # rank 0 logs; TensorBoard is optional
        try:
            from torch.utils.tensorboard import SummaryWriter
            logger = SummaryWriter(log_dir=str(log_dir))
            logger.add_text("Config", config_args_to_markdown(config),
                            global_step=0)
            shutil.copy(args.yaml_path, log_dir)
        except Exception as exc:  # noqa: BLE001 — logging must not stop
            logger = None  # a half-initialized writer must not half-log
            print(f"TensorBoard logging disabled: {exc}")

    print("Data mode:", config["data_mode"])
    start = time.time()
    try:
        run_training(config, checkpoint_dir, experiment_name, logger)
    finally:
        shutdown_distributed()
    print(f"Executed time for training (h): "
          f"{np.round((time.time() - start) / 3600, 2)}")


if __name__ == "__main__":
    main()
