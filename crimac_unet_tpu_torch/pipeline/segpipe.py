"""SegPipe: the training/validation orchestration object, and the
host-side outputs of an evaluation (the metrics CSV and the PR plot).

The port's counterpart of ``crimac_unet_tpu/pipeline/segpipe.py``
(reference pipeline_train_predict/pipeline.py:39-410): ``SegPipeUNet``
holds the model, its SGD state and the config, runs the training loop
with periodic validation, checkpoints ``best`` on max validation F1 and
``last`` at the end (the JAX package's msgpack files), and logs with the
reference's tag names (train/loss, test/F1_score|precision|recall|loss,
learning_rate_0) to a TensorBoard-style ``logger`` when given.
``mesh_devices`` (0 = every rank of the process group) trains data
parallel over ``torch.distributed`` (parallel/mesh.py): every rank builds
the same host batches and sample pools, takes its rows of each batch,
and steps on the global batch's loss; rank 0 alone writes checkpoints,
logs and prints.  Neither pandas nor matplotlib is needed to write the
CSV.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np
import torch

from ..data.device_pool import META_ORDER
from ..models import architecture, build_model
from ..models.weights import load_checkpoint
from ..ops import metrics as M
from ..parallel.mesh import (all_reduce_, barrier, broadcast_object,
                             get_mesh, is_writer, mesh_size, replicate_)
from ..parallel.prefetch import device_prefetch
from . import engine
from .runner import resolve_device


class SegPipeUNet:
    """Train/validate the model the config names (reference
    pipeline.py:379-410): the flagship U-Net, or a SegFormer
    (``architecture: segformer``), whose checkpoints are the port's
    ``best.pt`` / ``last.pt`` (pipeline/engine.py) where the U-Net's are
    the JAX package's msgpack files."""

    def __init__(self, config: dict, checkpoint_dir=None,
                 experiment_name="model"):
        self.config = dict(config)
        self.model_name = experiment_name
        self.device = resolve_device(config.get("device"))
        # the data mesh (None: this process trains alone); a batch the
        # mesh does not divide trains single-device on every rank, as
        # the JAX package does (segpipe.py:45-50)
        self.mesh = get_mesh(int(config.get("mesh_devices", 0) or 0))
        n_dev = mesh_size(self.mesh)
        if n_dev > 1 and int(config["batch_size"]) % n_dev != 0:
            print(f"batch_size {config['batch_size']} not divisible by "
                  f"{n_dev} devices; training single-device")
            self.mesh = None
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        # bf16 conv compute by default (f32 master params, f32 loss), as
        # the JAX package (segpipe.py:36-42); train_dtype: float32 for
        # exact-parity runs
        self.model = build_model(dict(
            config, compute_dtype=config.get("train_dtype", "bfloat16")))
        # the checkpoint files' suffix: the JAX package's format, or the
        # port's own where the JAX package has no such model
        self.ckpt_ext = ".msgpack" if architecture(config) == "unet" \
            else ".pt"
        self.model.to(self.device)
        self.state = None
        self.variables = None
        self.best_F1_val = -np.inf
        self._train_step = engine.make_train_step(config, self.mesh)
        self._train_step_pooled = engine.make_train_step_pooled(config,
                                                                self.mesh)
        self._eval_step = engine.make_eval_step(config, self.mesh)
        self._eval_step_pooled = engine.make_eval_step_pooled(config,
                                                              self.mesh)
        self._lr_schedule = engine.make_lr_schedule(config)
        self.pool = None
        self.pool_val = None
        self.generator = None

    def _check_pool_meta(self, pool):
        """A metadata config needs a pool built with the same
        ``meta_channels`` (its per-echogram vectors on the device): a
        missing or different flag set would otherwise fail at step time
        or train silently on the wrong features."""
        cfg = self.config.get("meta_channels") or {}
        cfg_flags = tuple(k for k in META_ORDER if cfg.get(k))
        pool_flags = tuple(pool.meta_flags)
        if cfg_flags and not pool_flags:
            raise ValueError(
                "config enables meta_channels but the sample pool was "
                "built without them; pass meta_channels to the pool "
                "constructor (train.maybe_build_pool does this)")
        if pool_flags and not cfg_flags:
            raise ValueError(
                "the sample pool carries meta_channels but the config "
                "does not enable them; rebuild the pool without "
                "meta_channels (or enable them in the config)")
        if cfg_flags != pool_flags:
            raise ValueError(
                f"meta_channels mismatch: config enables {cfg_flags} but "
                f"the sample pool was built with {pool_flags}; rebuild "
                "the pool with the config's meta_channels")

    def attach_pool(self, pool):
        """Gather training crops on the device from ``pool``
        (data/device_pool.py); batches become (echogram, start)
        coordinates."""
        self._check_pool_meta(pool)
        self.pool = pool
        return self

    def attach_pool_val(self, pool):
        """Gather VALIDATION crops on the device from ``pool``."""
        self._check_pool_meta(pool)
        self.pool_val = pool
        return self

    # ----------------------------------------------------------- lifecycle
    def init_model(self, seed=None, state_dict=None):
        """Fresh TrainState at step 0: torch's default initialisation
        from a generator seeded with ``seed`` (``random_seed`` when
        None), or the weights of ``state_dict``; zero momentum."""
        gen = None
        if state_dict is None:
            seed = int(self.config.get("random_seed", 10)) if seed is None \
                else int(seed)
            # drawn on the CPU, so the weights do not depend on the device
            gen = torch.Generator().manual_seed(seed)
        self.state = engine.init_train_state(self.model, self.config, gen,
                                             state_dict)
        replicate_(self.mesh, self.model)
        return self.state

    def load_model_params(self, checkpoint_path=None):
        """Load best/last/.pt weights (a reference ``.pt`` state dict or
        either package's msgpack checkpoint); training then starts from
        them at step 0 (reference pipeline.py:109-130)."""
        if checkpoint_path is None:
            checkpoint_path = self.checkpoint_dir / ("best" + self.ckpt_ext)
        self.variables = load_checkpoint(checkpoint_path)
        return self.variables

    def resume_from(self, checkpoint_path):
        """Resume TRAINING from a msgpack checkpoint, optimizer state and
        step counter included, and the best-F1 high-water mark from its
        sidecar (so the first post-resume validation cannot replace
        best.msgpack with a worse model)."""
        if str(checkpoint_path).endswith(".pt") and \
                engine.read_train_state(checkpoint_path) is None:
            raise ValueError(
                "Reference .pt checkpoints carry no optimizer state or "
                "step counter and cannot seed a TRAINING resume; import "
                "the weights with load_model_params/--checkpoint_path "
                "instead (training then starts from step 0)")
        self.init_model()
        engine.load_checkpoint(checkpoint_path, template=self.state)
        replicate_(self.mesh, self.model, self.state.optimizer)
        extras = engine.load_checkpoint_extras(checkpoint_path)
        if "best_f1" in extras and np.isfinite(extras["best_f1"]):
            self.best_F1_val = float(extras["best_f1"])
        return self.state

    # ------------------------------------------------------------ training
    def train_step(self, batch) -> torch.Tensor:
        """One update from a device batch (crops, or pool coordinates
        with ``ech_idx``); returns the loss as a device scalar."""
        if "ech_idx" in batch:
            pool = self.pool
            if pool is None:
                raise ValueError("pooled batch (has 'ech_idx') but "
                                 "attach_pool() was never called on this "
                                 "SegPipeUNet")
            return self._train_step_pooled(
                self.state, pool.data, pool.labels, batch["ech_idx"],
                batch["starts"], self.generator,
                meta_vectors=pool.meta_vectors, flags=pool.meta_flags)
        return self._train_step(self.state, batch["data"], batch["labels"],
                                self.generator, meta=batch.get("meta"))

    def train_model(self, train_batches, make_test_batches, logger=None,
                    progress=True):
        """Iterate the training batches, validating every ``log_step``
        (reference pipeline.py:144-203).

        ``train_batches``: iterable of host batch dicts;
        ``make_test_batches``: zero-arg callable yielding a fresh iterable
        of validation batches (the reference re-draws random validation
        samples every validation epoch).
        """
        resuming = self.state is not None and self.state.step > 0
        if self.state is None:
            # imported weights (load_model_params) seed training at step 0
            self.init_model(state_dict=self.variables)
        if not resuming and self.checkpoint_dir is not None and \
                any((self.checkpoint_dir / n).exists()
                    for n in ("last" + self.ckpt_ext,
                              "best" + self.ckpt_ext)):
            raise FileExistsError(
                f"model already exists at {self.checkpoint_dir}")
        # no rank may find rank 0's first checkpoint in that check
        barrier()
        start = self.state.step  # 0 unless resumed (resume_from)
        writer = is_writer()
        if not writer:
            logger = None

        log_step = int(self.config["log_step"])
        lr_step = int(self.config["lr_step"])
        ckpt_every = int(self.config.get("checkpoint_every", 0) or 0)
        # the augmentation's draws, seeded like the JAX package's key
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(self.config.get("random_seed", 10))
                                   + start)

        it = device_prefetch(train_batches, self.device,
                             depth=int(self.config.get("prefetch_depth", 2)),
                             mesh=self.mesh)
        if progress and writer:
            try:
                from tqdm import tqdm
            except ImportError:
                print(f"Training model from step {start} (tqdm is not "
                      "installed; progress is printed at each validation)")
            else:
                it = tqdm(it, total=int(self.config["iterations"]),
                          initial=start, desc="Training model")

        # per-iteration losses are logged like the reference
        # (pipeline.py:181) but read from the device in one stacked copy
        # per flush: a read per step would sync the host every step
        loss_flush = max(1, min(log_step, lr_step, 50))
        pending: list = []

        def flush_losses(upto):
            if logger is not None and pending:
                vals = torch.stack(pending).cpu().numpy()
                for j, v in enumerate(vals):
                    logger.add_scalar("train/loss", float(v),
                                      global_step=upto - len(vals) + j + 1)
            pending.clear()

        i = start - 1
        for batch in it:
            i += 1  # global step index (continues across resumes)
            pending.append(self.train_step(batch))
            if len(pending) >= loss_flush:
                flush_losses(i + 1)
            if (i + 1) % log_step == 0:
                self.validate_model_training(make_test_batches(), logger, i)
            if logger is not None and (i + 1) % lr_step == 0:
                logger.add_scalar("learning_rate_0", self._lr_schedule(i + 1),
                                  global_step=i + 1)
            if ckpt_every and (i + 1) % ckpt_every == 0:
                self._save("last" + self.ckpt_ext, self.best_F1_val)
        flush_losses(i + 1)

        if self.config.get("save_model_params", True):
            self._save("last" + self.ckpt_ext, self.best_F1_val)
        self.variables = self.model.state_dict()
        return self.state

    def _save(self, name, best_f1):
        """Rank 0 of the process group writes ``name`` into the checkpoint
        dir; every rank waits for it."""
        if self.checkpoint_dir is None:
            return
        if is_writer():
            engine.save_checkpoint(self.checkpoint_dir / name, self.state,
                                   extras={"best_f1": float(best_f1)})
        barrier()

    def validate_model_training(self, test_batches, logger, iteration_no):
        """Validation pass: streaming PR histogram + mean loss; checkpoint
        best-F1 (reference pipeline.py:305-341)."""
        hist = M.new_histogram(self.device)
        # int64 host accumulation: one pass can exceed 2^31 pixels, which
        # would wrap the int32 device histogram
        hist64 = np.zeros((2, M.N_F16_BINS), np.int64)
        acc_px = 0
        losses = []
        # every rank counts its shard; the summed histogram must not
        # wrap either
        px = int(np.prod(self.config["patch_size"])) * mesh_size(self.mesh)

        def drain(hist):
            return all_reduce_(hist, self.mesh).cpu().numpy().astype(
                np.int64)

        for batch in device_prefetch(test_batches, self.device, depth=2,
                                     mesh=self.mesh):
            if "ech_idx" in batch:
                pool = self.pool_val
                if pool is None:
                    raise ValueError(
                        "pooled validation batch (has 'ech_idx') but "
                        "attach_pool_val() was never called on this "
                        "SegPipeUNet")
                hist, loss = self._eval_step_pooled(
                    self.model, hist, pool.data, pool.labels,
                    batch["ech_idx"], batch["starts"], batch["seabed_row"],
                    meta_vectors=pool.meta_vectors, flags=pool.meta_flags)
                acc_px += len(batch["ech_idx"]) * px
            else:
                hist, loss = self._eval_step(
                    self.model, hist, batch["data"], batch["labels"],
                    batch["seabed_row"], meta=batch.get("meta"))
                acc_px += batch["labels"].numel() * mesh_size(self.mesh)
            losses.append(loss)
            if acc_px > 2 ** 30:
                hist64 += drain(hist)
                hist.zero_()
                acc_px = 0
        self.model.train()
        hist64 += drain(hist)
        curve = M.pr_curve_from_histogram(hist64)
        f1, idx = M.max_f1(curve)
        # rank 0's score decides the best checkpoint on every rank (ranks
        # without a mesh score their own, equal, passes): one decision, so
        # every rank meets _save's barrier
        f1 = broadcast_object(f1)
        mean_loss = float(torch.stack(losses).double().mean()) \
            if losses else 0.0

        step = iteration_no + 1
        if logger is not None:
            logger.add_scalar("test/F1_score", f1, global_step=step)
            logger.add_scalar("test/precision",
                              float(curve["precision"][idx]),
                              global_step=step)
            logger.add_scalar("test/recall", float(curve["recall"][idx]),
                              global_step=step)
            logger.add_scalar("test/loss", mean_loss, global_step=step)
        if is_writer():
            print(f"step {step}: validation F1 {f1:.4f}, "
                  f"loss {mean_loss:.4f}")

        if f1 > self.best_F1_val and self.checkpoint_dir is not None:
            self.best_F1_val = f1
            self._save("best" + self.ckpt_ext, f1)
        return f1, mean_loss


_CSV_COLUMNS = ("precision", "recall", "thresholds", "F1")


def save_metrics_dict(curve: dict, save_path) -> None:
    """CSV with the reference column layout (pipeline.py:358-364 /
    evaluate.py:19-24) as ``pd.DataFrame(curve).to_csv`` writes it: an
    unnamed index column, then precision, recall, thresholds and F1, with
    a trailing NaN threshold (an empty field) for the appended end
    point."""
    cols = {k: np.asarray(curve[k], np.float64) for k in _CSV_COLUMNS}
    cols["thresholds"] = np.append(cols["thresholds"], np.nan)
    n = len(cols["precision"])
    if any(len(v) != n for v in cols.values()):
        raise ValueError("curve columns differ in length: "
                         f"{ {k: len(v) for k, v in cols.items()} }")
    with open(save_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(("",) + _CSV_COLUMNS)
        for i in range(n):
            w.writerow([i] + ["" if math.isnan(cols[k][i]) else
                              repr(float(cols[k][i])) for k in _CSV_COLUMNS])


def save_pr_plot(curve: dict, save_path) -> None:
    """PR scatter PNG (reference evaluate.py:27-36); needs matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("save_pr_plot needs the matplotlib package (the "
                          "metrics CSV does not)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.tick_params(labelsize=6)
    ax.set_xlabel("Recall", fontsize=8)
    ax.set_ylabel("Precision", fontsize=8)
    ax.set_xticks([0, 0.2, 0.4, 0.6, 0.8, 1.0])
    ax.scatter(curve["recall"], curve["precision"], s=2)
    ax.set_xlim(-0.06, 1.06)
    ax.set_ylim(-0.06, 1.06)
    plt.savefig(save_path)
    plt.close(fig)
