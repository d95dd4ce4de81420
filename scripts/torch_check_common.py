"""Pieces shared by the port's trained-weight and survey-scale checks
(``scripts/torch_u8_bound.py``, ``torch_eval_u8_bound.py``,
``torch_serving_geometry_ab.py``, ``torch_school_ap_trained.py``,
``torch_soak50k.py``, ``torch_school_eval_soak.py``), its
where-the-time-goes tools (``torch_timing_common.py`` and its users) and
its A/B benches and recipe studies (``torch_eval_quant_bench.py`` ...
``torch_static_grid.py``).

The flagship serving configuration, the checkpoint loader (a ``.msgpack``
of either package or a reference ``.pt``), the bench survey, one
survey's predictions as one array, the sandeel max-F1 through the port's
PR histogram, per-path launch counts, and the host RSS and device memory
peaks of one call.  Imports nothing of JAX, the JAX package, pandas,
sklearn or psutil: the card's machine has none of them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FREQS = [18, 38, 120, 200]
# the JAX scripts' model and tiling: the flagship U-Net, bf16 compute
FLAGSHIP = {"patch_size": [256, 256], "patch_overlap": 20,
            "frequencies": FREQS, "fwd_batch": 32, "depth": 5,
            "start_filts": 64, "compute_dtype": "bfloat16"}
WORK = ROOT / "build" / "torch_checks"     # gitignored


def parser(description: str, ckpt_required=True,
           bench=False) -> argparse.ArgumentParser:
    """The scripts' common flags; ``bench`` adds ``--pings``, the width of
    the bench survey (4000 as in the JAX package; fewer for a CPU run)."""
    ap = argparse.ArgumentParser(description=description)
    if bench:
        ap.add_argument("--pings", type=int, default=4000,
                        help="pings of the bench survey")
    ap.add_argument("--ckpt", required=ckpt_required,
                    help="model weights: a .msgpack of either package or a "
                         "reference .pt state dict")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--work", default=str(WORK),
                    help="directory of the cached fixtures")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap


def device_of(device) -> torch.device:
    """``cuda`` raises without a card; any other device is taken as is."""
    from crimac_unet_tpu_torch.pipeline.runner import resolve_device
    return resolve_device(None if str(device) == "cuda" else device)


def model_config(model=None, **kw) -> dict:
    """The flagship configuration, ``model`` overrides (smaller models in
    the tests), then the mode's keys."""
    return {**FLAGSHIP, **(model or {}), **kw}


def state_dict(ckpt) -> dict:
    """A state dict as is, or the weights of a checkpoint file."""
    if isinstance(ckpt, dict):
        return ckpt
    from crimac_unet_tpu_torch.models.weights import load_checkpoint
    return load_checkpoint(ckpt)


def make_runner(sd, cfg, device, record_warnings=False):
    """A ``GriddedRunner`` on ``device``; with ``record_warnings`` also
    whether its construction warned of a misaligned slab grid."""
    import warnings

    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runner = GriddedRunner(build_unet(cfg), sd, cfg, device=device)
    if record_warnings:
        return runner, any("misaligned" in str(w.message) for w in caught)
    return runner


def cached(marker: Path, build):
    """Run ``build()`` unless ``marker`` exists; write the marker after a
    complete build, so a build cut short is redone."""
    if not marker.is_file():
        marker.parent.mkdir(parents=True, exist_ok=True)
        build()
        marker.write_text("ok")


def bench_survey(work=WORK, H=1000, W=4000) -> str:
    """The JAX package's bench.py survey (seed 3, 24 schools; 1000 range x
    4000 pings x 4 frequencies at full size) written by the port's
    fixture, cached under ``work``."""
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    root = Path(work) / f"bench_{H}x{W}"
    cached(root / "S2017843.ok", lambda: make_zarr_survey(
        root, year=2017, n_echograms=1, H=H, W=W, seed=3, n_schools=24))
    return str(root / "S2017843_sv.zarr")


def zarr_reader(survey):
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    return survey if hasattr(survey, "data_format") else \
        DataReaderZarr(str(survey))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Paths:
    """Launch counts per path: the counters set to 0 just before a path
    and read just after, beside the runner's forwards (sub-batches in
    evaluation) over the same span.  ``probe(name)``, where given, is
    entered around each path too (``chip_smoke.py`` phase 19 holds the
    kernels to their plain versions there)."""

    def __init__(self, probe=None):
        self.counts: dict = {}
        self.probe = probe

    @contextlib.contextmanager
    def path(self, name, runner=None, device=None):
        """Count the launches of the block as path ``name``; without a
        ``runner`` (a training run) the block's forwards count as 0 and
        ``device`` is the one synchronized."""
        from crimac_unet_tpu_torch.ops import cuda_lib
        dev = runner.device if runner is not None else device
        outer = self.probe(name) if self.probe else contextlib.nullcontext()
        with outer:
            synchronize(dev)
            cuda_lib.reset_launches()
            f0 = runner.forwards if runner is not None else 0
            yield
            synchronize(dev)
            f1 = runner.forwards if runner is not None else 0
            self.counts[name] = dict(cuda_lib.launches, forwards=f1 - f0)


def predict_survey(runner, reader, preload_n_pings=1000):
    """(2, n_range, n_pings) float32 predictions of a whole reader through
    ``predict_reader``, and the wall of the pass."""
    from crimac_unet_tpu_torch.pipeline.predict import predict_reader
    t0 = time.perf_counter()
    chunks = {s: np.asarray(p, np.float32) for s, _, p, _ in
              predict_reader(runner, reader, preload_n_pings)}
    wall = time.perf_counter() - t0
    return np.concatenate([chunks[s] for s in sorted(chunks)], axis=2), wall


def raw_labels(reader, n_range, n_pings) -> np.ndarray:
    """(range, ping) raw category labels of a zarr reader, NaN as 0."""
    lab = reader.get_label_slice(0, n_pings, 0, n_range)
    return np.nan_to_num(np.asarray(lab).T, nan=0)


def max_f1(scores: np.ndarray, positive: np.ndarray) -> float:
    """Max F1 of ``scores`` against the boolean ``positive`` through the
    port's PR histogram (``update_pr_histogram`` ->
    ``pr_curve_from_histogram`` -> ``max_f1``); sklearn's
    ``precision_recall_curve`` gives the same on float16-valued scores."""
    from crimac_unet_tpu_torch.constants import BACKGROUND, SANDEEL
    from crimac_unet_tpu_torch.ops import metrics
    preds = torch.from_numpy(np.ascontiguousarray(scores, np.float32))
    labels = torch.where(torch.from_numpy(np.ascontiguousarray(positive)),
                         SANDEEL, BACKGROUND)
    hist = metrics.update_pr_histogram(metrics.new_histogram(), preds,
                                       labels)
    return metrics.max_f1(metrics.pr_curve_from_histogram(hist.numpy()))[0]


def vm_rss_bytes() -> int:
    """This process's resident set (``VmRSS`` of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """The largest ``VmRSS`` over a ``with`` block, sampled by a thread
    every 5 ms, minus the value just before it (``delta_bytes``), when in
    the block it was first reached (``peak_s``) and the block's length
    to its last sample (``wall_s``).  A rise shorter than one interval
    can go unseen."""

    EVERY_S = 0.005

    def __init__(self):
        self.before = self.peak = 0
        self.peak_s = self.wall_s = 0.0
        self._stop = threading.Event()
        self._thread = None

    def _take(self):
        rss = vm_rss_bytes()
        if rss > self.peak:
            self.peak, self.peak_s = rss, time.perf_counter() - self.t0

    def _sample(self):
        while not self._stop.wait(self.EVERY_S):
            self._take()

    def __enter__(self):
        self.before = self.peak = vm_rss_bytes()
        self.t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._take()
        self.wall_s = time.perf_counter() - self.t0
        return False

    @property
    def delta_bytes(self) -> int:
        return self.peak - self.before


@contextlib.contextmanager
def device_peak(device, into: dict):
    """``into["peak_device_bytes"]``: ``torch.cuda.max_memory_allocated``
    over the block, reset just before it; None off a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        into["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        into["peak_device_bytes"] = None


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device type off a card."""
    import subprocess
    if torch.device(device).type != "cuda":
        return str(torch.device(device))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {exc})"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)


def train_fixture(tmp) -> Path:
    """The reference recipe's fixture under ``tmp`` (the JAX repo's
    ``scripts/r3_tpu_session.py:51-60``) built with the port's
    ``make_survey_dir``: 2017 three 700 x 1400 echograms (seed 41), 2016
    two 700 x 1200 (seed 42), 6 schools each."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    root = Path(tmp) / "train_memm"
    if not root.is_dir():
        t0 = time.perf_counter()
        make_survey_dir(root, year=2017, n_echograms=3, H=700, W=1400,
                        seed=41, n_schools=6)
        make_survey_dir(root, year=2016, n_echograms=2, H=700, W=1200,
                        seed=42, n_schools=6)
        print(f"train fixture written in {time.perf_counter() - t0:.1f} s")
    return root


def recipe_config(root, **kw) -> dict:
    """The reference recipe's settings (the JAX repo's
    ``scripts/r3_tpu_session.py:63-78``): the flagship U-Net, batch 4, lr
    0.005 halved every 1000 steps, 15000 iterations, validation every 2500
    over 1000 batches; device pool auto, on the card; ``kw`` overrides."""
    from crimac_unet_tpu_torch.config import parse_config_options
    return parse_config_options(dict({
        "frequencies": FREQS, "data_mode": "memm",
        "path_to_echograms": str(root), "patch_size": [256, 256],
        "loss_type": "CE", "batch_size": 4, "lr": 0.005,
        "lr_reduction": 0.5, "momentum": 0.95, "iterations": 15000,
        "test_iter": 1000, "log_step": 2500, "lr_step": 1000,
        "num_workers": 2, "partition_train": "selected surveys",
        "train_surveys": [2017], "validation_surveys": [2016],
        "partition_predict": "all surveys", "evaluation_surveys": [],
        "save_prediction_surveys": [], "eval_mode": "all",
        "patch_overlap": 20, "random_seed": 10, "depth": 5,
        "start_filts": 64, "train_dtype": "bfloat16",
        "use_device_pool": "auto", "device": "cuda"}, **kw))


class Scalars:
    """A TensorBoard-style logger that keeps the scalars."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step):
        self.rows.append((tag, float(value), int(global_step)))

    def values(self, tag):
        return [v for t, v, _ in self.rows if t == tag]


def finish(res: dict, out=None) -> dict:
    """Print the result as one JSON line and write it to ``out``."""
    import json
    line = json.dumps(res, default=float)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line, flush=True)
    return res
