"""The reference recipe's float32 / bfloat16 A/B and the decompositions
of the JAX repo's third-round session: the port's counterpart of
``scripts/r3_tpu_session.py``.

Stages (each merges its JSON into ``--out``, so a partial run keeps its
results):

  ab_f32 / ab_bf16  the reference recipe (15000 steps of batch 4, six
                    validations, best-F1 checkpointing) at train_dtype
                    float32 / bfloat16 on the recipe fixture
                    (``torch_check_common.train_fixture``) and seed
  slab_bound        patch against slab prediction under the ``ab_f32``
                    checkpoint read from ``--out``
                    (``torch_u8_bound.run``: exact float32, patch uint8,
                    slab uint8 and slab uint8 with uint8 outputs)
  decomp            the predict-chunk decomposition
                    (``torch_decomp.run_predict``)
  train_decomp      the train-step decomposition (``torch_decomp.run_train``)

    python scripts/torch_r3_session.py [--stages ab_f32,ab_bf16,slab_bound,decomp] \\
        [--work build/torch_checks] [--out build/torch_checks/r3_results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

DTYPES = {"ab_f32": "float32", "ab_bf16": "bfloat16"}


def log(msg):
    print(f"[r3 {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def save(out_path, key, value):
    """Merge ``{key: value}`` into the JSON file ``out_path`` atomically."""
    res = {}
    if os.path.isfile(out_path):
        with open(out_path) as f:
            res = json.load(f)
    res[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = str(out_path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, default=float)
    os.replace(tmp, out_path)
    log(f"saved {key}: {json.dumps(value, default=float)[:200]}")


def recipe_config(memm, dtype, **kw) -> dict:
    """The reference recipe at ``train_dtype`` ``dtype``, in the JAX
    script's call form (``torch_check_common.recipe_config``); ``kw``
    overrides (the device, smaller models, cut schedules),
    ``train_dtype`` included."""
    return common.recipe_config(memm, **dict({"train_dtype": dtype}, **kw))


def train_arm(cfg, ckpt_dir, name, paths=None) -> dict:
    """``run_training(cfg)`` into ``ckpt_dir`` with the launch counters
    set to 0 just before and read just after (``paths`` gets them as
    ``name``).  Returns the best F1, the wall (ending in a device
    synchronize), the steps, the train and validation steps the config
    implies, whether every logged training loss is finite, whether the
    pooled metadata path ran (a metadata config) and the checkpoint."""
    from crimac_unet_tpu_torch.data.meta_channels import get_in_channels
    from crimac_unet_tpu_torch.pipeline.train import run_training
    dev = common.device_of(cfg["device"])
    paths = paths if paths is not None else common.Paths()
    logger = common.Scalars()
    with paths.path(name, device=dev):
        t0 = time.perf_counter()
        sp = run_training(cfg, str(ckpt_dir), logger=logger, progress=False)
        common.synchronize(dev)
        wall = time.perf_counter() - t0
    losses = np.asarray(logger.values("train/loss"))
    res = {"best_F1": float(sp.best_F1_val), "wall_min": wall / 60,
           "steps": int(sp.state.step),
           "val_steps": int(cfg["iterations"]) // int(cfg["log_step"])
           * int(cfg["test_iter"]),
           "losses_finite": bool(len(losses) and np.isfinite(losses).all()),
           "validation_f1": logger.values("test/F1_score"),
           "pooled": sp.pool is not None,
           "ckpt": str(Path(ckpt_dir) / "best.msgpack"),
           "launches": paths.counts[name]}
    if get_in_channels(cfg.get("meta_channels")) > 0:
        res["pooled_meta"] = (sp.pool is not None
                              and sp.pool.meta_vectors is not None)
    return res


def stage_ab(work, out, dtype, paths=None, **kw):
    """The reference recipe at ``dtype``; saves ``ab_<dtype>`` with the
    JAX stage's keys and returns the whole summary."""
    cfg = recipe_config(common.train_fixture(work), dtype, **kw)
    res = train_arm(cfg, Path(work) / f"ckpt_{dtype}", f"ab_{dtype}", paths)
    save(out, f"ab_{dtype}", {k: res[k] for k in
                              ("best_F1", "wall_min", "steps", "ckpt")})
    return res


def stage_slab_bound(work, out, device="cuda"):
    from scripts import torch_u8_bound
    with open(out) as f:
        ck = json.load(f)["ab_float32"]["ckpt"]
    res = torch_u8_bound.run(ck, common.bench_survey(work), device)
    save(out, "slab_bound", res)
    return res


def stage_decomp(work, out, device="cuda"):
    from scripts import torch_decomp
    res = torch_decomp.run_predict(device, common.bench_survey(work))
    save(out, "decomp", res)
    return res


def stage_train_decomp(work, out, device="cuda"):
    from scripts import torch_decomp
    res = torch_decomp.run_train(device)
    save(out, "train_decomp", res)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="ab_f32,ab_bf16,slab_bound,decomp")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--work", default=str(common.WORK))
    ap.add_argument("--out", default=None,
                    help="results JSON (default <work>/r3_results.json)")
    a = ap.parse_args(argv)
    out = a.out or os.path.join(a.work, "r3_results.json")
    os.makedirs(a.work, exist_ok=True)
    dev = str(common.device_of(a.device))
    for st in a.stages.split(","):
        log(f"=== stage {st}")
        t0 = time.time()
        if st in DTYPES:
            stage_ab(a.work, out, DTYPES[st], device=dev)
        elif st == "slab_bound":
            stage_slab_bound(a.work, out, dev)
        elif st == "decomp":
            stage_decomp(a.work, out, dev)
        elif st == "train_decomp":
            stage_train_decomp(a.work, out, dev)
        else:
            raise SystemExit(f"unknown stage {st}")
        log(f"=== {st} done in {(time.time() - t0) / 60:.1f} min")


if __name__ == "__main__":
    main()
