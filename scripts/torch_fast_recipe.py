"""The fast-training recipe's arms: the port's counterpart of
``scripts/fast_recipe.py``.

The reference recipe's sample budget (15000 steps x batch 4 = 60000
crops) at a larger batch: iterations, lr_step, log_step and test_iter
scale down by batch / 4, which keeps the decay per sample, the six
validations and the validation pixel count.  Arms: ``b16`` (linear LR
scaling, lr 0.02), ``b16_sqrt`` (sqrt scaling, lr 0.01: the settings of
``configs/config_fast_train.yaml``) and ``b32`` (lr 0.04), each trained
through ``run_training`` on the recipe fixture and seed, one draw each;
best validation F1, wall and steps are saved per arm.

    python scripts/torch_fast_recipe.py [--arms b16,b16_sqrt,b32] \\
        [--work build/torch_checks] [--out build/torch_checks/fast_results.json]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import torch_check_common as common  # noqa: E402
from scripts.torch_r3_session import (log, recipe_config,  # noqa: E402
                                      save, train_arm)


def fast_config(memm, batch, lr, **kw) -> dict:
    """Equal-sample-budget scaling of the reference recipe (bfloat16);
    ``kw`` overrides the recipe's settings (the device, smaller models)
    before the scaling."""
    cfg = recipe_config(memm, "bfloat16", **kw)
    scale = batch // cfg["batch_size"]  # 4 -> batch
    cfg.update(batch_size=batch, lr=lr, iterations=15000 // scale,
               lr_step=1000 // scale, log_step=2500 // scale,
               test_iter=1000 // scale)
    return cfg


ARMS = {
    # linear LR scaling (Goyal et al.): lr x4 at batch x4
    "b16": lambda memm, **kw: fast_config(memm, 16, 0.02, **kw),
    # sqrt scaling, the preset's (linear proved unstable in the JAX runs)
    "b16_sqrt": lambda memm, **kw: fast_config(memm, 16, 0.01, **kw),
    "b32": lambda memm, **kw: fast_config(memm, 32, 0.04, **kw),
}


PRESET_KEYS = ("batch_size", "lr", "lr_step", "lr_reduction", "momentum",
               "iterations", "test_iter", "log_step", "patch_size",
               "loss_type", "train_dtype", "random_seed")


def preset_differences(memm) -> dict:
    """``{key: (b16_sqrt arm, config_fast_train.yaml)}`` over the fast
    preset's training keys where the two differ: empty when the preset
    file holds the ``b16_sqrt`` arm's settings."""
    from crimac_unet_tpu_torch.config import load_yaml_config
    preset = load_yaml_config(Path(__file__).resolve().parent.parent
                              / "crimac_unet_tpu_torch" / "configs"
                              / "config_fast_train.yaml")
    arm = ARMS["b16_sqrt"](memm)
    return {k: (arm[k], preset[k]) for k in PRESET_KEYS
            if arm[k] != preset[k]}


def run_arm(work, out, arm, paths=None, cut=None, **kw) -> dict:
    """Train ``arm`` on the recipe fixture under ``work``; ``cut``
    overrides the scaled schedule (iterations, log_step, test_iter) after
    the scaling.  Saves ``fast_<arm>`` with the JAX script's keys and
    returns the whole summary."""
    cfg = ARMS[arm](common.train_fixture(work), **kw)
    cfg.update(cut or {})
    res = train_arm(cfg, Path(work) / f"ckpt_fast_{arm}", f"fast_{arm}",
                    paths)
    res.update(batch=cfg["batch_size"], lr=cfg["lr"],
               samples=cfg["batch_size"] * cfg["iterations"])
    save(out, f"fast_{arm}", {k: res[k] for k in
                              ("best_F1", "wall_min", "steps", "batch", "lr",
                               "samples", "ckpt")})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="b16")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--work", default=str(common.WORK))
    ap.add_argument("--out", default=None,
                    help="results JSON (default <work>/fast_results.json)")
    a = ap.parse_args(argv)
    out = a.out or os.path.join(a.work, "fast_results.json")
    os.makedirs(a.work, exist_ok=True)
    dev = str(common.device_of(a.device))
    for arm in a.arms.split(","):
        if arm not in ARMS:
            raise SystemExit(f"unknown arm {arm}")
        log(f"=== arm {arm}")
        run_arm(a.work, out, arm, device=dev)
    log("done")


if __name__ == "__main__":
    main()
