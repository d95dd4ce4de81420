"""Metadata-model training at the fast-recipe shape: the port's
counterpart of ``scripts/meta_recipe.py``.

The fast recipe's ``b16_sqrt`` arm (batch 16, lr 0.01, the reference's
60000-crop sample budget) with the six metadata families as early
injected input channels, or with ``--late`` through the late per-pixel
MLP, trained through ``run_training`` on the recipe fixture with the
metadata crops computed on the card from the pooled vectors.  The run
raises when the pooled metadata path did not engage: a silent fallback
to host crops would measure another path.

    python scripts/torch_meta_recipe.py [--late] [--work build/torch_checks] \\
        [--out build/torch_checks/meta_results.json]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from crimac_unet_tpu_torch.config import \
    META_CHANNELS_ALL as ALL_META  # noqa: E402
from scripts import torch_check_common as common  # noqa: E402
from scripts.torch_fast_recipe import fast_config  # noqa: E402
from scripts.torch_r3_session import log, save, train_arm  # noqa: E402


def meta_config(memm, late, **kw) -> dict:
    """``fast_config(memm, 16, 0.01)`` with the six families, early or
    late injected."""
    cfg = fast_config(memm, 16, 0.01, **kw)
    cfg["meta_channels"] = dict(ALL_META)
    cfg["late_meta_inject"] = bool(late)
    return cfg


def run(work, out, late, paths=None, cut=None, **kw) -> dict:
    """Train the early (or late) arm; ``cut`` overrides the schedule.
    Saves ``meta_<arm>`` with the JAX script's keys and returns the whole
    summary; raises when the pooled metadata path did not run."""
    arm = "late" if late else "early"
    cfg = meta_config(common.train_fixture(work), late, **kw)
    cfg.update(cut or {})
    log(f"=== meta recipe ({arm} inject), batch {cfg['batch_size']}, pooled")
    res = train_arm(cfg, Path(work) / f"ckpt_meta_{arm}", f"meta_{arm}",
                    paths)
    res["samples"] = cfg["batch_size"] * cfg["iterations"]
    save(out, f"meta_{arm}", {k: res[k] for k in
                              ("best_F1", "wall_min", "steps", "pooled_meta",
                               "samples", "ckpt")})
    if not res["pooled_meta"]:
        raise RuntimeError(f"meta {arm}: the pooled metadata path did not "
                           "engage (host crops ran instead)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--late", action="store_true",
                    help="late per-pixel-MLP injection instead of early")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--work", default=str(common.WORK))
    ap.add_argument("--out", default=None,
                    help="results JSON (default <work>/meta_results.json)")
    a = ap.parse_args(argv)
    out = a.out or os.path.join(a.work, "meta_results.json")
    os.makedirs(a.work, exist_ok=True)
    run(a.work, out, a.late, device=str(common.device_of(a.device)))
    log("done")


if __name__ == "__main__":
    main()
