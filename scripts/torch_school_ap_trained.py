"""School-detection AP under trained weights: the port's counterpart of
``scripts/school_ap_trained.py``.

With ``--iterations N`` it first trains the reference recipe (bf16) on
the recipe fixture (``torch_check_common.train_fixture``: train year 2017,
held-out validation year 2016) through ``run_training``; ``--ckpt``
skips training.  Then ``school_eval_survey`` (threshold 0.5, the other
knobs at their defaults) scores the held-out 2016 survey, or with
``--big-val`` the big held-out fixture: 14 echograms of 700 x 400 with
12 schools each (seed 77), whose many small schools give each category
enough ground truth for AP to resolve steps of about 1/50 in recall.

    python scripts/torch_school_ap_trained.py --iterations 15000 --big-val
    python scripts/torch_school_ap_trained.py --ckpt best.msgpack --big-val

Prints one JSON line: AP@.25/.5/.75, recall, detections and ground truth
per category, and the mAP.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import torch_check_common as common  # noqa: E402

# ground-truth schools per category of the big held-out fixture, the same
# in both packages (tests/test_torch_trained_checks.py)
BIG_VAL_GT = {"sandeel": 81, "other": 76}


def ensure_big_val_fixture(work, n_echograms=14) -> str:
    """The big held-out survey: 14 memmap echograms of 700 x 400, 12
    schools each, year 2016, seed 77 (school sizes scale with an
    echogram's width, so many small echograms give many schools)."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    memm = Path(work) / f"memm_bigval_{n_echograms}"
    common.cached(memm / "marker.ok", lambda: make_survey_dir(
        memm, year=2016, n_echograms=n_echograms, H=700, W=400, seed=77,
        n_schools=12))
    return str(memm)


def train(work, iterations, device, model=None):
    """The reference recipe through ``run_training`` for ``iterations``
    steps; returns (checkpoint path, summary)."""
    from crimac_unet_tpu_torch.pipeline.train import run_training
    cfg = common.recipe_config(common.train_fixture(work),
                               iterations=iterations,
                               log_step=max(iterations // 6, 1),
                               device=str(device), **(model or {}))
    ckpt_dir = Path(work) / "ckpt"
    t0 = time.perf_counter()
    sp = run_training(cfg, str(ckpt_dir), progress=False)
    common.synchronize(device)
    return ckpt_dir / "best.msgpack", {
        "best_F1": float(sp.best_F1_val),
        "train_min": (time.perf_counter() - t0) / 60,
        "steps": int(sp.state.step)}


def run(ckpt, val_dir, device="cuda", model=None, paths=None,
        save_dir=None) -> dict:
    """School evaluation of the 2016 echograms under ``val_dir`` with the
    weights ``ckpt``; ``save_dir`` gets the metrics and detection CSVs."""
    import os

    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.pipeline.school_eval import school_eval_survey
    dev = common.device_of(device)
    runner = common.make_runner(common.state_dict(ckpt),
                                common.model_config(model), dev)
    readers = get_echograms(years=[2016], path_to_echograms=str(val_dir),
                            minimum_shape=50)
    paths = paths if paths is not None else common.Paths()
    save = {} if save_dir is None else {
        "save_path_metrics": os.path.join(save_dir, "2016_school_eval.csv"),
        "save_path_detections": os.path.join(save_dir, "2016_schools.csv")}
    t0 = time.perf_counter()
    with paths.path("school_ap", runner):
        m = school_eval_survey(runner, readers, preload_n_pings=1000,
                               prob_threshold=0.5, **save)
    return {"mean_ap": m["mean_ap"], "categories": m["categories"],
            "n_echograms": len(readers),
            "eval_s": time.perf_counter() - t0, "launches": paths.counts,
            "device": common.card_name(dev)}


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False)
    ap.add_argument("--iterations", type=int, default=15000,
                    help="recipe steps to train first (ignored with --ckpt)")
    ap.add_argument("--big-val", action="store_true",
                    help="score the big held-out fixture instead of the "
                         "recipe fixture's 2016 survey")
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    ckpt, summary = args.ckpt, {}
    if ckpt is None:
        ckpt, summary = train(args.work, args.iterations, dev)
    if args.big_val:
        val_dir = ensure_big_val_fixture(args.work)
    else:
        val_dir = common.train_fixture(args.work)
    res = run(ckpt, val_dir, dev, save_dir=args.work)
    res.update(summary, ckpt=str(ckpt))
    for name, cm in res["categories"].items():
        print(f"[{name}] AP@.25/.5/.75 = "
              + "/".join(f"{a:.3f}" for a in cm["ap"])
              + f", recall {cm['recall'][0]:.3f}@.25, "
                f"{cm['n_detections']} det / {cm['n_gt']} gt", flush=True)
    common.finish(res, args.out)


if __name__ == "__main__":
    main()
