"""Detector post-processing sweep under trained weights: the port's
counterpart of ``scripts/school_postproc_sweep.py``.

The recipe's checkpoint (``--ckpt``; without it the reference recipe is
trained first through ``torch_school_ap_trained.train``, ``--iterations``
steps) predicts the big held-out fixture (14 echograms of 700 x 400, 81
sandeel and 76 other schools) once into ``.npy`` stores
(``save_reader_predictions_memm``, ``resume_writing=True``).  Then the
64-point grid (score threshold {0.5, 0.7, 0.8, 0.9} x min_area {1, 9, 25,
64} x merge_gap {0, 8, 16, 32}) re-detects from those stores on the host
(``school_eval_survey(None, ..., from_predictions=)``): per point AP@0.25
and @0.5, recall@0.25 and detections per category.  The operating point
maximizes the mean AP@0.25 over the two categories among the points with
at most 3x the ground truth's detections in each (every point when none
has); the baseline is threshold 0.5, min_area 1, merge_gap 0.  Only the
predict pass touches the card; the sweep's wall is reported apart.

    python scripts/torch_school_postproc_sweep.py [--ckpt best.msgpack] \\
        [--iterations 15000] [--device cuda]

Prints one JSON line (and writes ``n_gt``, ``rows``, ``baseline`` and
``chosen`` to ``--out``, default ``<work>/sweep.json``).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_school_ap_trained  # noqa: E402

THRS = (0.5, 0.7, 0.8, 0.9)
AREAS = (1, 9, 25, 64)
GAPS = (0, 8, 16, 32)


def log(msg):
    print(f"[sweep {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def row_of(metrics: dict, thr, area, gap) -> dict:
    """One grid point's row, the JAX script's keys and rounding."""
    row = {"thr": thr, "min_area": area, "merge_gap": gap}
    for name, cm in metrics["categories"].items():
        row[f"{name}_ap25"] = round(cm["ap"][0], 4)
        row[f"{name}_ap50"] = round(cm["ap"][1], 4)
        row[f"{name}_recall25"] = round(cm["recall"][0], 4)
        row[f"{name}_ndet"] = cm["n_detections"]
    return row


def choose(rows: list, n_gt: dict) -> tuple:
    """(baseline, chosen): the (0.5, 1, 0) row and the row of the best
    mean AP@0.25 within the 3x-ground-truth detection budget."""
    def ok(r):
        return (r["sandeel_ndet"] <= 3 * n_gt["sandeel"]
                and r["other_ndet"] <= 3 * n_gt["other"])

    def score(r):
        return (r["sandeel_ap25"] + r["other_ap25"]) / 2

    eligible = [r for r in rows if ok(r)] or rows
    best = max(eligible, key=score)
    base = next(r for r in rows if r["thr"] == 0.5 and r["min_area"] == 1
                and r["merge_gap"] == 0)
    return base, best


def sweep(readers, pred_dir, n_gt, thrs=THRS, areas=AREAS, gaps=GAPS,
          preload_n_pings=1000, log=log) -> dict:
    """The grid from the stores under ``pred_dir`` (host work)."""
    from crimac_unet_tpu_torch.pipeline.school_eval import school_eval_survey
    rows = []
    for thr, area, gap in itertools.product(thrs, areas, gaps):
        m = school_eval_survey(None, readers, preload_n_pings=preload_n_pings,
                               prob_threshold=thr, min_area=area,
                               merge_gap=gap, from_predictions=str(pred_dir))
        rows.append(row_of(m, thr, area, gap))
        log(f"thr={thr} area={area} gap={gap}: " + " ".join(
            f"{k}={v}" for k, v in rows[-1].items()
            if k.endswith(("ap25", "ndet"))))
    base, best = choose(rows, n_gt)
    return {"n_gt": n_gt, "rows": rows, "baseline": base, "chosen": best}


def run(ckpt, val_dir, pred_dir, device="cuda", model=None, thrs=THRS,
        areas=AREAS, gaps=GAPS, preload_n_pings=1000, paths=None,
        log=log) -> dict:
    """Predict the 2016 echograms under ``val_dir`` into ``pred_dir``
    (emptied first) with the weights ``ckpt``, sweep the grid from the
    stores, then run ``school_eval_survey`` live with the same runner at
    the baseline's and the chosen point's settings (their rows under
    ``live``).  ``paths`` gets the predict pass
    (``sweep_predict``) and the live runs (``sweep_live``)."""
    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_reader_predictions_memm
    from crimac_unet_tpu_torch.pipeline.school_eval import (
        gt_boxes_by_category, school_eval_survey)
    dev = common.device_of(device)
    runner = common.make_runner(common.state_dict(ckpt),
                                common.model_config(model), dev)
    readers = get_echograms(years=[2016], path_to_echograms=str(val_dir),
                            minimum_shape=50)
    log(f"validation survey: {len(readers)} echograms")
    paths = paths if paths is not None else common.Paths()
    pred_dir = Path(pred_dir)
    shutil.rmtree(pred_dir, ignore_errors=True)
    pred_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    with paths.path("sweep_predict", runner):
        for r in readers:
            save_reader_predictions_memm(
                runner, r, str(pred_dir / (r.name + "_pred.npy")),
                preload_n_pings=preload_n_pings, resume_writing=True)
    predict_s = time.perf_counter() - t0
    log(f"predictions written in {predict_s:.1f}s")

    n_gt = {}
    for r in readers:
        g = gt_boxes_by_category(r, [27, 1])
        for code, name in ((27, "sandeel"), (1, "other")):
            n_gt[name] = n_gt.get(name, 0) + len(g[code])
    log(f"ground truth: {n_gt}")
    t0 = time.perf_counter()
    res = sweep(readers, pred_dir, n_gt, thrs, areas, gaps, preload_n_pings,
                log)
    sweep_s = time.perf_counter() - t0
    log(f"sweep: {len(res['rows'])} points in {sweep_s / 60:.1f} min")
    log(f"baseline (thr=.5, area=1, gap=0): {res['baseline']}")
    log(f"chosen operating point: {res['chosen']}")
    res["live"] = {}
    with paths.path("sweep_live", runner):
        for key in ("baseline", "chosen"):
            r = res[key]
            m = school_eval_survey(
                runner, readers, preload_n_pings=preload_n_pings,
                prob_threshold=r["thr"], min_area=r["min_area"],
                merge_gap=r["merge_gap"])
            res["live"][key] = row_of(m, r["thr"], r["min_area"],
                                      r["merge_gap"])
    pings = sum(r.shape[1] for r in readers)
    res.update(n_echograms=len(readers), n_pings=pings, predict_s=predict_s,
               sweep_s=sweep_s, sweep_s_per_point=sweep_s / len(res["rows"]),
               launches=paths.counts, device=common.card_name(dev))
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False)
    ap.add_argument("--iterations", type=int, default=15000,
                    help="recipe steps to train first (ignored with --ckpt)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.work, "sweep.json")
    dev = common.device_of(args.device)
    ckpt, summary = args.ckpt, {}
    if ckpt is None:
        ckpt = Path(args.work) / "ckpt" / "best.msgpack"
        if ckpt.is_file():
            log(f"reusing checkpoint {ckpt}")
        else:
            ckpt, summary = torch_school_ap_trained.train(
                args.work, args.iterations, dev)
            log(f"trained {summary['steps']} steps in "
                f"{summary['train_min']:.1f} min, best F1 "
                f"{summary['best_F1']:.4f}")
    val_dir = torch_school_ap_trained.ensure_big_val_fixture(args.work)
    res = run(ckpt, val_dir, Path(args.work) / "preds_bigval", dev)
    res.update(summary, ckpt=str(ckpt))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({k: res[k] for k in ("n_gt", "rows", "baseline", "chosen")},
                  f, indent=1, default=float)
    log(f"results -> {out}")
    common.finish({k: v for k, v in res.items() if k != "rows"})


if __name__ == "__main__":
    main()
