"""Live school-detection throughput: the port's counterpart of
``scripts/school_serving_bench.py``.

Live mode is a full predict pass streamed through the per-category
connected components (``detect_reader_schools(runner, reader, 1000)``)
over the bench survey (1000 range x 4000 pings x 4 frequencies, seed 3)
at full width (depth 5, start_filts 64, bf16, patch 256 / overlap 20,
fwd_batch 32).  Two arms: ``patch+bf16`` (the defaults) and ``serving``
(``infer_mode: slab``, ``transfer_dtype: uint8``, ``static_grid: true``,
the runner built with its alignment warning silenced as the JAX script
builds it).  Per arm: one warm call, then the best of two timed calls as
pings/s, and the detections per category.  Each timed call is followed
by a timed pass of the same runner's ``predict_reader`` alone (the same
chunks brought to the host, no detector): the live wall less the best
prediction wall is the detector's share, both read in one process.  Then
each arm's store law
(JAX ``tests/test_school_eval.py::test_detect_store_schools_matches_live``):
the same runner writes the survey's prediction store
(``save_survey_predictions_zarr``) and ``detect_store_schools`` reads it
back; its detections must equal the live ones.  Without ``--ckpt`` the
weights are seeded, as the JAX script's random init.

    python scripts/torch_school_serving_bench.py [--ckpt best.msgpack] \\
        [--device cuda] [--pings 4000]

Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import torch_check_common as common  # noqa: E402

ARMS = {"patch+bf16": {},
        "serving": dict(infer_mode="slab", transfer_dtype="uint8",
                        static_grid=True)}
CATEGORIES = {0: "sandeel", 1: "other"}


def detection_keys(dets: dict) -> dict:
    """{channel: sorted (box, pixels, score)}: a detector's output in an
    order-free form."""
    return {ch: sorted((tuple(int(v) for v in d["bounding_box"]),
                        int(d["n_pixels"]), float(d["score"])) for d in ds)
            for ch, ds in dets.items()}


def run(state_dict=None, survey=None, device="cuda", model=None, passes=2,
        preload_n_pings=1000, prob_threshold=0.5, paths=None, outputs=None,
        log=print) -> dict:
    """Both arms over ``survey`` (default the bench survey) with
    ``state_dict`` (seeded weights when None) at ``prob_threshold`` (the
    detector's default 0.5).  ``paths`` gets each arm's
    live calls (``detect_<arm>``) and its store write
    (``detect_<arm>_store``); ``outputs``, where given, each arm's live
    detections."""
    import numpy as np

    from crimac_unet_tpu_torch.pipeline.predict import (
        predict_reader, save_survey_predictions_zarr)
    from crimac_unet_tpu_torch.pipeline.school_eval import (
        detect_reader_schools, detect_store_schools)
    from scripts.torch_roofline import seeded_state_dict
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = common.state_dict(state_dict) if state_dict is not None \
        else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    n_pings = reader.shape[0]
    paths = paths if paths is not None else common.Paths()
    res = {}
    for tag, extra in ARMS.items():
        runner = common.make_runner(sd, dict(cfg, **extra), dev)
        name = "detect_" + tag.split("+")[0]
        walls, pwalls = [], []
        with paths.path(name, runner):
            detect_reader_schools(runner, reader, preload_n_pings,
                                  prob_threshold)                  # warm
            for _ in range(passes):
                t0 = time.perf_counter()
                dets = detect_reader_schools(runner, reader, preload_n_pings,
                                             prob_threshold)
                common.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                for _, _, pred, _ in predict_reader(runner, reader,
                                                    preload_n_pings):
                    np.asarray(pred)
                common.synchronize(dev)
                pwalls.append(time.perf_counter() - t0)
        with tempfile.TemporaryDirectory() as td:
            store = str(Path(td) / f"{reader.name}_pred.zarr")
            with paths.path(name + "_store", runner):
                save_survey_predictions_zarr(runner, reader, store,
                                             preload_n_pings=preload_n_pings)
            stored = detect_store_schools(store, reader, prob_threshold,
                                          chunk_pings=preload_n_pings)
        n = {CATEGORIES[ch]: len(v) for ch, v in dets.items()}
        detector_s = min(walls) - min(pwalls)
        res[tag] = {"pings_per_sec": n_pings / min(walls), "walls_s": walls,
                    "predict_pings_per_sec": n_pings / min(pwalls),
                    "predict_walls_s": pwalls, "detector_s": detector_s,
                    "detector_share": detector_s / min(walls),
                    "n_detections": n,
                    "store_equal": detection_keys(stored)
                    == detection_keys(dets)}
        if outputs is not None:
            outputs[tag] = dets
        log(f"# live school detection [{tag}]: "
            f"{res[tag]['pings_per_sec']:.1f} pings/s ({sum(n.values())} "
            f"detections {n}), prediction alone "
            f"{res[tag]['predict_pings_per_sec']:.1f} pings/s, detector "
            f"share {res[tag]['detector_share']:.3f}, store detections equal: "
            f"{res[tag]['store_equal']}")
    res.update(launches=paths.counts, device=common.card_name(dev))
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)      # raises without a card first
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.ckpt, sv, dev), args.out)


if __name__ == "__main__":
    main()
