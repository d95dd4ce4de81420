"""The serving preset's tiling, overlap 20 against overlap 16, under
trained weights: the port's counterpart of
``scripts/serving_geometry_ab.py``.

The serving preset (slab mode, static grid, uint8 transfer and outputs)
inherits the reference's patch 256 / overlap 20 tiling, whose stride 216
is no multiple of 2^(depth-1) = 16: the slab's pooling grid is then
misaligned with the patch grid, slab outputs differ slightly from patch
mode at every pixel, and ``GriddedRunner`` warns.  Overlap 16 (stride
224) aligns the grids.  For each overlap, on the bench survey at full
width:

  * sandeel max-F1 of the serving arm against the exact patch-mode
    float32 oracle AT THE SAME overlap (each overlap writes its own pixel
    set), and |dF1|;
  * the share of written pixels whose slab probability differs from the
    same-overlap patch-mode uint8 arm by more than 2/255 (two output
    steps), and mean / p99 / max |dprob| against it;
  * the serving arm's best pings/s over ``--passes`` warm passes on one
    runner, and whether its construction warned.

    python scripts/torch_serving_geometry_ab.py --ckpt best.msgpack \\
        [--passes 3] [--device cuda]

Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

SERVING = dict(infer_mode="slab", transfer_dtype="uint8",
               output_dtype="uint8", static_grid=True)


def run(ckpt, survey=None, device="cuda", model=None, passes=3,
        overlaps=(20, 16), preload_n_pings=1000, paths=None) -> dict:
    """Both arms over ``survey`` (default the bench survey); ``overlaps``
    (the misaligned one first) and ``model`` let a small model run it.
    ``paths`` gets each pass group's launches."""
    dev = common.device_of(device)
    sd = common.state_dict(ckpt)
    reader = common.zarr_reader(survey or common.bench_survey())
    paths = paths if paths is not None else common.Paths()
    res = {}

    def once(tag, cfg):
        runner = common.make_runner(sd, cfg, dev)
        with paths.path(tag, runner):
            return common.predict_survey(runner, reader, preload_n_pings)[0]

    for ov in overlaps:
        tag = f"ov{ov}"
        oracle = once(f"geom_{tag}_oracle", common.model_config(
            model, patch_overlap=ov, transfer_dtype="float32"))
        cfg = common.model_config(model, patch_overlap=ov, **SERVING)
        runner, warned = common.make_runner(sd, cfg, dev,
                                            record_warnings=True)
        walls = []
        # one runner for every pass, as a serving process keeps it: the
        # first pass pays cuDNN's plans and the allocator's growth
        with paths.path(f"geom_{tag}_serving", runner):
            arr, _ = common.predict_survey(runner, reader, preload_n_pings)
            for _ in range(passes):
                walls.append(common.predict_survey(runner, reader,
                                                   preload_n_pings)[1])
        # the same-overlap patch-mode uint8 arm isolates the slab's
        # divergence from the input and output quantization
        patch_u8 = once(f"geom_{tag}_patch_u8", common.model_config(
            model, patch_overlap=ov, transfer_dtype="uint8",
            output_dtype="uint8"))
        n_range, n_pings = oracle.shape[1:]
        written = oracle != 0
        wmask = written[0]
        lab = common.raw_labels(reader, n_range, n_pings)
        y = lab[:wmask.shape[0], :wmask.shape[1]][wmask] == 27
        f1_oracle = common.max_f1(oracle[0][wmask], y)
        f1_serving = common.max_f1(arr[0][wmask], y)
        d_slab = np.abs(arr - patch_u8)[written]
        stride = runner.stride[0]
        div = 2 ** (runner.model.depth - 1)
        res[tag] = {
            "stride": stride,
            "aligned": stride % div == 0 and ov % div == 0,
            "warned": warned,
            "pings_per_sec": n_pings / min(walls) if walls else None,
            "pass_walls_s": walls,
            "f1_oracle": f1_oracle, "f1_serving": f1_serving,
            "abs_dF1": abs(f1_serving - f1_oracle),
            "masks_equal_vs_oracle": bool(((oracle == 0) == (arr == 0)
                                           ).all()),
            "slab_vs_patch_u8": {
                "frac_gt_2codes": float((d_slab > 2 / 255).mean()),
                "mean_abs_dprob": float(d_slab.mean()),
                "p99_abs_dprob": float(np.percentile(d_slab, 99)),
                "max_abs_dprob": float(d_slab.max())}}
    res.update(launches=paths.counts, device=common.card_name(dev))
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], bench=True)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.ckpt, sv, args.device, passes=args.passes),
                  args.out)


if __name__ == "__main__":
    main()
