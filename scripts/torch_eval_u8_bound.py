"""How far bfloat16 and uint8 transfer move the port's gridded evaluation
under trained weights: the port's counterpart of
``scripts/eval_u8_bound.py``.

``evaluate_reader`` over the bench survey at full width with
``transfer_dtype`` float32, bfloat16 and uint8: the max F1 of each, and
the label chain's invariants, the scored and the positive pixel counts,
which must be equal across the three (the transfer moves scores, never
which pixels are scored).

    python scripts/torch_eval_u8_bound.py --ckpt best.msgpack [--device cuda]

Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

TRANSFERS = ("float32", "bfloat16", "uint8")


def run(ckpt, survey=None, device="cuda", model=None, paths=None) -> dict:
    """The three transfers over ``survey`` (default the bench survey);
    ``paths`` gets each run's launches.  Raises if a transfer changes the
    scored or positive count."""
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    dev = common.device_of(device)
    sd = common.state_dict(ckpt)
    reader = common.zarr_reader(survey or common.bench_survey())
    paths = paths if paths is not None else common.Paths()
    out = {}
    for td in TRANSFERS:
        runner = common.make_runner(
            sd, common.model_config(model, transfer_dtype=td), dev)
        t0 = time.perf_counter()
        with paths.path(f"eval_{td}", runner):
            h = np.asarray(evaluate_reader(runner, reader,
                                           metrics.new_histogram()))
        f1, _ = metrics.max_f1(metrics.pr_curve_from_histogram(h))
        out[td] = {"max_f1": float(f1), "n_scored": int(h.sum()),
                   "n_pos": int(h[0].sum()),
                   "first_pass_s": time.perf_counter() - t0}
    for td in ("bfloat16", "uint8"):
        if (out[td]["n_scored"], out[td]["n_pos"]) != (
                out["float32"]["n_scored"], out["float32"]["n_pos"]):
            raise RuntimeError(f"{td} transfer changed the scored / positive "
                               f"counts: {out[td]} vs {out['float32']}")
        out[td]["dF1_vs_float32"] = (out[td]["max_f1"]
                                     - out["float32"]["max_f1"])
    out.update(launches=paths.counts, device=common.card_name(dev))
    return out


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], bench=True)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.ckpt, sv, args.device), args.out)


if __name__ == "__main__":
    main()
