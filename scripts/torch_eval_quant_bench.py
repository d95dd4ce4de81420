"""Evaluation throughput at each transfer dtype: the port's counterpart of
``scripts/eval_quant_bench.py``.

``evaluate_reader`` (eval_mode ``all``) over the bench survey (the JAX
package's bench.py survey: 1000 range x 4000 pings x 4 frequencies, seed
3, 24 schools) at full width (depth 5, start_filts 64, bf16, patch 256 /
overlap 20, fwd_batch 32) with ``transfer_dtype`` float32, bfloat16 and
uint8: per dtype one warm pass, then the best of two timed passes as
pings/s (each pass ends in ``torch.cuda.synchronize()``).  The label
chain's invariants hold across the dtypes: against float32, the
histogram total and its class-0 row sum are identical for the other two
(the run raises otherwise), and each one's |dF1| against float32 is
reported.  Without ``--ckpt`` the weights are seeded, as the JAX script's
random init.

    python scripts/torch_eval_quant_bench.py [--ckpt best.msgpack] \\
        [--device cuda] [--pings 4000]

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


def invariants(hists: dict) -> dict:
    """Each dtype's histogram against float32's: raises if the total or
    the class-0 row sum differs; returns {dtype: (F1, |dF1|)}."""
    from crimac_unet_tpu_torch.ops import metrics
    h32 = hists["float32"]
    f1 = {td: float(metrics.max_f1(metrics.pr_curve_from_histogram(h))[0])
          for td, h in hists.items()}
    for td in TRANSFERS[1:]:
        h = hists[td]
        if h.sum() != h32.sum() or h[0].sum() != h32[0].sum():
            raise RuntimeError(
                f"{td} transfer changed the label chain: total {h.sum()} "
                f"vs {h32.sum()}, class-0 row {h[0].sum()} vs "
                f"{h32[0].sum()}")
    return {td: (f1[td], abs(f1[td] - f1["float32"])) for td in hists}


def run(state_dict=None, survey=None, device="cuda", model=None, passes=2,
        paths=None, log=print) -> dict:
    """The three transfers over ``survey`` (default the bench survey)
    with ``state_dict`` (seeded weights when None); ``paths`` gets each
    dtype's launches over its warm and timed passes."""
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from scripts.torch_roofline import seeded_state_dict
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = common.state_dict(state_dict) if state_dict is not None \
        else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    n_pings = reader.shape[0]
    paths = paths if paths is not None else common.Paths()

    def one_pass(runner):
        t0 = time.perf_counter()
        # a host int64 histogram: the pass has drained its last group
        h = np.asarray(evaluate_reader(runner, reader,
                                       metrics.new_histogram()))
        common.synchronize(dev)
        return h, time.perf_counter() - t0

    res, hists = {}, {}
    for td in TRANSFERS:
        runner = common.make_runner(sd, dict(cfg, transfer_dtype=td), dev)
        with paths.path(f"evalq_{td}", runner):
            hists[td], first = one_pass(runner)
            log(f"# {td}: first pass {first:.1f}s")
            walls = []
            for i in range(passes):
                walls.append(one_pass(runner)[1])
                dt = walls[-1]
                log(f"# {td} pass {i}: {n_pings / dt:.1f} pings/s")
        res[td] = {"pings_per_sec": n_pings / min(walls), "walls_s": walls,
                   "first_pass_s": first, "n_scored": int(hists[td].sum()),
                   "n_pos": int(hists[td][0].sum())}
    for td, (f1, d) in invariants(hists).items():
        res[td].update(f1=f1, abs_dF1_vs_float32=d)
        if td != "float32":
            log(f"# {td}: label-chain invariants exact; F1 {f1:.5f} vs f32 "
                f"{res['float32']['f1']:.5f} (|d|={d:.2e})")
    return {"eval_pings_per_sec": {td: res[td]["pings_per_sec"]
                                   for td in TRANSFERS},
            "transfers": res, "launches": paths.counts,
            "device": common.card_name(dev)}


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)      # raises without a card first
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.ckpt, sv, dev), args.out)


if __name__ == "__main__":
    main()
