"""How far uint8 transfer and uint8 outputs move the port's predictions
under trained weights: the port's counterpart of ``scripts/u8_bound.py``.

The bench survey (the JAX package's bench.py survey: 1000 range x 4000
pings x 4 frequencies, seed 3, 24 schools) runs through
``predict_reader`` in four modes at full width (depth 5, start_filts 64,
bf16, patch 256 / overlap 20, fwd_batch 32): ``exact_f32`` (float32
transfer), ``patch_u8`` (uint8 dB-code transfer), ``serving_u8`` (slab
mode + uint8 transfer) and ``serving_out_u8`` (slab + uint8 transfer +
uint8 outputs).  Each of the last three is held to ``exact_f32``: write
masks equal, mean / p99 / max |dprob| over the written pixels, sandeel
max-F1 and |dF1|; the output quantization alone (``serving_out_u8``
against ``serving_u8``) by its max |d| (the 1/510 law), the pixels it
newly zeroes and the largest probability among them.

    python scripts/torch_u8_bound.py --ckpt best.msgpack [--device cuda]

Prints one JSON line (and writes it to ``--out``).  Needs a card unless
``--device cpu``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

MODES = {
    "exact_f32": dict(transfer_dtype="float32"),
    "patch_u8": dict(transfer_dtype="uint8"),
    "serving_u8": dict(transfer_dtype="uint8", infer_mode="slab"),
    # + d2h probability quantization: round(p * 255) codes instead of f16
    "serving_out_u8": dict(transfer_dtype="uint8", infer_mode="slab",
                           output_dtype="uint8"),
}


def readings(outp: dict, lab: np.ndarray) -> dict:
    """Each mode against ``exact_f32`` and the output quantization alone,
    from the modes' (2, n_range, n_pings) predictions and the (range,
    ping) raw labels."""
    base = outp["exact_f32"]
    written = base != 0
    wmask = written[0]
    y = lab[:wmask.shape[0], :wmask.shape[1]][wmask] == 27

    def f1_of(arr):
        return common.max_f1(arr[0][wmask], y)

    f1_base = f1_of(base)
    res = {"f1_exact_f32": f1_base}
    for name in ("patch_u8", "serving_u8", "serving_out_u8"):
        arr = outp[name]
        diff = np.abs(base - arr)[written]
        f1 = f1_of(arr)
        res[name] = {
            "masks_equal": bool(((base == 0) == (arr == 0)).all()),
            "mean_abs_dprob": float(diff.mean()),
            "p99_abs_dprob": float(np.percentile(diff, 99)),
            "max_abs_dprob": float(diff.max()),
            "f1": f1, "abs_dF1": abs(f1 - f1_base)}
    # the output quantization alone: |d| <= 1/510 (+ float16 rounding),
    # and the zero set may grow only by pixels of p < 1/510
    a, b = outp["serving_u8"], outp["serving_out_u8"]
    extra_zero = (b == 0) & (a != 0)
    res["output_u8_isolated"] = {
        "max_abs_dprob": float(np.abs(a - b).max()),
        "n_extra_zero": int(extra_zero.sum()),
        "max_p_at_extra_zero": float(a[extra_zero].max())
        if extra_zero.any() else 0.0,
        "abs_dF1_vs_serving_u8": abs(f1_of(b) - f1_of(a))}
    return res


def run(ckpt, survey=None, device="cuda", model=None, preload_n_pings=1000,
        paths=None, outputs=None) -> dict:
    """The four modes over ``survey`` (a zarr store; default the bench
    survey) with the weights ``ckpt``; ``model`` overrides the flagship
    configuration.  ``paths`` (``common.Paths``) gets each mode's
    launches; ``outputs`` (a dict), where given, each mode's predictions.
    """
    dev = common.device_of(device)
    sd = common.state_dict(ckpt)
    reader = common.zarr_reader(survey or common.bench_survey())
    paths = paths if paths is not None else common.Paths()
    outp = outputs if outputs is not None else {}
    walls = {}
    for name, over in MODES.items():
        runner = common.make_runner(sd, common.model_config(model, **over),
                                    dev)
        with paths.path(f"u8_{name}", runner):
            outp[name], walls[name] = common.predict_survey(
                runner, reader, preload_n_pings)
    n_range, n_pings = outp["exact_f32"].shape[1:]
    res = readings(outp, common.raw_labels(reader, n_range, n_pings))
    res.update(walls_s=walls, launches=paths.counts,
               device=common.card_name(dev))
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], bench=True)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.ckpt, sv, args.device), args.out)


if __name__ == "__main__":
    main()
