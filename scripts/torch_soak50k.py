"""Streaming prediction and evaluation of a 50 000-ping survey on one card:
the port's counterpart of ``scripts/soak50k.py``.

Builds once (cached under ``--work``, in a child process so its memory
stays out of this one's) a 1000-range x ``--pings`` x 4-frequency zarr
survey (seed 9, 200 schools) and streams it through one call at full
width:

  * ``patch`` / ``slab``: ``save_survey_predictions_zarr`` in that
    ``infer_mode`` (bfloat16 transfer), the store read back afterwards;
  * ``eval [uint8|bfloat16|float32]``: ``evaluate_reader`` (the full
    label chain and PR histogram, no store) at that transfer (default
    uint8).

It reports the wall, pings/s, the runner's PhaseTimer, the peak device
memory of the call (``max_memory_allocated`` after a reset) and its host
RSS delta (the largest ``VmRSS`` sampled during the call minus the value
just before it), the codec backend and the survey's compressor (a
machine without libblosc writes and reads zlib on the pure codec).  The
command line first streams the bench survey (4000 pings) the same way in
the same process, so the soak is read warm, and reports that run as
``ref``.

    python scripts/torch_soak50k.py patch [--pings 50000] [--ckpt best.msgpack]
    python scripts/torch_soak50k.py eval uint8

Without ``--ckpt`` the weights are seeded random ones, as in the JAX
script.  Prints one JSON line.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

N_PINGS, N_RANGE = 50_000, 1000
MODES = ("patch", "slab", "eval")
FIXTURE_TIMEOUT_S = 3000      # the 50 000-ping survey takes minutes


def _fixture_root(work, n_pings, n_range) -> Path:
    return Path(work) / f"soak_{n_pings}x{n_range}"


def fixture_path(work, n_pings=N_PINGS, n_range=N_RANGE) -> str:
    return str(_fixture_root(work, n_pings, n_range) / "S2017843_sv.zarr")


def build_fixture(root, n_pings, n_range) -> None:
    """Write the soak survey under ``root`` (what the child runs)."""
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    root = Path(root)
    for stale in root.glob("S2017843_*"):
        shutil.rmtree(stale, ignore_errors=True)
    common.cached(root / "S2017843.ok", lambda: make_zarr_survey(
        root, year=2017, n_echograms=1, H=n_range, W=n_pings, seed=9,
        n_schools=200))


def start_fixture(work, n_pings=N_PINGS, n_range=N_RANGE):
    """Start building the soak survey in a child process unless it is
    cached; returns the child (None when cached)."""
    root = _fixture_root(work, n_pings, n_range)
    if (root / "S2017843.ok").is_file():
        return None
    root.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, __file__, "--build-fixture",
                             str(root), str(n_pings), str(n_range)])


def ensure_fixture(work, n_pings=N_PINGS, n_range=N_RANGE,
                   child=None) -> str:
    """The soak survey's path, built first (or waited for, ``child``)."""
    child = child or start_fixture(work, n_pings, n_range)
    if child is not None:
        t0 = time.perf_counter()
        if child.wait(timeout=FIXTURE_TIMEOUT_S) != 0:
            raise RuntimeError(f"soak fixture build exited {child.returncode}")
        print(f"soak fixture {n_pings} x {n_range} built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fixture_path(work, n_pings, n_range)


def _seeded_weights(cfg):
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    return init_random_(build_unet(cfg), torch.Generator().manual_seed(0)
                        ).state_dict()


def read_store(path, reader) -> dict:
    """What a prediction store holds: its ping count (the joint length of
    the annotation and ping_time), whether its ping times are the
    survey's, and its written pixels."""
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    g = ZGroup.open(str(path))
    ann = g["annotation"]
    pred = ann[:]
    return {"store_shape": list(ann.shape),
            "store_pings": min(ann.shape[1], g["ping_time"].shape[0]),
            "ping_time_equal": bool(np.array_equal(
                g["ping_time"][:], reader.time_vector)),
            "store_finite": bool(np.isfinite(pred).all()),
            "written_px": int((pred != 0).sum()),
            "pings_with_output": int((pred != 0).any(axis=(0, 2)).sum()),
            "store_compressor": ann.compressor}


def run(mode, ckpt=None, survey=None, device="cuda", model=None,
        transfer=None, out=None, paths=None, preload_n_pings=1000) -> dict:
    """One streaming call of ``mode`` over ``survey`` (a zarr store) with
    the weights ``ckpt`` (None: seeded random); ``out`` is the prediction
    store (patch / slab)."""
    from crimac_unet_tpu_torch.data import blosc_codec
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    is_eval = mode == "eval"
    td = transfer or ("uint8" if is_eval else "bfloat16")
    dev = common.device_of(device)
    cfg = common.model_config(model, infer_mode="patch" if is_eval else mode,
                              transfer_dtype=td)
    sd = _seeded_weights(cfg) if ckpt is None else common.state_dict(ckpt)
    reader = common.zarr_reader(survey)
    n_pings, n_range = reader.shape
    runner = common.make_runner(sd, cfg, dev)
    paths = paths if paths is not None else common.Paths()
    res = {"mode": mode, "transfer_dtype": td, "n_pings": n_pings,
           "n_range": n_range, "codec_backend": blosc_codec.backend(),
           "survey_compressor": reader.sv.compressor}
    name = f"soak_{mode}" + (f"_{td}" if is_eval else "")
    with common.RssPeak() as rss, common.device_peak(dev, res), \
            paths.path(name, runner):
        t0 = time.perf_counter()
        if is_eval:
            hist = np.asarray(evaluate_reader(runner, reader,
                                              metrics.new_histogram()))
        else:
            save_survey_predictions_zarr(runner, reader, str(out),
                                         preload_n_pings=preload_n_pings)
        common.synchronize(dev)
        wall = time.perf_counter() - t0
    res.update(wall_s=wall, pings_per_sec=n_pings / wall,
               rss_before_bytes=rss.before, rss_peak_bytes=rss.peak,
               rss_delta_bytes=rss.delta_bytes,
               timers=runner.timer.summary(), launches=paths.counts[name],
               device=common.card_name(dev))
    if is_eval:
        res.update(n_scored=int(hist.sum()), n_pos=int(hist[0].sum()))
    else:
        res.update(read_store(out, reader))
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--build-fixture"]:
        build_fixture(argv[1], int(argv[2]), int(argv[3]))
        return
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False)
    ap.add_argument("mode", nargs="?", default="patch", choices=MODES)
    ap.add_argument("transfer", nargs="?", default=None,
                    choices=("uint8", "bfloat16", "float32"),
                    help="eval's transfer dtype (default uint8)")
    ap.add_argument("--pings", type=int, default=N_PINGS)
    args = ap.parse_args(argv)
    sv = ensure_fixture(args.work, args.pings)
    # the same mode over the bench survey first, in this process: the
    # soak's RSS delta and device peak are then read warm, beside a
    # 4000-ping reference (as chip_smoke.py phase 19 reads them)
    ref = run(args.mode, args.ckpt, common.bench_survey(args.work),
              args.device, transfer=args.transfer,
              out=Path(args.work) / f"pred_{args.mode}_ref.zarr")
    res = run(args.mode, args.ckpt, sv, args.device, transfer=args.transfer,
              out=Path(args.work) / f"pred_{args.mode}.zarr")
    res["ref"] = {k: ref[k] for k in ("n_pings", "wall_s", "pings_per_sec",
                                      "rss_delta_bytes", "peak_device_bytes")}
    for name, st in sorted(res["timers"].items()):
        print(f"  {name:16s} total {st['total_s']:8.3f}s  n={st['n']}",
              flush=True)
    common.finish(res, args.out)


if __name__ == "__main__":
    main()
