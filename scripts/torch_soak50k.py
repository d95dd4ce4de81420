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

Per chunk (``chunks``, :class:`ChunkLog`) it also reports where the
host memory sits as the call goes: the RSS, the count of distinct
U-Net input shapes seen so far (every distinct shape is one more set of
cuDNN plans), the pinned host cache behind ``pin_memory()``
(``torch.cuda.host_memory_stats``) and glibc's malloc counters (in use,
free in the arenas, mmapped).  ``--control`` adds the soak again with
``static_grid: true`` (one grid shape for every chunk), ``--repeat N``
the same soak N more times in the process.

    python scripts/torch_soak50k.py patch [--pings 50000] [--ckpt best.msgpack]
    python scripts/torch_soak50k.py slab --pings 20000 --control --repeat 1
    python scripts/torch_soak50k.py eval uint8

Without ``--ckpt`` the weights are seeded random ones, as in the JAX
script.  Prints one JSON line.
"""

from __future__ import annotations

import ctypes
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


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def malloc_counters() -> dict | None:
    """glibc's ``mallinfo2`` over every arena: bytes handed out
    (``in_use``, mmapped blocks included), free inside the arenas
    (``free``) and mmapped (``mmap``); None where the C library has no
    ``mallinfo2`` (not glibc, or older than 2.33)."""
    try:
        fn = ctypes.CDLL(None).mallinfo2
    except (OSError, AttributeError):
        return None
    fn.restype = _MallInfo2
    m = fn()
    return {"in_use": m.uordblks + m.hblkhd, "free": m.fordblks,
            "mmap": m.hblkhd}


def pinned_counters(device) -> dict | None:
    """The pinned host cache's byte and block counts
    (``torch.cuda.host_memory_stats``: the ``*bytes.current`` keys and
    the count of blocks it has pinned and unpinned); None off a card."""
    if torch.device(device).type != "cuda" or not hasattr(
            torch.cuda, "host_memory_stats"):
        return None
    return {k: int(v) for k, v in torch.cuda.host_memory_stats().items()
            if k.endswith("bytes.current")
            or k in ("num_host_alloc", "num_host_free")}


class ChunkLog:
    """Per-chunk host memory of one streaming call: after each chunk's
    device work is enqueued (``_mask_output`` in prediction,
    ``_eval_patches`` in evaluation) a row of the seconds since the
    call began, the RSS, the count of distinct U-Net input shapes so
    far, the pinned host cache and the malloc counters; and the RSS just
    after the reader's seabed scan (``scan_rss``), which a call runs
    before its first chunk.  Installed on one runner and its reader for
    a ``with`` block."""

    def __init__(self, runner, reader, device):
        self.runner, self.reader, self.device = runner, reader, device
        self.rows: list = []
        self.shapes: set = set()
        self.scan_rss = None

    def _sample(self):
        self.rows.append({"chunk": len(self.rows),
                          "t_s": time.perf_counter() - self.t0,
                          "rss_bytes": common.vm_rss_bytes(),
                          "forward_shapes": len(self.shapes),
                          "pinned": pinned_counters(self.device),
                          "malloc": malloc_counters()})

    def __enter__(self):
        r = self.runner
        self.t0 = time.perf_counter()
        self._hook = r.model.register_forward_pre_hook(
            lambda _m, args: self.shapes.add(tuple(args[0].shape)))
        for site in ("_mask_output", "_eval_patches"):
            real = getattr(r, site)

            def spy(*a, _real=real, **k):
                out = _real(*a, **k)
                self._sample()
                return out
            setattr(r, site, spy)
        real_seabed = self.reader.get_seabed

        def seabed(*a, **k):
            out = real_seabed(*a, **k)
            if self.scan_rss is None:
                self.scan_rss = common.vm_rss_bytes()
            return out
        self.reader.get_seabed = seabed
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        for site in ("_mask_output", "_eval_patches"):
            delattr(self.runner, site)
        del self.reader.get_seabed
        return False


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
        transfer=None, out=None, paths=None, preload_n_pings=1000,
        static_grid=False) -> dict:
    """One streaming call of ``mode`` over ``survey`` (a zarr store) with
    the weights ``ckpt`` (None: seeded random); ``out`` is the prediction
    store (patch / slab); ``static_grid`` runs every chunk on one grid
    shape (the launch path is then ``soak_<mode>_static``)."""
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
                              transfer_dtype=td, static_grid=static_grid)
    sd = _seeded_weights(cfg) if ckpt is None else common.state_dict(ckpt)
    reader = common.zarr_reader(survey)
    n_pings, n_range = reader.shape
    runner = common.make_runner(sd, cfg, dev)
    paths = paths if paths is not None else common.Paths()
    res = {"mode": mode, "transfer_dtype": td, "static_grid": static_grid,
           "n_pings": n_pings, "n_range": n_range,
           "codec_backend": blosc_codec.backend(),
           "survey_compressor": reader.sv.compressor}
    name = f"soak_{mode}" + (f"_{td}" if is_eval else "") \
        + ("_static" if static_grid else "")
    # the RSS is sampled around the call alone, whose wall it times: its
    # peak then falls inside that wall
    with common.device_peak(dev, res), paths.path(name, runner), \
            ChunkLog(runner, reader, dev) as log:
        with common.RssPeak() as rss:
            if is_eval:
                hist = np.asarray(evaluate_reader(runner, reader,
                                                  metrics.new_histogram()))
            else:
                save_survey_predictions_zarr(
                    runner, reader, str(out),
                    preload_n_pings=preload_n_pings)
            common.synchronize(dev)
        wall = rss.wall_s
    res.update(wall_s=wall, pings_per_sec=n_pings / wall,
               rss_before_bytes=rss.before, rss_peak_bytes=rss.peak,
               rss_delta_bytes=rss.delta_bytes, rss_peak_s=rss.peak_s,
               rss_after_scan_bytes=log.scan_rss,
               timers=runner.timer.summary(), launches=paths.counts[name],
               device=common.card_name(dev), chunks=log.rows,
               forward_shapes=sorted(map(list, log.shapes)))
    if is_eval:
        res.update(n_scored=int(hist.sum()), n_pos=int(hist[0].sum()))
    else:
        res.update(read_store(out, reader))
    return res


def scan_line(res) -> str:
    """The run's RSS before it, after its seabed scan and at its peak
    (MiB), and when the peak came."""
    mb = 2 ** -20
    scan = res["rss_after_scan_bytes"]
    return (f"RSS before {res['rss_before_bytes'] * mb:.1f}, after the "
            f"seabed scan "
            + ("n/a" if scan is None else f"{scan * mb:.1f}")
            + f", peak {res['rss_peak_bytes'] * mb:.1f} at "
              f"{res['rss_peak_s']:.3f} s of {res['wall_s']:.3f} s: delta "
              f"{res['rss_delta_bytes'] * mb:.1f} MiB")


def chunk_lines(res, every=1) -> list:
    """The per-chunk rows of a run as text: every ``every``-th chunk and
    the last, in MiB."""
    mb = 2 ** -20
    rows = res["chunks"]
    lines = []
    for r in rows[::every] + ([rows[-1]] if (len(rows) - 1) % every
                              else []):
        pin = r["pinned"] or {}
        mal = r["malloc"] or {}
        lines.append(
            f"    chunk {r['chunk']:3d} at {r['t_s']:6.3f} s: RSS "
            f"{r['rss_bytes'] * mb:8.1f}, "
            f"shapes {r['forward_shapes']}, pinned "
            + (", ".join(f"{k} {v * mb:.1f}" if "bytes" in k else f"{k} {v}"
                         for k, v in pin.items()) or "n/a")
            + ", malloc " + (", ".join(f"{k} {v * mb:.1f}"
                                       for k, v in mal.items()) or "n/a"))
    return lines


def timer_lines(res) -> list:
    """The run's ``PhaseTimer`` summary as text: each phase's wall, its
    threads' CPU and its count, each counter's sum."""
    lines = []
    for name, st in sorted(res["timers"].items()):
        if "count" in st:
            lines.append(f"  {name:16s} count {st['count']}  n={st['n']}")
        else:
            lines.append(f"  {name:16s} total {st['total_s']:8.3f}s  "
                         f"n={st['n']}" + (f"  cpu {st['cpu_s']:8.3f}s"
                                           if "cpu_s" in st else ""))
    return lines


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
    ap.add_argument("--control", action="store_true",
                    help="also stream the soak with static_grid: true "
                         "(patch and slab)")
    ap.add_argument("--repeat", type=int, default=0,
                    help="stream the soak this many more times")
    args = ap.parse_args(argv)
    sv = ensure_fixture(args.work, args.pings)
    # the same mode over the bench survey first, in this process: the
    # soak's RSS delta and device peak are then read warm, beside a
    # 4000-ping reference (as chip_smoke.py phase 19 reads them)
    ref = run(args.mode, args.ckpt, common.bench_survey(args.work),
              args.device, transfer=args.transfer,
              out=Path(args.work) / f"pred_{args.mode}_ref.zarr")
    arms = [("soak", False)] * (1 + args.repeat)
    if args.control and args.mode != "eval":
        arms.append(("control", True))
    runs = [("ref", ref)]
    for label, static in arms:
        runs.append((label, run(
            args.mode, args.ckpt, sv, args.device, transfer=args.transfer,
            out=Path(args.work) / f"pred_{args.mode}.zarr",
            static_grid=static)))
    for label, r in runs:
        print(f"{label} ({r['n_pings']} pings, static_grid "
              f"{r['static_grid']}): {scan_line(r)}, "
              f"{len(r['forward_shapes'])} forward shapes "
              f"{r['forward_shapes']}", flush=True)
        print("\n".join(chunk_lines(r)), flush=True)
    res = runs[1][1]
    res["ref"] = {k: ref[k] for k in ("n_pings", "wall_s", "pings_per_sec",
                                      "rss_delta_bytes", "peak_device_bytes")}
    res["arms"] = [{"label": label, **{k: r[k] for k in (
        "n_pings", "static_grid", "rss_before_bytes", "rss_delta_bytes",
        "pings_per_sec", "forward_shapes")}} for label, r in runs]
    print("\n".join(timer_lines(res)), flush=True)
    common.finish(res, args.out)


if __name__ == "__main__":
    main()
