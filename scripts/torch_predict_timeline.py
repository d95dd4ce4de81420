"""Absolute-time timeline of one warm prediction pass on the card: the
port's counterpart of ``scripts/predict_timeline.py``.

One warm ``save_survey_predictions_zarr`` pass over the bench survey
(1000 range x 4000 pings x 4 frequencies, seed 3; flagship U-Net, seeded
weights) is logged as (event, thread, t0, t1, MB) intervals, so the wall
decomposes into who blocks whom:

* ``h2d``: ``pipeline/predict.py`` ``_to_device`` (the pinned copy of a
  chunk's host arrays enqueued on the side stream; MB = their bytes);
* ``dispatch_predict`` / ``dispatch_mask``: the runner's
  ``_predict_patches`` (or ``_predict_slab``) and ``_mask_output``
  (the host's enqueue of the chunk's device work);
* every span the program's ``PhaseTimer`` records with ``recording``
  on, on the thread that ran it: ``host_slab`` (with ``host_fill`` and
  ``host_label`` inside) and ``h2d_dispatch`` on the prefetch threads,
  ``pass_head`` (the seabed lookup inside it), ``wait_prefetch``,
  ``device_chunk``, ``device_wait`` (``_drain``'s
  ``event.synchronize()``), ``d2h`` and ``wait_writer`` on the main
  thread, ``zarr_write`` (``write_chunk``) on the writer thread;
* ``device``: beside the host intervals, CUDA events recorded before each
  chunk's dispatch and after its mask, placed on the host clock by an
  event recorded at the start of the pass, so the timeline shows when the
  device held a chunk's work and not only when work was enqueued.  A span
  runs from the chunk's first launch to its last kernel's end, so where
  the host enqueues slower than the device runs, it includes the device
  waiting for launches.

From these: the device-busy share of the wall (the union of the device
spans, an upper bound on the kernels' share) and each thread's busy
share (the union of its intervals).  A fourth pass under
``torch.profiler`` sums the kernels' own device time, read against the
uninstrumented pass's wall (the lower figure).

Every patched attribute is restored in a ``finally``, and the store the
instrumented pass writes is held bit for bit to an uninstrumented pass of
the same configuration.  Two arms: the default bf16 configuration and
the serving preset (``configs/config_serving.yaml``: slab mode, uint8
transfer and output, static grid).

    python scripts/torch_predict_timeline.py [--arms default,serving]
    python scripts/torch_predict_timeline.py --device cpu --pings 1000 \\
        --depth 3 --start-filts 8 --patch 64 --overlap 10

Prints each timeline and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import contextlib
import shutil
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import seeded_state_dict  # noqa: E402

# the serving preset's prediction knobs (config.SERVING_PRESET)
SERVING_KNOBS = ("infer_mode", "transfer_dtype", "output_dtype",
                 "static_grid", "alignment_warning", "pipeline_depth",
                 "fold_bn")
SPY_KINDS = ("h2d", "dispatch_predict", "dispatch_mask")
# the program's spans every pass records
TIMER_KINDS = ("host_slab", "host_fill", "host_label", "h2d_dispatch",
               "device_chunk", "device_wait", "d2h", "zarr_write",
               "pass_head", "seabed_lookup", "wait_prefetch", "wait_writer")
STORE_ARRAYS = ("annotation", "category", "range", "ping_time")


def arm_config(arm, model=None) -> dict:
    """The flagship configuration (``model`` overrides it) of an arm."""
    if arm == "default":
        return common.model_config(model)
    from crimac_unet_tpu_torch.config import SERVING_PRESET
    return common.model_config(model, **{k: SERVING_PRESET[k]
                                         for k in SERVING_KNOBS})


class Log:
    """Intervals (t0, t1, kind, thread, MB) in seconds from ``t0``, on the
    program's span clock (``time.time_ns``)."""

    def __init__(self):
        self.t0 = time.time_ns()
        self.events: list = []
        self._lock = threading.Lock()

    def add(self, kind, t0, t1, mb=0.0, thread=None):
        with self._lock:
            self.events.append(((t0 - self.t0) * 1e-9,
                                (t1 - self.t0) * 1e-9, kind,
                                thread or threading.current_thread().name,
                                mb))

    def add_spans(self, spans):
        """The program's recorded spans, each on its own thread."""
        for name, thread, _, _, t0, t1 in spans:
            self.add(name, t0, t1, thread=thread)


@contextlib.contextmanager
def instrument(runner):
    """Spies on ``predict._to_device`` and the runner's dispatch methods,
    CUDA events around each chunk's device work, and the spans of the
    runner's ``PhaseTimer`` (its ``recording`` on; they join the log on
    the way out); yields ``(log, device)`` where ``device`` collects
    (start, end) event pairs.  Restores every patched attribute and the
    timer's ``recording`` on the way out, also when the body raises."""
    from crimac_unet_tpu_torch.pipeline import predict as P
    log = Log()
    device = {"ref": None, "pairs": []}
    cuda = runner.device.type == "cuda"
    real_put = P._to_device
    timer = runner.timer
    recording = timer.recording
    names = ("_predict_patches", "_predict_slab", "_mask_output")
    real = {n: getattr(runner, n) for n in names}

    def put(r, host, stream):
        t0 = time.time_ns()
        out = real_put(r, host, stream)
        mb = sum(getattr(v, "nbytes", 0) for v in host.values()) / 1e6
        log.add("h2d", t0, time.time_ns(), mb)
        return out

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def dispatch(name):
        def spy(*a, **k):
            if cuda:
                device["pairs"].append([event(), None])
            t0 = time.time_ns()
            out = real[name](*a, **k)
            log.add("dispatch_predict", t0, time.time_ns())
            return out
        return spy

    def mask(*a, **k):
        t0 = time.time_ns()
        out = real["_mask_output"](*a, **k)
        log.add("dispatch_mask", t0, time.time_ns())
        if cuda:
            device["pairs"][-1][1] = event()
        return out

    P._to_device = put
    timer.take_spans()
    timer.recording = True
    runner._predict_patches = dispatch("_predict_patches")
    runner._predict_slab = dispatch("_predict_slab")
    runner._mask_output = mask
    try:
        if cuda:
            torch.cuda.synchronize(runner.device)
            device["ref"] = event()
        log.t0 = time.time_ns()
        yield log, device
    finally:
        P._to_device = real_put
        timer.recording = recording
        log.add_spans(timer.take_spans())
        for n in names:
            runner.__dict__.pop(n, None)


def _union_s(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_intervals(device):
    """(start, end) seconds on the log's clock of each chunk's device work
    (the reference event sits at the log's zero)."""
    if device["ref"] is None:
        return []
    ref = device["ref"]
    ref.synchronize()
    out = []
    for start, end in device["pairs"]:
        end.synchronize()
        out.append((ref.elapsed_time(start) * 1e-3,
                    ref.elapsed_time(end) * 1e-3))
    return out


def stores_equal(a, b) -> bool:
    """Every array of two prediction stores equal bit for bit."""
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    ga, gb = ZGroup.open(a), ZGroup.open(b)
    for name in STORE_ARRAYS:
        x, y = ga[name][:], gb[name][:]
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            return False
    return True


def thread_roles(events) -> dict:
    """Thread name -> its role in the pass: ``main``, ``writer`` (the
    zarr writes), ``prefetch-<k>`` (the chunk staging threads)."""
    kinds: dict = {}
    for _, _, kind, thread, _ in events:
        kinds.setdefault(thread, set()).add(kind)
    roles, k = {}, 0
    for thread in sorted(kinds):
        if thread == "MainThread":
            roles[thread] = "main"
        elif "zarr_write" in kinds[thread]:
            roles[thread] = "writer"
        else:
            roles[thread] = f"prefetch-{k}"
            k += 1
    return roles


def summarize(log: Log, dev_iv, wall: float) -> dict:
    kinds: dict = {}
    threads: dict = {}
    roles = thread_roles(log.events)
    log.events = [(a, b, k, roles[th], mb) for a, b, k, th, mb in log.events]
    for t0, t1, kind, thread, mb in log.events:
        k = kinds.setdefault(kind, {"n": 0, "ms": 0.0, "mb": 0.0})
        k["n"] += 1
        k["ms"] += (t1 - t0) * 1e3
        k["mb"] += mb
        threads.setdefault(thread, []).append((t0, t1))
    busy = {th: _union_s(iv) / wall for th, iv in threads.items()}
    dev_busy = _union_s(dev_iv) / wall if dev_iv else None
    return {"kinds": kinds, "thread_busy_share": busy,
            "device_busy_share": dev_busy,
            "device_ms": sum(b - a for a, b in dev_iv) * 1e3}


def run_arm(arm, sd, reader, work, device, model=None, preload=1000,
            log_fn=print) -> dict:
    """Warm pass, uninstrumented pass, instrumented pass of one arm."""
    dev = common.device_of(device)
    cfg = arm_config(arm, model)
    runner = common.make_runner(sd, cfg, dev)
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr
    n_pings = reader.shape[0]
    paths = {k: Path(work) / f"timeline_{arm}_{k}.zarr"
             for k in ("warm", "plain", "instrumented")}
    for p in paths.values():
        shutil.rmtree(p, ignore_errors=True)
    save_survey_predictions_zarr(runner, reader, str(paths["warm"]),
                                 preload_n_pings=preload)
    t0 = time.perf_counter()
    save_survey_predictions_zarr(runner, reader, str(paths["plain"]),
                                 preload_n_pings=preload)
    tc.synchronize(dev)
    plain_wall = time.perf_counter() - t0
    with instrument(runner) as (log, device_log):
        save_survey_predictions_zarr(runner, reader,
                                     str(paths["instrumented"]),
                                     preload_n_pings=preload)
        tc.synchronize(dev)
        wall = (time.time_ns() - log.t0) * 1e-9
    dev_iv = device_intervals(device_log)
    kernels, kernel_ms = tc.profile_kernels(
        lambda: save_survey_predictions_zarr(
            runner, reader, str(paths["warm"]), preload_n_pings=preload),
        dev)
    res = summarize(log, dev_iv, wall)
    res.update(kernels=kernels, kernel_ms=kernel_ms,
               kernel_share=None if kernel_ms is None
               else kernel_ms * 1e-3 / plain_wall)
    res.update(arm=arm, wall_s=wall, pings_per_sec=n_pings / wall,
               plain_wall_s=plain_wall,
               plain_pings_per_sec=n_pings / plain_wall,
               store_equal=stores_equal(paths["plain"],
                                        paths["instrumented"]),
               kinds_seen=sorted(res["kinds"]), n_chunks=len(dev_iv)
               or res["kinds"].get("dispatch_predict", {}).get("n", 0),
               config={k: cfg.get(k) for k in SERVING_KNOBS if k in cfg},
               events=[(round(a * 1e3, 3), round(b * 1e3, 3), k, th,
                        round(mb, 3)) for a, b, k, th, mb in
                       sorted(log.events)],
               device_intervals_ms=[(round(a * 1e3, 3), round(b * 1e3, 3))
                                    for a, b in dev_iv])
    for p in paths.values():
        shutil.rmtree(p, ignore_errors=True)
    log_fn(f"\n== timeline, arm {arm} ({res['config']}): wall {wall:.4f} s "
           f"-> {res['pings_per_sec']:.1f} pings/s (uninstrumented "
           f"{res['plain_pings_per_sec']:.1f}); device spans "
           f"{tc.fmt(res['device_busy_share'], '.1%')} of the wall, kernels "
           f"{tc.fmt(res['kernel_ms'], '.2f')} ms = "
           f"{tc.fmt(res['kernel_share'], '.1%')} of the uninstrumented "
           f"wall ({tc.fmt(res['kernels'], '.0f')} device ops); store "
           f"bit-identical to the uninstrumented pass: "
           f"{res['store_equal']} ==")
    log_fn(f"{'t0 ms':>9} {'t1 ms':>9} {'dur ms':>8}  event [thread] (MB)")
    rows = [(a, b, k, th, mb) for a, b, k, th, mb in res["events"]] + \
        [(a, b, "device", "card", 0.0) for a, b in
         res["device_intervals_ms"]]
    for a, b, k, th, mb in sorted(rows):
        log_fn(f"{a:9.2f} {b:9.2f} {b - a:8.2f}  {k} [{th}]"
               + (f" ({mb:.1f} MB)" if mb else ""))
    log_fn("busy share of the wall, per thread (union of its intervals): "
           + ", ".join(f"{th} {s:.1%}" for th, s in
                       res["thread_busy_share"].items()))
    log_fn("per kind (n, ms, MB): " + ", ".join(
        f"{k} {v['n']} / {v['ms']:.2f} / {v['mb']:.1f}"
        for k, v in res["kinds"].items()))
    return res


def run(device="cuda", survey=None, model=None, ckpt=None, work=None,
        arms=("default", "serving"), preload=1000, log=print) -> dict:
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = common.state_dict(ckpt) if ckpt is not None \
        else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    work = Path(work or common.WORK)
    work.mkdir(parents=True, exist_ok=True)
    res = {"device": common.card_name(dev), "survey": reader.name,
           "n_pings": int(reader.shape[0])}
    for arm in arms:
        res[arm] = run_arm(arm, sd, reader, work, dev, model, preload, log)
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    ap.add_argument("--arms", default="default,serving")
    tc.add_model_flags(ap)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.device, sv, tc.model_from(args), args.ckpt,
                      args.work, tuple(args.arms.split(","))), args.out)


if __name__ == "__main__":
    main()
