"""Profiling hooks: device traces and a per-kernel device-time table.

The port's counterpart of ``crimac_unet_tpu/utils/profiling.py`` on
``torch.profiler``: ``device_trace`` records a chrome trace (CPU, and the
card's kernels when it is there) into ``CRIMAC_PROFILE_DIR`` or the
directory given, with the spans of the program's ``PhaseTimer`` beside
the profiler's rows, and ``device_op_table`` sums the trace's GPU kernel
events by name.
"""

from __future__ import annotations

import contextlib
import os
import time

# the rows of the timer's spans: one a thread, after the profiler's own
SPAN_CATEGORY = "crimac_span"
SPAN_TID0 = 1_000_000_000


@contextlib.contextmanager
def device_trace(log_dir=None, enabled=None, timer=None):
    """Record a ``torch.profiler`` trace of the block, written as
    ``<log_dir>/trace-<time>.pt.trace.json.gz`` (chrome / Perfetto
    format), when enabled by argument or ``CRIMAC_PROFILE_DIR``.  CUDA
    activities are recorded when a card is present.

    ``timer`` (a ``utils.general.PhaseTimer``) records spans for the
    block; they are written into the same trace as ``X`` events of
    category ``crimac_span``, one row a thread (``spans <thread>``), with
    ``args`` ``{chunk, parent}``, and cleared."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.environ.get("CRIMAC_PROFILE_DIR")
    if enabled is None:
        enabled = log_dir is not None
    if enabled and log_dir is None:
        raise ValueError(
            "device_trace(enabled=True) needs a destination: pass "
            "log_dir or set CRIMAC_PROFILE_DIR")
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    recording = timer is not None and timer.recording
    if timer is not None:
        timer.recording = True
    try:
        with profile(activities=activities) as prof:
            yield log_dir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if timer is not None:
            timer.recording = recording
    name = f"trace-{time.strftime('%Y%m%d_%H%M%S')}-{os.getpid()}" \
        ".pt.trace.json.gz"
    path = os.path.join(str(log_dir), name)
    if timer is None:
        prof.export_chrome_trace(path)
        return
    plain = path[:-3]
    prof.export_chrome_trace(plain)
    try:
        _write_with_spans(plain, path, timer.take_spans())
    finally:
        os.remove(plain)


def _write_with_spans(plain, path, spans):
    """The profiler's trace ``plain`` with ``spans`` added, gzipped to
    ``path``: ``ts`` is a span's start less the trace's
    ``baseTimeNanoseconds``, in us, as the profiler's own events."""
    import gzip
    import json

    with open(plain) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids: dict = {}
    events = doc.setdefault("traceEvents", [])
    for name, thread, chunk, parent, t0, t1 in spans:
        if thread not in tids:
            tids[thread] = tid = SPAN_TID0 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"spans {thread}"}})
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": name,
                       "pid": pid, "tid": tids[thread],
                       "ts": (t0 - base) * 1e-3, "dur": (t1 - t0) * 1e-3,
                       "args": {"chunk": chunk, "parent": parent}})
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)


def _newest_trace(trace_dir):
    import glob
    files = [f for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for f in glob.glob(os.path.join(str(trace_dir), "**", pat),
                                recursive=True)]
    if not files:
        raise FileNotFoundError(
            f"no *.pt.trace.json[.gz] under {trace_dir}")
    return max(files, key=os.path.getmtime)


def device_op_table(trace_dir, top=20):
    """Per-kernel device-time table from a ``device_trace`` capture: the
    newest ``*.pt.trace.json[.gz]`` under ``trace_dir``, its GPU kernel
    events (``cat == "kernel"``) summed by name.  Returns dicts ``{name,
    total_ms, count}`` sorted by total time (``top`` rows; 0 = all)."""
    import collections
    import gzip
    import json

    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        tr = json.load(fh)
    ev = tr["traceEvents"] if isinstance(tr, dict) else tr
    durs = collections.defaultdict(float)
    cnt = collections.Counter()
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e:
            durs[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    rows = [{"name": n, "total_ms": round(d / 1e3, 3), "count": cnt[n]}
            for n, d in sorted(durs.items(), key=lambda kv: -kv[1])]
    return rows[:top] if top else rows


def print_device_op_table(trace_dir, top=20, width=100):
    """Human-readable dump of :func:`device_op_table`."""
    for r in device_op_table(trace_dir, top):
        print(f"{r['total_ms']:9.3f} ms x{r['count']:<5} "
              f"{r['name'][:width]}")
