"""The device's idle gaps in a prediction pass, named by the program's spans.

Reads a Chrome trace that ``utils.profiling.device_trace(timer=...)``
wrote (``CRIMAC_PROFILE_DIR=... python -m
crimac_unet_tpu_torch.pipeline.save_predict ...`` writes one), or a
profiler trace and the spans of ``PhaseTimer.take_spans()`` beside it,
and reports for the launch thread (``MainThread``):

* the ``--top`` longest stretches of the pass in which no device
  operation (kernel, copy or memset) ran, each with the thread's
  innermost span at its middle, that span's chunk and its parent;
* the share of the pass the thread's spans of ``COVER`` cover (the pass:
  from the thread's first span's start to its last span's end);
* for each chunk's first ``gather_db`` kernel, whether it starts after
  the start of that chunk's ``device_chunk`` span and, where the trace
  holds the host's runtime calls (a ``device_trace`` export does), whether
  the call that launched it lies inside that span: the spans and the
  profiler then share one clock, to within a span's length either way.

    python scripts/torch_span_gaps.py prof/ [--top 10]

Prints the gaps and one JSON line.  The benchmark's own trace reduction
(``benchmark/yardstick/trace.py``) names its gaps by the benchmark's
spans; once it is handed the program's spans, this script goes.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.yardstick.trace import DEVICE_CATS, _merge  # noqa: E402
from crimac_unet_tpu_torch.utils.profiling import (  # noqa: E402
    SPAN_CATEGORY, _newest_trace)

THREAD = "MainThread"
KERNEL = "gather_db"
# the launch thread's spans that account for a zarr pass's wall
COVER = ("pass_head", "wait_prefetch", "wait_writer", "device_chunk",
         "device_wait", "d2h")
# the host's side of a launch, joined to its kernel by ``correlation``
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def load(path):
    """The trace's document: ``path`` is a trace file or a directory
    whose newest ``*.pt.trace.json[.gz]`` is read."""
    if os.path.isdir(path):
        path = _newest_trace(path)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def events(doc, spans=None):
    """(device events, span events, {correlation: launch call's start})
    of a trace, times in us.  ``spans``: ``PhaseTimer.take_spans()`` rows
    to add to those the trace holds."""
    ev = doc["traceEvents"]
    device = [e for e in ev if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS
                and "correlation" in e.get("args", {})}
    rows = [e for e in ev if e.get("ph") == "X"
            and e.get("cat") == SPAN_CATEGORY]
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in ev
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    out = [{"name": e["name"], "ts": e["ts"], "dur": e["dur"],
            "thread": names.get((e["pid"], e["tid"]), "")
            .removeprefix("spans "), **e.get("args", {})} for e in rows]
    base = int(doc.get("baseTimeNanoseconds", 0))
    for name, thread, chunk, parent, t0, t1 in spans or ():
        out.append({"name": name, "ts": (t0 - base) * 1e-3,
                    "dur": (t1 - t0) * 1e-3, "thread": thread,
                    "chunk": chunk, "parent": parent})
    return device, out, launches


def summarize(device, spans, launches, top=10):
    """The gaps, the coverage and the kernels' order of the launch
    thread's pass (see the module's docstring); times in ms."""
    mine = [s for s in spans if s["thread"] == THREAD]
    if not mine:
        raise ValueError(f"no span of thread {THREAD!r} in the trace")
    t0 = min(s["ts"] for s in mine)
    t1 = max(s["ts"] + s["dur"] for s in mine)
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in device if e["ts"] + e["dur"] > t0
                   and e["ts"] < t1])
    edges = [t0] + [x for a, b in busy for x in (a, b)] + [t1]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:top]
    named = []
    for dur, a in gaps:
        mid = a + dur / 2
        s = min((s for s in mine if s["ts"] <= mid <= s["ts"] + s["dur"]),
                key=lambda s: s["dur"], default=None)
        named.append({"ms": dur * 1e-3, "at_ms": (a - t0) * 1e-3,
                      "span": s["name"] if s else "outside",
                      "chunk": s.get("chunk") if s else None,
                      "parent": s.get("parent") if s else None})
    covered = _merge([(s["ts"], s["ts"] + s["dur"]) for s in mine
                      if s["name"] in COVER])
    chunks = sorted((s for s in mine if s["name"] == "device_chunk"),
                    key=lambda s: s["ts"])
    k1 = sorted((e for e in device if e.get("cat") == "kernel"
                 and KERNEL in e["name"]), key=lambda e: e["ts"])
    checked = bool(chunks and k1 and len(k1) % len(chunks) == 0)
    early, outside, calls = [], [], []
    if checked:
        per = len(k1) // len(chunks)
        for i, c in enumerate(chunks):
            k = k1[i * per]
            if k["ts"] < c["ts"]:
                early.append(c.get("chunk"))
            call = launches.get(k.get("args", {}).get("correlation"))
            calls.append(call)
            if call is not None and not (
                    c["ts"] <= call <= c["ts"] + c["dur"]):
                outside.append(c.get("chunk"))
    return {"pass_ms": (t1 - t0) * 1e-3,
            "busy_ms": sum(b - a for a, b in busy) * 1e-3,
            "covered_share": sum(b - a for a, b in covered) / (t1 - t0),
            "gaps": named, "chunks": len(chunks), "kernels": len(k1),
            "kernel_order_checked": checked,
            "kernel_before_its_chunk": early,
            "launch_checked": checked and None not in calls,
            "launch_outside_its_chunk": outside}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace file or a directory of them")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    res = summarize(*events(load(args.trace)), top=args.top)
    print(f"pass {res['pass_ms']:.3f} ms, device busy {res['busy_ms']:.3f}"
          f" ms; {', '.join(COVER)} cover {res['covered_share']:.1%}")
    for g in res["gaps"]:
        print(f"{g['ms']:9.3f} ms at {g['at_ms']:9.3f} ms  {g['span']} "
              f"(chunk {g['chunk']}, in {g['parent']})")
    if res["kernel_order_checked"]:
        print(f"{res['kernels']} {KERNEL} kernels over {res['chunks']} "
              f"chunks; a chunk's first starts before its device_chunk "
              f"span: {res['kernel_before_its_chunk']}; launched outside "
              f"it: " + (str(res["launch_outside_its_chunk"])
                         if res["launch_checked"] else "not checked"))
    else:
        print(f"{res['kernels']} {KERNEL} kernels over {res['chunks']} "
              "chunks: not checked")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
