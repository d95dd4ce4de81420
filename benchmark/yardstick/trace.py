"""The reduction of a ``torch.profiler`` trace to the numbers the
benchmark reports: the device's busy time, kernel time by name, the
longest idle gaps with what the host was doing, and the operations that
took most time.

On the card the profiler records the device's activity alone (CUPTI):
recording every host operator as well slows an eager training step's
enqueue about 2.7x, and the device's idle share would then measure the
profiler.  The trace is read from the profiler's Chrome trace export:
device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the host's state is the benchmark's own spans, taken on
the wall clock the trace's ``baseTimeNanoseconds`` counts from.
"""

from __future__ import annotations

import contextlib
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(path, device="cuda"):
    """Profile the block's device activity (the host's on the CPU, which
    has no device); the Chrome trace is written to ``path`` when it
    ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CPU if torch.device(device).type == "cpu" \
        else ProfilerActivity.CUDA
    with profile(activities=[act]) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One profiled window's events (times in microseconds)."""

    def __init__(self, path, spans):
        """``spans``: the benchmark's (name, start ns, end ns) rows, one of
        them ``bench.window``, the traced window."""
        with open(path) as f:
            doc = json.load(f)
        base = int(doc.get("baseTimeNanoseconds", 0))
        self.device = [e for e in doc["traceEvents"] if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS]
        self.spans = [{"name": n, "ts": (a - base) * 1e-3,
                       "dur": (b - a) * 1e-3} for n, a, b in spans]
        outer = next(e for e in self.spans if e["name"] == "bench.window")
        self.t0, self.t1 = outer["ts"], outer["ts"] + outer["dur"]

    def busy_s(self):
        """Seconds of the window in which some device operation ran."""
        iv = _merge([(max(e["ts"], self.t0), min(e["ts"] + e["dur"],
                                                 self.t1))
                     for e in self.device])
        return sum(max(b - a, 0.0) for a, b in iv) * 1e-6

    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def kernel_time(self, match):
        """(launches, seconds) of the kernels whose name ``match``
        accepts."""
        ev = [e for e in self.device if e.get("cat") == "kernel"
              and match(e["name"])]
        return len(ev), sum(e["dur"] for e in ev) * 1e-6

    def top_ops(self, n=10):
        tot = {}
        for e in self.device:
            name = str(e["name"])[:160]
            tot[name] = tot.get(name, 0.0) + e["dur"] * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def _innermost(self, events, t):
        best = None
        for e in events:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return best

    def inside_share(self):
        """The share of the device's activity that lies inside the
        window: about 1 when the two clocks agree."""
        tot = sum(e["dur"] for e in self.device)
        ins = sum(max(min(e["ts"] + e["dur"], self.t1)
                      - max(e["ts"], self.t0), 0.0) for e in self.device)
        return ins / tot if tot else None

    def idle_gaps(self, n=10):
        """The ``n`` longest device-idle stretches of the window, each
        named by the host's innermost benchmark span at its middle."""
        iv = _merge([(e["ts"], e["ts"] + e["dur"]) for e in self.device])
        edges = [self.t0] + [x for a, b in iv for x in (a, b)] + [self.t1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        out = []
        for dur, a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            span = self._innermost(self.spans, mid)
            out.append([span["name"] if span else "outside", dur * 1e-6])
        return out


def remove(path):
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
