"""Seeding, timing and small general helpers."""

from __future__ import annotations

import datetime
import random
import time

import numpy as np


def fix_seeds(random_seed: int) -> None:
    """Fix host and torch RNGs for reproducibility (reference
    utils/general.py:120-127).  Model initialisation that must not depend
    on the global state takes an explicit ``torch.Generator`` instead."""
    import torch
    np.random.seed(random_seed)
    random.seed(random_seed)
    torch.manual_seed(random_seed)


def get_datetime_str() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


class PhaseTimer:
    """Cheap named phase timers — first-class replacement for the reference's
    ad-hoc wall-clock prints (SURVEY.md §5 tracing).  Thread-safe: phases
    may start/stop concurrently from prefetch threads."""

    def __init__(self):
        import threading
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._starts: dict = {}
        self._lock = threading.Lock()
        self._warned_cross_thread = False

    def _key(self, name: str):
        import threading
        return (name, threading.get_ident())

    def start(self, name: str) -> None:
        with self._lock:
            self._starts[self._key(name)] = time.perf_counter()

    def stop(self, name: str) -> float:
        now = time.perf_counter()
        with self._lock:
            t0 = self._starts.pop(self._key(name), None)
            if t0 is None:
                # phases are attributed per-thread: stop() on another
                # thread than start() is a usage bug — say so once
                # instead of silently recording nothing forever
                if not self._warned_cross_thread and any(
                        k[0] == name for k in self._starts):
                    self._warned_cross_thread = True
                    print(f"PhaseTimer: stop({name!r}) on a different "
                          "thread than its start(); phases must "
                          "start/stop on the same thread")
                return 0.0
            dt = now - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    def report(self) -> str:
        # snapshot under the lock: a prefetch thread's first stop() of a
        # new phase can otherwise resize the dict mid-iteration
        with self._lock:
            items = sorted(self.totals.items(), key=lambda kv: -kv[1])
            counts = dict(self.counts)
        lines = []
        for name, total in items:
            n = counts[name]
            lines.append(f"{name:<32s} total {total:8.3f}s  n={n:<6d} "
                         f"mean {total / max(n, 1) * 1e3:8.2f}ms")
        return "\n".join(lines)

    def summary(self) -> dict:
        """{phase: {total_s, n}} — machine-readable for bench JSON."""
        with self._lock:
            return {name: {"total_s": round(total, 4),
                           "n": self.counts[name]}
                    for name, total in self.totals.items()}

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self._starts.clear()
