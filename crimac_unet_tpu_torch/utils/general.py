"""Seeding, timing and small general helpers."""

from __future__ import annotations

import contextlib
import datetime
import os
import random
import threading
import time

import numpy as np

_pools: dict = {}
_pools_lock = threading.Lock()
# CPU seconds that pool tasks ran for this thread (map_charged)
_charged = threading.local()


def process_pool(name: str, workers: int):
    """The process's thread pool ``name`` of ``workers`` threads, made at
    its first use and kept.

    The host pipelines stage, decode and write on such pools, not on a
    pool of their own a call.  A new thread gets a glibc malloc arena at
    its first allocation, and an arena keeps what its threads freed: with
    new threads every call, the arena that held one call's writer could
    serve the next call's prefetch thread and had to grow to a slab's
    size, so the host RSS a streaming call added depended on what the
    calls before it had left (ROADMAP C, F16).  Threads that stay keep
    their arenas and their roles.  A forked child, whose copy of a pool
    has no threads, makes its own."""
    from concurrent.futures import ThreadPoolExecutor
    with _pools_lock:
        pid, pool = _pools.get(name, (None, None))
        if pid != os.getpid():
            pool = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix=f"crimac-{name}")
            _pools[name] = (os.getpid(), pool)
        return pool


def settle(futures) -> None:
    """Cancel the futures not yet started and wait for the others: what
    ``shutdown(wait=True, cancel_futures=True)`` does to a pool of one's
    own, for one call's futures on a shared pool."""
    from concurrent.futures import wait
    futures = [f for f in futures if f is not None]
    for f in futures:
        f.cancel()
    wait(futures)


def thread_cpu() -> float:
    """This thread's CPU seconds (``time.thread_time``) and those of the
    pool tasks it ran through :func:`map_charged`."""
    return time.thread_time() + getattr(_charged, "s", 0.0)


def map_charged(pool, fn, *iterables):
    """``pool.map(fn, *iterables)``, each task's thread CPU seconds
    charged to the consuming thread's :func:`thread_cpu` once the results
    are all taken: a phase that hands work to a pool (a read's decode)
    then counts its CPU.  Lazy as ``pool.map``: a result is dropped once
    taken.  Where the clock ticks coarsely (10 ms on some hosts), a
    task's CPU is sampled: a sum over many is sound, one task's is not."""
    spent = []

    def run(*args):
        c0 = time.thread_time()
        try:
            return fn(*args)
        finally:
            spent.append(time.thread_time() - c0)
    try:
        yield from pool.map(run, *iterables)
    finally:
        _charged.s = getattr(_charged, "s", 0.0) + sum(spent)


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
    """The port's tracer: named phases, counters and, while ``recording``
    is on, one span a phase (SURVEY.md §5 tracing).  Thread-safe: phases
    may start/stop concurrently from the prefetch and writer threads.

    Always on, a ``start``/``stop`` pair adds the phase's wall seconds to
    ``totals[name]`` and its thread's CPU seconds (:func:`thread_cpu`:
    ``time.thread_time`` and the pool tasks the thread ran through
    :func:`map_charged`) to ``totals[name + ".cpu"]``, each with a count
    in ``counts``; ``count`` adds to a counter and ``add`` a time measured elsewhere (a
    chunk's CUDA-event time) in the same two tables, so one snapshot of
    them carries everything.  With ``recording`` on (``device_trace``
    turns it on for its block), each pair also keeps a span ``(name,
    thread name, chunk, parent, start ns, end ns)``: ``chunk`` is what the
    caller passed (the chunk's first ping), ``parent`` the innermost phase
    still open on the same thread, and the times are ``time.time_ns()``,
    the wall clock a ``torch.profiler`` trace's ``baseTimeNanoseconds``
    counts from.  Off, a pair keeps no span."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: set[str] = set()
        self.recording = False
        self.spans: list[tuple] = []
        # thread ident -> its open phases, innermost last:
        # [name, chunk, parent, start ns, start thread CPU s]
        self._open: dict[int, list] = {}
        self._lock = threading.Lock()
        self._warned_cross_thread = False

    def start(self, name: str, chunk=None) -> None:
        now, cpu = time.time_ns(), thread_cpu()
        with self._lock:
            stack = self._open.setdefault(threading.get_ident(), [])
            # a phase started again while open on this thread was left
            # by an exception: it and the phases inside it are dropped
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    del stack[i:]
                    break
            stack.append((name, chunk, stack[-1][0] if stack else None,
                          now, cpu))

    def stop(self, name: str) -> float:
        now, cpu = time.time_ns(), thread_cpu()
        with self._lock:
            stack = self._open.get(threading.get_ident(), ())
            i = len(stack) - 1
            while i >= 0 and stack[i][0] != name:
                i -= 1
            if i < 0:
                # phases are attributed per-thread: stop() on another
                # thread than start() is a usage bug — say so once
                # instead of silently recording nothing forever
                if not self._warned_cross_thread and any(
                        e[0] == name for st in self._open.values()
                        for e in st):
                    self._warned_cross_thread = True
                    print(f"PhaseTimer: stop({name!r}) on a different "
                          "thread than its start(); phases must "
                          "start/stop on the same thread")
                return 0.0
            _, chunk, parent, t0, cpu0 = stack[i]
            # phases opened inside this one and never stopped go with it
            del stack[i:]
            dt = (now - t0) * 1e-9
            self._add(name, dt)
            self._add(name + ".cpu", cpu - cpu0)
            if self.recording:
                self.spans.append((name, threading.current_thread().name,
                                   chunk, parent, t0, now))
        return dt

    @contextlib.contextmanager
    def phase(self, name: str, chunk=None):
        """``start``/``stop`` around a block, stopped also when it
        raises."""
        self.start(name, chunk)
        try:
            yield
        finally:
            self.stop(name)

    def _add(self, name, value):
        self.totals[name] = self.totals.get(name, 0) + value
        self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        """Add a phase's seconds measured elsewhere (no span, no CPU)."""
        with self._lock:
            self._add(name, seconds)

    def count(self, name: str, n) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters.add(name)
            self._add(name, n)

    def take_spans(self) -> list:
        """The spans recorded so far, which are cleared."""
        with self._lock:
            spans, self.spans = self.spans, []
        return spans

    def _rows(self):
        """(phases as (name, wall s, n, CPU s or None), counters as
        (name, total, n)), under the lock: a prefetch thread's first
        stop() of a new phase can otherwise resize the dicts
        mid-iteration."""
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
            counters = set(self.counters)
        phases = [(k, v, counts[k], totals.get(k + ".cpu"))
                  for k, v in totals.items()
                  if k not in counters and not (
                      k.endswith(".cpu") and k[:-4] in totals)]
        return (sorted(phases, key=lambda r: -r[1]),
                sorted((k, totals[k], counts[k]) for k in counters))

    def report(self) -> str:
        phases, counters = self._rows()
        lines = []
        for name, total, n, cpu in phases:
            lines.append(f"{name:<32s} total {total:8.3f}s  n={n:<6d} "
                         f"mean {total / max(n, 1) * 1e3:8.2f}ms"
                         + (f"  cpu {cpu:8.3f}s" if cpu is not None else ""))
        for name, total, n in counters:
            lines.append(f"{name:<32s} count {total:<14d} n={n}")
        return "\n".join(lines)

    def summary(self) -> dict:
        """{phase: {total_s, n[, cpu_s]}, counter: {count, n}} —
        machine-readable for bench JSON."""
        phases, counters = self._rows()
        out = {}
        for name, total, n, cpu in phases:
            out[name] = {"total_s": round(total, 4), "n": n}
            if cpu is not None:
                out[name]["cpu_s"] = round(cpu, 4)
        for name, total, n in counters:
            out[name] = {"count": total, "n": n}
        return out

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()
            self.spans.clear()
            self._open.clear()
