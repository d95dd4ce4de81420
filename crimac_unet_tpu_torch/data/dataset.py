"""Host-side batch production for training and validation.

The port's copy of ``crimac_unet_tpu/data/dataset.py`` (reference
batch/dataset.py:30-113, pipeline_train_predict/train.py:35-110): the host
draws a sampler and a center per sample from one ``RandomState`` and either
extracts the raw crops (data, labels, seabed rows) or, with a device sample
pool attached, ships only the crops' pool coordinates.  Every transform
runs on the device in the train and eval steps (pipeline/engine.py).  A
thread pool fills bounded queues ahead of the training loop, in a fixed
batch order.

Batch layout: data (B, C, wh, ww) float32 raw sv, labels (B, wh, ww) int32
raw codes, seabed_row (B, ww) int32 patch row of seabed+pad (BIG_ROW where
absent or outside the data); pooled: ech_idx (B,) and starts (B, 2) int32,
plus seabed_row for validation; with metadata channels (memmap only)
meta (B, M, wh, ww) float32 on the host-crop path, computed on the device
from the pool's per-echogram vectors on the pooled path.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..constants import SEABED_PAD
from ..ops.label_ops import BIG_ROW
from .meta_channels import crop_meta, validate_meta_channels


def seabed_patch_row(reader, center, window) -> np.ndarray:
    """Per-column patch row index of the first masked (below-seabed) pixel,
    including the +SEABED_PAD shift (reference mask_label_seabed.py:24-68).
    Columns outside the data or without a seabed get BIG_ROW."""
    wh, ww = window
    # crop-origin convention shared with utils/grids.crop_bounds
    # ((N+1)//2 == N//2 for even N, the reference getGrid offsets)
    y0 = int(center[0]) - (wh + 1) // 2 + 1
    x0 = int(center[1]) - (ww + 1) // 2 + 1
    zarr = reader.data_format == "zarr"
    n_pings = reader.shape[0] if zarr else reader.shape[1]

    out = np.full(ww, BIG_ROW, dtype=np.int32)
    lo = max(x0, 0)
    hi = min(x0 + ww, n_pings)
    if hi <= lo:
        return out
    sb = np.asarray(reader.get_seabed(lo, hi - lo)).astype(np.int64)
    sy0 = max(y0, 0)
    valid = np.asarray(reader.seabed_known(lo, hi - lo))
    if zarr:
        # zarr pads by shifting the sliced bottom mask down
        # (data_reader.py:841-846): threshold = max(seabed, patch_top)+pad
        thresh = np.maximum(sb, sy0) + SEABED_PAD
    else:
        # memmap clamps the shifted line at the patch top
        # (data_reader.py:407-431): threshold = max(seabed+pad, patch_top)
        thresh = np.maximum(sb + SEABED_PAD, sy0)
    rows = np.clip(thresh - y0, -(10 ** 6), BIG_ROW)
    out[lo - x0:hi - x0] = np.where(valid, rows, BIG_ROW).astype(np.int32)
    return out


class RandomPatchDataset:
    """Class-balanced random patch sampling
    (reference batch/dataset.py:30-113)."""

    def __init__(self, samplers, window_size, frequencies,
                 sampler_probs=None, seed=None, meta_channels=None):
        self.samplers = samplers
        self.window_size = window_size
        self.frequencies = frequencies
        self.meta_channels = meta_channels or None
        validate_meta_channels(self.meta_channels)
        probs = np.asarray(sampler_probs if sampler_probs is not None
                           else np.ones(len(samplers)), dtype=float)
        self.cum_probs = np.cumsum(probs) / probs.sum()
        # resume salts the seed by 100003*step (train.py), which exceeds
        # RandomState's 32-bit seed range for long recipes — wrap it
        self.rng = np.random.RandomState(
            None if seed is None else int(seed) % (2 ** 32))
        self.pool = None  # device sample pool -> coordinate-only batches
        self.pool_with_seabed = False

    def use_pool(self, pool, with_seabed=False):
        """Switch to coordinate-only batches for a device sample pool
        (``DeviceSamplePool`` or ``ZarrSamplePool``): the host draws (sampler, center) with the
        SAME rng sequence as the crop path but ships only (echogram, start)
        int32 coordinates; crops (and metadata crops) are gathered on the
        device inside the pooled step.  ``with_seabed`` adds the (B, ww) seabed-row strips
        the VALIDATION label chain needs (host-computed, as on the crop
        path)."""
        self.pool = pool
        self.pool_with_seabed = bool(with_seabed)
        return self

    def _draw(self):
        i = self.rng.rand()
        sampler = self.samplers[int(np.searchsorted(self.cum_probs, i,
                                                    side="right"))]
        return sampler.get_sample(self.rng)

    def sample(self):
        center, reader = self._draw()
        data = reader.crop_data(center, self.window_size, self.frequencies)
        labels = reader.crop_labels(center, self.window_size)
        seabed = seabed_patch_row(reader, center, self.window_size)
        meta = (crop_meta(reader, center, self.window_size,
                          self.meta_channels)
                if self.meta_channels else None)
        return data, labels.astype(np.int32), seabed, meta

    def batch(self, batch_size):
        if self.pool is not None:
            samples = [self._draw() for _ in range(batch_size)]
            idxs, starts = self.pool.prepare_batch(
                [(reader, center) for center, reader in samples])
            out = {"ech_idx": idxs, "starts": starts}
            if self.pool_with_seabed:
                out["seabed_row"] = np.stack(
                    [seabed_patch_row(reader, center, self.window_size)
                     for center, reader in samples])
            return out
        parts = [self.sample() for _ in range(batch_size)]
        out = {"data": np.stack([p[0] for p in parts]),
               "labels": np.stack([p[1] for p in parts]),
               "seabed_row": np.stack([p[2] for p in parts])}
        if self.meta_channels:
            out["meta"] = np.stack([p[3] for p in parts])
        return out


class BatchPrefetcher:
    """Threaded batch prefetch: N producer threads fill bounded queues
    (the reference's DataLoader worker processes, train.py:73-79, as
    threads: crop extraction is numpy/memmap-bound and releases the GIL in
    the hot gathers).  Worker ``i`` makes batches ``i, i+N, ...`` from its
    own dataset and the consumer reads them in that order, so the batch
    sequence does not depend on thread timing: every rank of a data mesh
    draws the same global batches.  A worker's exception is raised by the
    consumer."""

    def __init__(self, dataset_factory, batch_size, n_batches,
                 num_workers=4, prefetch_depth=4):
        self.batch_size = batch_size
        self.n_batches = n_batches
        num_workers = max(1, num_workers)
        depth = max(1, -(-prefetch_depth // num_workers))
        self.queues = [queue.Queue(maxsize=depth)
                       for _ in range(num_workers)]
        self._error = None
        self._stop = threading.Event()    # stop producing (crash or close)
        self._closed = threading.Event()  # consumer is gone: drop batches
        self.threads = [
            threading.Thread(target=self._worker,
                             args=(i, dataset_factory(seed_offset=i)),
                             daemon=True)
            for i in range(num_workers)]
        for t in self.threads:
            t.start()

    def _worker(self, i, dataset):
        q = self.queues[i]
        for _ in range(i, self.n_batches, len(self.queues)):
            if self._stop.is_set():
                return
            try:
                batch = dataset.batch(self.batch_size)
            except BaseException as exc:  # surfaced by the consumer
                batch = exc
                self._error = exc
                self._stop.set()
            while True:
                try:
                    q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    # the consumer is gone: drop even exception batches, or
                    # a second crashed worker retries its delivery forever
                    if self._closed.is_set():
                        return
                    if self._stop.is_set() and not isinstance(
                            batch, BaseException):
                        return
            if isinstance(batch, BaseException):
                return

    def _get(self, k):
        q = self.queues[k % len(self.queues)]
        while True:
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                # another worker failed: this one has stopped producing
                if self._error is not None:
                    return self._error

    def __iter__(self):
        # close() on every exit path, so other workers stop retrying
        try:
            for k in range(self.n_batches):
                batch = self._get(k)
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            self.close()

    def close(self):
        self._closed.set()
        self._stop.set()
