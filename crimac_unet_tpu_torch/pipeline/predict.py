"""Chunked sliding-window survey prediction and the memmap writer.

Reproduces the reference's save_predict chunked pipeline
(save_predict.py:137-265), as the JAX package's
``crimac_unet_tpu/pipeline/predict.py`` does, as a software-pipelined
host/device loop: prefetch threads build one raw slab per ping chunk and
start its host-to-device copy on a side stream from pinned memory, the
main thread enqueues the chunk's device work (runner.py), and each
chunk's output comes back through a pinned buffer with an event that
``_drain`` waits on, ``pipeline_depth`` chunks behind.
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import SEABED_PAD
from ..ops.label_ops import BIG_ROW
from ..ops.patches import grid_dims, make_grid_starts
from ..utils.preload_split import get_data_split
from .infer_common import (_U8_PROB_DEQUANT, _fill_hwc_slab,
                           _grid_extent_rows, _quantize_db_u8, _round_up)
from .runner import GriddedRunner


def _keep_row_bound(fin, zero, sb_vec, row_cut, nr):
    """Host-side upper bound on the device write mask's last kept row
    (1 + highest row where any pixel CAN be kept), a superset of the
    memmap law in GriddedRunner._mask_output: it mirrors the
    label-finiteness / label-zero / seabed algebra and ignores only the
    sv-finiteness term (which can only shrink the kept set).  The d2h copy
    is cropped to this bound; rows below it are identically zero."""
    rows = np.arange(nr, dtype=np.int64)
    thresh = np.broadcast_to(sb_vec[None, :] + SEABED_PAD, (nr, len(sb_vec)))
    below = rows[:, None] >= thresh
    keep_sup = fin & ~(below & zero)
    keep_sup = keep_sup & (rows < row_cut)[:, None]
    any_row = keep_sup.any(axis=1)
    return int(np.max(np.where(any_row, rows + 1, 0), initial=0))


@dataclasses.dataclass(frozen=True)
class ChunkGeometry:
    """The reference patch grid of one ping chunk and the extents of its
    HWC slab (slab coordinates: row 0 / column 0 are the top-left of the
    zero-padded grid)."""
    R: int            # grid rows
    C: int            # grid columns
    Hs: int           # shipped slab rows (<= the grid height Hp)
    Wp: int           # slab columns
    row_cut: int      # rows [0, row_cut) of the chunk can be written
    slab_x0: int      # survey columns [slab_x0, slab_x1) fill the slab
    slab_x1: int
    slab_y1: int      # survey rows [0, slab_y1) fill the slab
    x_off: int        # slab column of survey column slab_x0
    border: tuple     # data rectangle (y0, y1, x0, x1)


def chunk_geometry(window, overlap, n_range, n_pings, seabed, known, s, e):
    """Grid and slab extents of memmap chunk [s, e): the grid height from
    the chunk's seabed (reference gridded.py:121-163), unclipped survey
    reads limited to the columns live patches read, and only the
    data-bearing rows [0, o + slab_y1) shipped — the gather kernel reads
    the rows below as the zero pad."""
    wh, ww = window
    o = overlap
    sh, sw = wh - 2 * o, ww - 2 * o
    R = _grid_extent_rows(n_range, seabed[s:e], known[s:e], wh, o)
    C = grid_dims(s, e, ww, o)
    slab_x0 = max(0, s - o)
    slab_x1 = min(n_pings, s + C * sw + o)
    slab_y1 = min(n_range, R * sh + o)
    x_off = o + (slab_x0 - s)
    return ChunkGeometry(
        R=R, C=C, Hs=min(o + slab_y1, R * sh + 2 * o), Wp=C * sw + 2 * o,
        row_cut=min(R * sh, n_range), slab_x0=slab_x0, slab_x1=slab_x1,
        slab_y1=slab_y1, x_off=x_off,
        # memmap test transform zeroes dB data outside the data extent
        # (transforms.py:57-64)
        border=(o, o + slab_y1, x_off, x_off + (slab_x1 - slab_x0)))


class _Staged:
    """One chunk's device inputs plus the event that marks its h2d copy."""

    def __init__(self, tensors: dict, event):
        self.tensors = tensors
        self.event = event

    def ready(self) -> dict:
        """Order the current stream after the copy and tie the tensors to
        it (they were allocated on the copy stream)."""
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


def _to_device(runner: GriddedRunner, host: dict, copy_stream) -> _Staged:
    """h2d of one chunk's host arrays: pinned memory, non_blocking, on the
    side stream, with an event; plain copies on the CPU."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               if isinstance(v, np.ndarray) else v for k, v in host.items()}
    if runner.device.type != "cuda":
        return _Staged(tensors, None)
    with torch.cuda.stream(copy_stream):
        dev = {k: t.pin_memory().to(runner.device, non_blocking=True)
               for k, t in tensors.items()}
        event = torch.cuda.Event()
        event.record(copy_stream)
    return _Staged(dev, event)


def predict_reader(runner: GriddedRunner, reader, preload_n_pings=1000,
                   start_ping=0, progress=False):
    """Yield (chunk_start, chunk_end, (2, n_range, w) float16 predictions)
    for one memmap reader, reproducing save_predict's chunked sliding
    window (save_predict.py:137-219)."""
    o = runner.overlap
    sw = runner.stride[1]
    n_range, n_pings = reader.shape
    is_cuda = runner.device.type == "cuda"

    chunk = preload_n_pings if preload_n_pings > 0 else 5000
    splits = get_data_split([[start_ping, n_pings]], chunk)

    seabed_full = np.asarray(reader.get_seabed(0, n_pings)).astype(np.int64)
    seabed_has = np.asarray(reader.seabed_known(0, n_pings))

    it = splits
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(splits, desc="Predicting ...")
        except ImportError:  # progress bars are optional
            pass

    copy_stream = torch.cuda.Stream(runner.device) if is_cuda else None
    pending: list = []
    pipeline_depth = int(runner.pipeline_depth)

    def _drain(entry):
        s0, e0, out, event = entry
        runner.timer.start("device_wait")
        if event is not None:
            event.synchronize()
        runner.timer.stop("device_wait")
        runner.timer.start("d2h")
        # `out` holds only the rows above the host-computed keep-row
        # bound (_keep_row_bound); rebuild the full range on the host
        kr = min(out.shape[1], n_range)
        host = np.zeros((2, n_range, e0 - s0), np.float16)
        if kr > 0:
            part = out.numpy()[:, :kr, :e0 - s0]
            if part.dtype == np.uint8:
                part = _U8_PROB_DEQUANT[part]
            host[:, :kr, :] = part
        runner.timer.stop("d2h")
        return s0, e0, host

    def prepare(s, e):
        """Host-side slab construction for one chunk (prefetch thread,
        overlapped with the device work of earlier chunks)."""
        s, e = int(s), int(e)
        w = e - s
        runner.timer.start("host_slab")
        g = chunk_geometry(runner.window, o, n_range, n_pings, seabed_full,
                           seabed_has, s, e)
        R, C, Hs, row_cut = g.R, g.C, g.Hs, g.row_cut
        data_slab = np.zeros((Hs, g.Wp, len(runner.frequencies)),
                             np.float32)
        runner.timer.start("host_fill")
        _fill_hwc_slab(reader, runner.frequencies, data_slab, g.slab_x0,
                       g.slab_x1, g.slab_y1, o, g.x_off)
        runner.timer.stop("host_fill")

        # write-mask inputs: only rows [0, nr) (the grid-covered range)
        nr = row_cut
        runner.timer.start("host_label")
        lab = np.asarray(
            reader.label_memmap()[:row_cut, s:e]).astype(np.float32).T
        fin_pad = np.zeros((nr, C * sw), bool)
        zero_pad = np.zeros((nr, C * sw), bool)
        fin_pad[:row_cut, :w] = np.isfinite(lab).T
        zero_pad[:row_cut, :w] = (lab == 0).T
        runner.timer.stop("host_label")
        sb_vec = np.full(C * sw, BIG_ROW, np.int64)
        sb_vec[:w] = np.where(seabed_has[s:e], seabed_full[s:e], BIG_ROW)
        y0s, x0s = make_grid_starts(R, C, *runner.stride, o, o, o)
        runner.timer.stop("host_slab")

        # labels never ship: the write mask consults only isfinite(label)
        # and label == 0, packed to 1 bit/px here on the exact float32
        # host labels (bit-identical under every transfer_dtype)
        runner.timer.start("h2d_dispatch")
        bit_planes = [np.packbits(fin_pad, axis=1),
                      np.packbits(zero_pad, axis=1)]
        if runner.transfer_dtype == "uint8":
            # host dB + 8-bit codes; channel-0 finiteness rides as a
            # packed bitmask since the codes cannot carry NaN
            svf = np.ones((nr, C * sw), bool)
            avail = max(min(nr, Hs - o), 0)  # rows beyond are zeros: finite
            svf[:avail, :w] = np.isfinite(data_slab[o:o + avail, o:o + w, 0])
            bit_planes.append(np.packbits(svf, axis=1))
            slab_xfer = torch.from_numpy(_quantize_db_u8(data_slab))
        elif runner.transfer_dtype == "bfloat16":
            # round to nearest even, as ml_dtypes' float32 -> bfloat16
            slab_xfer = torch.from_numpy(data_slab).to(torch.bfloat16)
        else:
            slab_xfer = torch.from_numpy(data_slab)
        staged = _to_device(runner, dict(
            data_slab=slab_xfer, lab_bits=np.stack(bit_planes),
            sb_row=np.append(sb_vec, np.int64(row_cut))), copy_stream)
        runner.timer.stop("h2d_dispatch")
        # d2h crop bound, bucketed to 128-row multiples as in the JAX
        # package (keeps the d2h shapes few)
        kr = _keep_row_bound(fin_pad, zero_pad, sb_vec, row_cut, nr)
        kr = min(_round_up(kr, 128), nr)
        return s, e, w, R, C, nr, kr, g.border, y0s, x0s, staged

    executor = ThreadPoolExecutor(max_workers=2)
    try:
        futs = collections.deque(executor.submit(prepare, *sp)
                                 for sp in splits[:2])
        n_submitted = len(futs)

        for _ in it:
            (s, e, w, R, C, nr, kr, border_ext, y0s, x0s, staged) = \
                futs.popleft().result()
            if n_submitted < len(splits):
                futs.append(executor.submit(prepare, *splits[n_submitted]))
                n_submitted += 1

            runner.patches_processed += len(y0s)
            runner.timer.start("device_chunk")
            dev = staged.ready()
            y0p, x0p = runner.grid_starts(y0s, x0s)
            stitched = runner._predict_patches(
                dev["data_slab"], y0p, x0p, len(y0s), border_ext, R, C)
            out = runner._mask_output(
                stitched, dev["lab_bits"], dev["data_slab"], dev["sb_row"],
                nr, C * sw, w)
            # lossless d2h crop: rows at/below kr are identically zero
            out = out[:, :kr, :]
            if is_cuda:
                # async d2h into pinned memory; _drain waits on the event
                host_out = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                host_out.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                pending.append((s, e, host_out, event))
            else:
                pending.append((s, e, out, None))
            runner.timer.stop("device_chunk")
            if len(pending) >= pipeline_depth:
                yield _drain(pending.pop(0))

        for entry in pending:
            yield _drain(entry)
    finally:
        # deterministic teardown: abandoning the generator must not leave
        # prefetch threads staging chunks in the background
        executor.shutdown(wait=True, cancel_futures=True)


def save_reader_predictions_memm(runner, reader, target_dname,
                                 preload_n_pings=1000, resume_writing=False,
                                 progress=False):
    """Memmap variant: accumulate into one (2, n_range, n_pings) array and
    save as .npy (save_predict.py:222-265; skips existing files when
    resuming)."""
    import os
    if resume_writing and os.path.isfile(target_dname):
        return target_dname
    n_range, n_pings = reader.shape
    out = np.zeros((2, n_range, n_pings), np.float16)
    for s, e, chunk in predict_reader(runner, reader, preload_n_pings, 0,
                                      progress):
        out[:, :, s:e] = chunk
    np.save(target_dname, out)
    return target_dname
