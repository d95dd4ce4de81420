"""Chunked sliding-window survey prediction and the zarr/memmap writers.

Reproduces the reference's save_predict chunked pipeline
(save_predict.py:87-265), as the JAX package's
``crimac_unet_tpu/pipeline/predict.py`` does, as a software-pipelined
host/device loop: two prefetch threads (the process's, kept from call to
call) build one raw slab per ping chunk (and
its metadata channels) and start its host-to-device copy on a side stream
from pinned memory, the main thread enqueues the chunk's device work
(runner.py: patch or slab mode), each chunk's output comes back through a
pinned buffer with an event that ``_drain`` waits on, ``pipeline_depth``
chunks behind, and the zarr writer appends it to the prediction store
from one ordered writer thread.  ``static_grid`` runs every chunk of a
reader (or of a survey, through ``fixed_R``/``fixed_C``) on one grid
shape.  With a data mesh on the runner, every rank reads and stages every
chunk (the host pipeline is deterministic), runs its share of the device
work, and rank 0 alone writes.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..constants import SEABED_PAD
from ..data import blosc_codec
from ..ops.label_ops import BIG_ROW
from ..ops.patches import grid_dims, make_grid_starts
from ..utils.general import process_pool, settle
from ..utils.preload_split import get_data_split
from .infer_common import (_U8_PROB_DEQUANT, _fill_hwc_slab,
                           _grid_extent_rows, _quantize_db_u8, _round_up,
                           grid_center_cols, grid_height_for_reader)
from ..parallel.mesh import barrier, broadcast_object, is_writer
from .runner import GriddedRunner, _build_meta_inputs, _build_meta_slab_full


def static_grid_shape_for_reader(reader, window, overlap: int,
                                 preload_n_pings: int, start_ping: int = 0):
    """(grid rows, grid cols) of one reader's static (survey-max) predict
    grid: rows from the reader-max seabed, cols from its widest preload
    split (JAX predict.py ``static_grid_shape_for_reader``).  Survey-level
    callers take the elementwise max over readers and pass it as
    ``fixed_R``/``fixed_C``, so every reader runs one grid shape."""
    wh, ww = window
    n_pings = reader.shape[0] if reader.data_format == "zarr" \
        else reader.shape[1]
    chunk = preload_n_pings if preload_n_pings > 0 else 5000
    splits = get_data_split([[start_ping, n_pings]], chunk)
    if not len(splits):
        return 0, 0
    R = grid_height_for_reader(reader, wh, overlap,
                               start_ping=int(splits[0][0]))
    C = max(grid_dims(int(a), int(b), ww, overlap) for a, b in splits)
    return R, C


def survey_static_grid(runner, readers, preload_n_pings):
    """``(fixed_R, fixed_C)`` of a survey under ``static_grid``: the
    elementwise max of its readers' static grids, so every reader (a memm
    survey writes one file per echogram) runs one grid shape (JAX
    save_predict.py:39-54); ``(None, None)`` otherwise or for one
    reader."""
    if not runner.static_grid or len(readers) < 2:
        return None, None
    dims = [static_grid_shape_for_reader(r, runner.window, runner.overlap,
                                         preload_n_pings) for r in readers]
    return max(d[0] for d in dims), max(d[1] for d in dims)


def _keep_row_bound(fin, zero, sb_vec, row_cut, nr, zarr_band=None):
    """Host-side upper bound on the device write mask's last kept row
    (1 + highest row where any pixel CAN be kept), a superset of the
    law in GriddedRunner._mask_output: it mirrors the label-finiteness /
    label-zero / seabed algebra (the zarr band law when ``zarr_band`` =
    ``(sh, overlap)``) and ignores only the sv-finiteness term (which can
    only shrink the kept set).  The d2h copy is cropped to this bound;
    rows below it are identically zero."""
    rows = np.arange(nr, dtype=np.int64)
    if zarr_band is not None:
        sh, o = zarr_band
        band_top = np.clip((rows // sh) * sh - o, 0, None)
        thresh = np.maximum(sb_vec[None, :], band_top[:, None]) + SEABED_PAD
    else:
        thresh = np.broadcast_to(sb_vec[None, :] + SEABED_PAD,
                                 (nr, len(sb_vec)))
    below = rows[:, None] >= thresh
    keep_sup = fin & ~(below & zero)
    keep_sup = keep_sup & (rows < row_cut)[:, None]
    any_row = keep_sup.any(axis=1)
    return int(np.max(np.where(any_row, rows + 1, 0), initial=0))


@dataclasses.dataclass(frozen=True)
class ChunkGeometry:
    """The patch grid of one ping chunk and the extents of its HWC slab
    (slab coordinates: row 0 / column 0 are the top-left of the
    zero-padded grid)."""
    R: int            # grid rows (the static grid's under static_grid)
    C: int            # grid columns
    Hs: int           # shipped slab rows (<= the grid height Hp)
    Wp: int           # slab columns
    row_cut: int      # rows [0, row_cut) of the chunk can be written
    nr: int           # rows of the write-mask inputs and the output
    slab_x0: int      # survey columns [slab_x0, slab_x1) fill the slab
    slab_x1: int
    slab_y1: int      # survey rows [0, slab_y1) fill the slab
    x_off: int        # slab column of survey column slab_x0
    border: tuple | None  # data rectangle (y0, y1, x0, x1); None: zarr


def chunk_geometry(window, overlap, n_range, n_pings, seabed, known, s, e,
                   is_zarr=False, fixed=None):
    """Grid and slab extents of chunk [s, e): the reference grid (R_ref,
    C_ref) with its height from the chunk's seabed (reference
    gridded.py:121-163), survey reads limited to the columns live patches
    read, and only the data-bearing rows [0, o + slab_y1) shipped — the
    gather kernel reads the rows below as the zero pad.  Zarr chunks take
    the reference preload's column extent (dataset.py:175-184), which
    after the clip reads one column less on the right than a memmap
    chunk, and zero no border.

    ``fixed`` = (R_fix, C_fix) is the static grid (JAX predict.py
    :109-119,188-229,263-269): the grid grows to at least that shape,
    while every data-bearing extent (the slab fill, the label read, the
    row cutoff) stays the reference grid's, so the pad rows and columns
    read zeros and are discarded.  The shipped height and the mask rows
    are pinned to the static grid."""
    wh, ww = window
    o = overlap
    sh, sw = wh - 2 * o, ww - 2 * o
    R_ref = _grid_extent_rows(n_range, seabed[s:e], known[s:e], wh, o)
    C_ref = grid_dims(s, e, ww, o)
    static = fixed is not None
    R, C = (max(fixed[0], R_ref), max(fixed[1], C_ref)) if static \
        else (R_ref, C_ref)
    Hp = R * sh + 2 * o
    if is_zarr:
        first_center = s - o - 1 + ww // 2
        last_center = s + (C_ref - 1) * sw - o - 1 + ww // 2
        slab_x0 = max(0, first_center - ww // 2)
        slab_x1 = min(n_pings, last_center + ww // 2)
    else:
        slab_x0 = max(0, s - o)
        slab_x1 = min(n_pings, s + C_ref * sw + o)
    # patches only ever read data columns [s - o, s + C_ref*sw + o): static
    # pad columns read zeros, not data the reference grid never saw
    slab_x0 = max(slab_x0, s - o)
    slab_x1 = min(slab_x1, s + C_ref * sw + o)
    # filled to the reference grid's bottom data row even when the static
    # grid is taller: slab-mode convolutions read context below the kept
    # rows, so a deeper fill would move kept outputs near the cutoff
    slab_y1 = min(n_range, R_ref * sh + o)
    x_off = o + (slab_x0 - s)
    return ChunkGeometry(
        R=R, C=C, Hs=Hp if static else min(o + slab_y1, Hp),
        Wp=C * sw + 2 * o, row_cut=min(R_ref * sh, n_range),
        nr=R * sh if static else min(R * sh, n_range),
        slab_x0=slab_x0, slab_x1=slab_x1, slab_y1=slab_y1, x_off=x_off,
        # the memmap test transform zeroes dB data outside the data
        # extent (transforms.py:57-64); the zarr one does not
        border=None if is_zarr else
        (o, o + slab_y1, x_off, x_off + (slab_x1 - slab_x0)))


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
                   start_ping=0, progress=False, save_labels=False,
                   fixed_R=None, fixed_C=None):
    """Yield (chunk_start, chunk_end, (2, n_range, w) float16 predictions,
    labels-or-None) for one reader, reproducing save_predict's chunked
    sliding window (save_predict.py:137-219).  ``save_labels`` also
    yields the chunk's (n_range, w) float32 raw label map masked by the
    device write mask (zeros elsewhere).

    Under ``runner.static_grid`` every chunk runs the reader's static
    grid (``static_grid_shape_for_reader``), grown to at least
    ``fixed_R``/``fixed_C`` when a survey-level caller shares one grid
    over several readers; in patch mode the outputs equal the per-chunk
    grid's (live patches read the same slab values).

    The runner's timer holds the pass's phases, each with its chunk's
    first ping: ``pass_head`` from this call to the first chunk's
    ``device_chunk`` (the seabed lookup and the static grid's shape
    inside it), and a chunk's ``host_slab`` / ``host_fill`` /
    ``host_label`` / ``h2d_dispatch`` on a prefetch thread,
    ``wait_prefetch``, ``device_chunk``, ``device_wait`` and ``d2h`` on
    this one; on the card ``chunk_stream`` adds each chunk's time on the
    stream, from a CUDA event before its slab's wait to one after its
    output's copy: the device's time where the card is fed ahead of it,
    the launch's where the host enqueues slower than the card runs."""
    runner.timer.start("pass_head")
    yield from _predict_chunks(runner, reader, preload_n_pings, start_ping,
                               progress, save_labels, fixed_R, fixed_C)


def _predict_chunks(runner, reader, preload_n_pings, start_ping, progress,
                    save_labels, fixed_R, fixed_C):
    """The body of :func:`predict_reader`.  The caller has started the
    ``pass_head`` phase on this thread: the first chunk's
    ``device_chunk`` ends it, or the generator's end."""
    timer = runner.timer
    o = runner.overlap
    wh, ww = runner.window
    sh, sw = runner.stride
    is_zarr = reader.data_format == "zarr"
    if is_zarr:
        n_pings, n_range = reader.shape
    else:
        n_range, n_pings = reader.shape
    is_cuda = runner.device.type == "cuda"

    chunk = preload_n_pings if preload_n_pings > 0 else 5000
    splits = get_data_split([[start_ping, n_pings]], chunk)

    with timer.phase("seabed_lookup"):
        seabed_full = np.asarray(reader.get_seabed(0, n_pings)).astype(
            np.int64)
        seabed_has = np.asarray(reader.seabed_known(0, n_pings))

    # static_grid: one grid shape for every chunk (survey-max height,
    # widest chunk); chunk_geometry keeps the reference grid's extents
    static = runner.static_grid
    fixed = None
    if static and len(splits):
        with timer.phase("static_grid_shape"):
            R_fix, C_fix = static_grid_shape_for_reader(
                reader, runner.window, o, preload_n_pings, start_ping)
        fixed = (max(R_fix, int(fixed_R or 0)),
                 max(C_fix, int(fixed_C or 0)))
    slab_mode = runner.infer_mode == "slab"

    # bfloat16 transfer of a zarr survey: the native codec decodes float32
    # chunks straight into bfloat16 bits (round to nearest even, NaN and
    # +-Inf kept), skipping the float32 slab and its cast
    bf16_bits = (runner.transfer_dtype == "bfloat16" and is_zarr
                 and blosc_codec.scatter_available())

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
        s0, e0, out, keep, started, event, lab = entry
        timer.start("device_wait", s0)
        if event is not None:
            event.synchronize()
        timer.stop("device_wait")
        if started is not None:
            timer.add("chunk_stream", started.elapsed_time(event) * 1e-3)
        timer.start("d2h", s0)
        # `out` holds only the rows above the host-computed keep-row
        # bound (_keep_row_bound); rebuild the full range on the host
        kr = min(out.shape[1], n_range)
        host = np.zeros((2, n_range, e0 - s0), np.float16)
        if kr > 0:
            part = out.numpy()[:, :kr, :e0 - s0]
            if part.dtype == np.uint8:
                part = _U8_PROB_DEQUANT[part]
            host[:, :kr, :] = part
        timer.stop("d2h")
        if lab is not None:
            # the exported labels take the device write mask itself (rows
            # at/below kr have keep False); float32 carries 4-digit LSSS
            # category codes that float16 would round
            lab_full = np.zeros((n_range, e0 - s0), np.float32)
            lab_full[:kr] = np.where(
                keep.numpy()[:kr, :e0 - s0],
                np.nan_to_num(lab[:kr, :e0 - s0], nan=0.0), 0.0)
            lab = lab_full
        return s0, e0, host, lab

    def prepare(s, e):
        """Host-side slab construction for one chunk (prefetch thread,
        overlapped with the device work of earlier chunks)."""
        s, e = int(s), int(e)
        w = e - s
        timer.start("host_slab", s)
        g = chunk_geometry(runner.window, o, n_range, n_pings, seabed_full,
                           seabed_has, s, e, is_zarr, fixed)
        R, C, Hs, row_cut, nr = g.R, g.C, g.Hs, g.row_cut, g.nr
        Hp = R * sh + 2 * o
        data_slab = np.zeros((Hs, g.Wp, len(runner.frequencies)),
                             np.uint16 if bf16_bits else np.float32)
        timer.start("host_fill", s)
        _fill_hwc_slab(reader, runner.frequencies, data_slab, g.slab_x0,
                       g.slab_x1, g.slab_y1, o, g.x_off)
        timer.stop("host_fill")

        # write-mask inputs: only rows [0, nr) (the grid-covered range;
        # under static_grid the static grid's rows, the pad rows NaN
        # labelled and beyond row_cut)
        timer.start("host_label", s)
        if is_zarr:
            lab = reader.get_label_slice(s, w, 0, row_cut)  # (w, row_cut)
        else:
            lab = np.asarray(
                reader.label_memmap()[:row_cut, s:e]).astype(np.float32).T
        label_pad = None
        if save_labels:
            # the export needs the raw label map itself
            label_pad = np.full((nr, C * sw), np.nan, np.float32)
            label_pad[:row_cut, :w] = lab.T
            fin_pad = np.isfinite(label_pad)
            zero_pad = label_pad == 0
        else:
            fin_pad = np.zeros((nr, C * sw), bool)
            zero_pad = np.zeros((nr, C * sw), bool)
            fin_pad[:row_cut, :w] = np.isfinite(lab).T
            zero_pad[:row_cut, :w] = (lab == 0).T
        timer.stop("host_label")
        sb_vec = np.full(C * sw, BIG_ROW, np.int64)
        sb_vec[:w] = np.where(seabed_has[s:e], seabed_full[s:e], BIG_ROW)
        y0s, x0s = make_grid_starts(R, C, *runner.stride, o, o, o)
        meta = {}
        if runner.use_meta:
            # metadata channels of the whole grid (memmap only: the
            # builders raise ValueError on a zarr reader, as the JAX
            # package does)
            if slab_mode:
                meta["meta_full"] = _build_meta_slab_full(
                    runner, reader, Hp, g.Wp, -o, s - o)
            else:
                centers_x = grid_center_cols(
                    s + np.tile(np.arange(C) * sw, R) - o, ww)
                meta_slab, consts = _build_meta_inputs(
                    runner, reader, Hp, g.Wp, -o, s - o, centers_x)
                _, Np, _ = runner._sub_batch_shape(len(y0s))
                meta["meta_slab"] = meta_slab.transpose(1, 2, 0)
                meta["consts"] = np.pad(consts,
                                        ((0, Np - len(y0s)), (0, 0)))
        timer.stop("host_slab")

        # labels never ship: the write mask consults only isfinite(label)
        # and label == 0, packed to 1 bit/px here on the exact float32
        # host labels (bit-identical under every transfer_dtype)
        timer.start("h2d_dispatch", s)
        bit_planes = [np.packbits(fin_pad, axis=1),
                      np.packbits(zero_pad, axis=1)]
        if runner.transfer_dtype == "uint8":
            # host dB + 8-bit codes; channel-0 finiteness rides as a
            # packed bitmask since the codes cannot carry NaN
            svf = np.ones((nr, C * sw), bool)
            avail = max(min(nr, Hs - o), 0)  # rows beyond are zeros: finite
            w2 = C * sw if static else w
            svf[:avail, :w2] = np.isfinite(
                data_slab[o:o + avail, o:o + w2, 0])
            bit_planes.append(np.packbits(svf, axis=1))
            slab_xfer = torch.from_numpy(_quantize_db_u8(data_slab))
        elif bf16_bits:
            slab_xfer = torch.from_numpy(data_slab).view(torch.bfloat16)
        elif runner.transfer_dtype == "bfloat16":
            # round to nearest even, as ml_dtypes' float32 -> bfloat16
            slab_xfer = torch.from_numpy(data_slab).to(torch.bfloat16)
        else:
            slab_xfer = torch.from_numpy(data_slab)
        staged = _to_device(runner, dict(
            meta, data_slab=slab_xfer, lab_bits=np.stack(bit_planes),
            sb_row=np.append(sb_vec, np.int64(row_cut))), copy_stream)
        timer.stop("h2d_dispatch")
        # d2h crop bound, bucketed to 128-row multiples as in the JAX
        # package (keeps the d2h shapes few)
        kr = _keep_row_bound(fin_pad, zero_pad, sb_vec, row_cut, nr,
                             (sh, o) if is_zarr else None)
        kr = min(_round_up(kr, 128), nr)
        return s, e, w, R, C, nr, kr, g.border, y0s, x0s, staged, label_pad

    # the process's two prefetch threads (they keep their malloc arenas
    # from call to call; utils.general.process_pool)
    executor = process_pool("prefetch", 2)
    futs = collections.deque()
    head = True
    try:
        futs.extend(executor.submit(prepare, *sp) for sp in splits[:2])
        n_submitted = len(futs)

        for split in it:
            with timer.phase("wait_prefetch", int(split[0])):
                (s, e, w, R, C, nr, kr, border_ext, y0s, x0s, staged,
                 lab_host) = futs.popleft().result()
            if n_submitted < len(splits):
                futs.append(executor.submit(prepare, *splits[n_submitted]))
                n_submitted += 1

            if head:
                timer.stop("pass_head")
                head = False
            timer.start("device_chunk", s)
            started = None
            if is_cuda:
                # the chunk's time on the stream runs from here to
                # `event`
                started = torch.cuda.Event(enable_timing=True)
                started.record()
            dev = staged.ready()
            if slab_mode:
                stitched = runner._predict_slab(
                    dev["data_slab"], border_ext, R, C, dev.get("meta_full"))
            else:
                y0p, x0p = runner.grid_starts(y0s, x0s)
                stitched = runner._predict_patches(
                    dev["data_slab"], y0p, x0p, len(y0s), border_ext, R, C,
                    dev.get("meta_slab"), dev.get("consts"))
            # under static_grid the sv-finiteness columns are pinned to the
            # grid width: the pad columns carry NaN labels (keep False)
            out, keep = runner._mask_output(
                stitched, dev["lab_bits"], dev["data_slab"], dev["sb_row"],
                nr, C * sw, C * sw if static else w, zarr_pad=is_zarr)
            # lossless d2h crop: rows at/below kr are identically zero
            out = out[:, :kr, :]
            # the keep mask crosses only when labels are exported
            keep = keep[:kr] if lab_host is not None else None
            event = None
            if is_cuda:
                # async d2h into pinned memory; _drain waits on the event
                out, keep = (None if t is None else
                             torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True).copy_(
                                 t, non_blocking=True)
                             for t in (out, keep))
                event = torch.cuda.Event(enable_timing=True)
                event.record()
            pending.append((s, e, out, keep, started, event, lab_host))
            timer.stop("device_chunk")
            if len(pending) >= pipeline_depth:
                yield _drain(pending.pop(0))

        for entry in pending:
            yield _drain(entry)
    finally:
        # deterministic teardown: abandoning the generator must not leave
        # prefetch threads staging chunks in the background
        settle(futs)
        if head:
            timer.stop("pass_head")


def _ping_chunk(preload_n_pings: int) -> int:
    """On-disk ping_time chunk width of prediction stores: follows
    preload_n_pings, capped at the reference's 1000-ping contract; a
    non-positive value means the default chunking (predict_reader treats
    <= 0 as 5000-ping chunks)."""
    return min(1000, preload_n_pings) if preload_n_pings > 0 else 1000


def _resume_point(group, target_dname, save_labels) -> int:
    """The ping a resumed store continues from: the joint commit point of
    its arrays (a crash between the annotation and the ping_time append
    leaves them at different lengths; the longer ones are truncated).
    ``save_labels`` must match the existing store."""
    if save_labels and "labels" not in group:
        raise ValueError(
            f"Cannot resume {target_dname} with save_labels=True: the "
            "existing store has no 'labels' array (it was written "
            "without save_labels)")
    if not save_labels and "labels" in group:
        raise ValueError(
            f"Cannot resume {target_dname} with save_labels=False: the "
            "existing store has a 'labels' array that would fall "
            "behind ping_time; pass save_labels=True")
    if save_labels and group["labels"].dtype == np.float16:
        # appends cast to the stored dtype: resuming a float16 store
        # would silently round 4-digit category codes
        raise ValueError(
            f"Cannot resume {target_dname}: its 'labels' array is "
            "float16 (written by an older version; codes above 2048 "
            "round silently) — re-run without resume_writing to "
            "rewrite the store at float32")
    # zarrlite's append is data-before-shape crash-consistent, so the
    # shapes are trustworthy high-water marks
    axes = {"annotation": 1, "ping_time": 0}
    if save_labels:
        axes["labels"] = 0
    start_ping = min(group[k].shape[a] for k, a in axes.items())
    for k, a in axes.items():
        if group[k].shape[a] != start_ping:
            shp = list(group[k].shape)
            shp[a] = start_ping
            group[k].resize(shp)
    return start_ping


def save_survey_predictions_zarr(runner, reader, target_dname,
                                 preload_n_pings=1000, resume_writing=False,
                                 model_name="model", progress=False,
                                 save_labels=False, fixed_R=None,
                                 fixed_C=None):
    """Write chunked predictions to a ``<name>_pred.zarr`` store with the
    reference's on-disk contract (save_predict.py:87-134): annotation array
    (category [27, 1], ping_time, range) float16, full-range chunks,
    append along ping_time, resume from the existing ping count.
    ``save_labels`` adds a masked (ping_time, range) float32 ``labels``
    array.  ``fixed_R``/``fixed_C``: the survey-level static grid (see
    predict_reader).

    Besides predict_reader's phases, the runner's timer holds
    ``pass_head`` from this call on (the removal of a store not resumed,
    ``store_remove``, inside it), each chunk's ``zarr_write`` on the
    writer thread and ``wait_writer``, this thread's wait for the
    chunk's write before it hands the next one over."""
    import os
    import shutil

    from ..data.zarrlite import ZGroup

    timer = runner.timer
    timer.start("pass_head")  # the first chunk's device_chunk ends it
    n_pings, n_range = reader.shape if reader.data_format == "zarr" else \
        (reader.shape[1], reader.shape[0])

    # in a process group every rank predicts every chunk and rank 0 writes
    writes = is_writer()
    group = None
    start_ping = 0
    if writes and not resume_writing:
        if os.path.isdir(target_dname):
            with timer.phase("store_remove"):
                shutil.rmtree(target_dname)
    elif writes and os.path.isdir(target_dname):
        group = ZGroup.open(target_dname)
        start_ping = _resume_point(group, target_dname, save_labels)
    # else: a resume over a survey whose previous run died before this
    # reader's store existed starts it fresh
    start_ping = broadcast_object(start_ping)

    def write_chunk(s, e, out, lab):
        nonlocal group
        timer.start("zarr_write", s)
        pred = out.transpose(0, 2, 1)  # -> (category, ping, range)
        if group is None:
            group = ZGroup.create(
                target_dname,
                attrs={"description": f"{model_name} predictions"})
            group.create_array(
                "annotation", (2, 0, n_range),
                (1, _ping_chunk(preload_n_pings), n_range),
                np.float16, fill_value=0, dims=["category", "ping_time",
                                                "range"],
                # reference output codec: Blosc zstd-3 BITSHUFFLE
                # (save_predict.py:128); zlib when blosc is unavailable
                compressor="blosc-zstd")
            group.create_array("category", (2,), (2,), np.int64,
                               fill_value=None, compressor=None,
                               dims=["category"])[:] = np.array([27, 1])
            group.create_array("range", (n_range,), (n_range,), np.float64,
                               fill_value=None, compressor=None,
                               dims=["range"])[:] = \
                np.asarray(reader.range_vector)
            tv = np.asarray(reader.time_vector)
            group.create_array("ping_time", (0,), (8192,), tv.dtype,
                               fill_value=None, compressor=None,
                               dims=["ping_time"])
        if save_labels and "labels" not in group:
            group.create_array(
                "labels", (0, n_range),
                (_ping_chunk(preload_n_pings), n_range),
                np.float32, fill_value=0, dims=["ping_time", "range"],
                compressor="blosc-zstd")
        group["annotation"].append(pred, axis=1)
        if save_labels:
            group["labels"].append(lab.T, axis=0)
        group["ping_time"].append(np.asarray(reader.time_vector[s:e]),
                                  axis=0)
        timer.stop("zarr_write")

    # one ordered writer thread (the process's): the encode + file appends
    # of chunk k overlap the device work of chunk k+1; appends stay
    # sequential along ping_time, and a writer failure surfaces on the
    # next submit or at the drain, before any out-of-order append
    writer = process_pool("writer", 1)
    pending_write = written = None
    try:
        for s, e, out, lab in _predict_chunks(runner, reader,
                                              preload_n_pings, start_ping,
                                              progress and writes,
                                              save_labels, fixed_R,
                                              fixed_C):
            if not writes:
                continue
            if pending_write is not None:
                # re-raises writer errors in order
                with timer.phase("wait_writer", written):
                    pending_write.result()
            pending_write = writer.submit(write_chunk, s, e, out, lab)
            written = s
        if pending_write is not None:
            with timer.phase("wait_writer", written):
                pending_write.result()
    finally:
        settle([pending_write])
    # a completed run of writes snapshots consolidated metadata, as
    # xarray-written stores carry; any append during the run dropped a
    # pre-existing snapshot, so a crash never leaves a stale one
    if group is not None:
        group.consolidate()
    barrier()
    return target_dname


def save_reader_predictions_memm(runner, reader, target_dname,
                                 preload_n_pings=1000, resume_writing=False,
                                 progress=False, fixed_R=None, fixed_C=None):
    """Memmap variant: accumulate into one (2, n_range, n_pings) array and
    save as .npy (save_predict.py:222-265; skips existing files when
    resuming).  ``fixed_R``/``fixed_C``: the survey-level static grid
    (memm surveys run one file per echogram)."""
    import os
    # in a process group every rank predicts and rank 0 writes
    writes = is_writer()
    if broadcast_object(resume_writing and os.path.isfile(target_dname)):
        return target_dname
    n_range, n_pings = reader.shape
    out = np.zeros((2, n_range, n_pings), np.float16)
    for s, e, chunk, _ in predict_reader(runner, reader, preload_n_pings, 0,
                                         progress and writes,
                                         fixed_R=fixed_R, fixed_C=fixed_C):
        out[:, :, s:e] = chunk
    if writes:
        np.save(target_dname, out)
    barrier()
    return target_dname
