"""Full-reader gridded evaluation: PR-histogram accumulation on the device.

Reproduces the reference's sliding-window eval (evaluate.py:39-117,
pipeline.py:343-376), as the JAX package's
``crimac_unet_tpu/pipeline/eval_gridded.py`` does, as a software-pipelined
column-group loop over ``GriddedRunner._eval_patches``: a prefetch thread
builds the next group's host slabs and starts their host-to-device copy
on a side stream from pinned memory while the main thread enqueues the
current group, and each group's int32 histogram is drained into an int64
host total one group behind.  Memmap and zarr surveys; metadata channels
(memmap) and the static grid (``fixed_R``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LABEL_BOUNDARY_VAL
from ..ops import metrics
from ..ops.label_ops import (BIG_ROW, REFINE_THRESHOLD_HI,
                             REFINE_THRESHOLD_LO)
from ..ops.patches import grid_dims, make_grid_starts
from ..utils.general import process_pool, settle
from .infer_common import (_convert_labels_host, _fill_hwc_slab,
                           _grid_extent_rows, _quantize_db_u8,
                           grid_center_cols)
from .predict import _to_device
from .runner import GriddedRunner, _build_meta_inputs


def evaluate_reader(runner: GriddedRunner, reader, hist, eval_mode="all",
                    extend_size=20, chunk_cols=8, progress=False,
                    fixed_R=None):
    """Accumulate the PR histogram over a full reader's sliding-window
    grid (evaluate.py:39-117 + validate_model_testing pipeline.py:343-376);
    memmap surveys are read as (range, ping), zarr surveys as (ping,
    range).

    The grid runs in groups of ``chunk_cols`` columns, the last one
    narrower (the JAX package pads it to one static group shape, whose
    pad columns score nothing; eager torch needs no static shape).
    Returns a host int64 histogram: each group accumulates on the device
    in int32 and is drained one group behind into a 64-bit total, so
    survey-scale counts cannot wrap.  ``hist`` is an incoming histogram
    (any integer array, host or device) to add to.

    ``fixed_R`` (static_grid over several readers): the grid runs at
    least ``fixed_R`` rows; the pad-row patches are force-ignored through
    the live flag, so the histogram is the per-reader one exactly (JAX
    eval_gridded.py:46-65).
    """
    wh, ww = runner.window
    o = runner.overlap
    sh, sw = runner.stride
    is_zarr = reader.data_format == "zarr"
    if is_zarr:
        n_pings, n_range = reader.shape
    else:
        n_range, n_pings = reader.shape
    is_cuda = runner.device.type == "cuda"

    seabed_full = np.asarray(reader.get_seabed(0, n_pings)).astype(np.int64)
    seabed_has = np.asarray(reader.seabed_known(0, n_pings))
    sb_abs = np.where(seabed_has, seabed_full, BIG_ROW).astype(np.int64)

    R_ref = _grid_extent_rows(n_range, seabed_full, seabed_has, wh, o)
    R = max(R_ref, int(fixed_R)) if fixed_R else R_ref
    C_total = grid_dims(0, n_pings, ww, o)
    col_groups = [(j, min(j + chunk_cols, C_total))
                  for j in range(0, C_total, chunk_cols)]
    Hp = R * sh + 2 * o

    keep_global = None
    keep_pad = (0, 0)
    if eval_mode in ("region", "trace"):
        # padded frame covering every consulted slab pixel, out-of-survey
        # grid margins included (the reference masks those too); the
        # static grid's pad rows are never consulted
        keep_pad = (max(o, R_ref * sh + o - n_range, 0),
                    max(o, C_total * sw + o - n_pings, 0))
        keep_global = _build_keep_mask(reader, eval_mode, extend_size,
                                       n_range, n_pings, pad=keep_pad)
    copy_stream = torch.cuda.Stream(runner.device) if is_cuda else None

    def prepare(j0, j1):
        """Host slabs of columns [j0, j1) and their h2d copy (prefetch
        thread)."""
        Cc = j1 - j0
        # the slab covers all patches of the group: x in
        # [j0*sw - o, (j1-1)*sw - o + ww)
        want_x0 = j0 * sw - o
        want_x1 = (j1 - 1) * sw - o + ww
        slab_x0 = max(0, min(want_x0, n_pings))
        slab_x1 = min(n_pings, want_x1)
        Wp = Cc * sw + 2 * o
        sw_w = max(slab_x1 - slab_x0, 0)

        runner.timer.start("eval_host_slab")
        # filled (and labels read) to the reference grid's bottom row only:
        # the static grid's pad-row patches are force-ignored
        slab_y1 = min(n_range, R_ref * sh + o)
        # ship only the data-bearing rows; _eval_patches re-grows the pad
        Hs = min(o + slab_y1, Hp)
        data_slab = np.zeros((Hs, Wp, len(runner.frequencies)), np.float32)
        label_slab = np.full((Hs, Wp), float(LABEL_BOUNDARY_VAL),
                             np.float32)
        x_off = slab_x0 - want_x0
        if sw_w > 0:
            _fill_hwc_slab(reader, runner.frequencies, data_slab, slab_x0,
                           slab_x1, slab_y1, o, x_off)
            if is_zarr:
                # NaN labels (the store's range pad) become BOUNDARY on
                # the host, before any int cast could map them to 0
                lab = reader.get_label_slice(slab_x0, sw_w, 0, slab_y1)
                lab = np.nan_to_num(lab.T, nan=LABEL_BOUNDARY_VAL)
            else:
                lab = reader.label_memmap()[:slab_y1, slab_x0:slab_x1]
            label_slab[o:o + slab_y1, x_off:x_off + sw_w] = lab

        host = {}
        if keep_global is not None:
            # slab row i <-> survey row i - o, slab col j <-> want_x0 + j
            pr, pc = keep_pad
            Hp_ref = min(R_ref * sh + 2 * o, Hp)
            keep_slab = np.zeros((Hp, Wp), np.bool_)
            keep_slab[:Hp_ref] = keep_global[
                pr - o:pr - o + Hp_ref, pc + want_x0:pc + want_x0 + Wp]
            host["keep_slab"] = keep_slab

        sb_pad = np.full(Wp, BIG_ROW, np.int64)
        if sw_w > 0:
            sb_pad[x_off:x_off + sw_w] = sb_abs[slab_x0:slab_x1]

        y0s, x0s = make_grid_starts(R, Cc, sh, sw, o, o, o)
        patch_y0_data = np.repeat(np.arange(R) * sh, Cc) - o
        # live flag: 0 for the static grid's pad rows (beyond the
        # reference grid) and the sub-batch pad below
        live = np.repeat(np.arange(R) < R_ref, Cc)
        starts = np.stack([y0s, x0s, patch_y0_data, live]).astype(np.int32)
        _, Np, _ = runner._eval_sub_batch_shape(len(y0s))
        starts = np.pad(starts, ((0, 0), (0, Np - len(y0s))))
        if runner.use_meta:
            # memmap only: the builder raises ValueError on a zarr reader
            centers_x = grid_center_cols(
                np.tile(np.arange(j0, j1) * sw, R) - o, ww)
            meta_slab, consts = _build_meta_inputs(
                runner, reader, Hp, Wp, -o, want_x0, centers_x)
            host["meta_slab"] = meta_slab.transpose(1, 2, 0)
            host["consts"] = np.pad(consts, ((0, Np - len(y0s)), (0, 0)))

        # transfer_dtype quantization: the refine threshold predicate is
        # computed here from the exact float32 sv and ships as packed bits,
        # labels ship pre-converted int8, so the label chain is bit-equal
        # to float32 and only the network input quantizes
        if runner.transfer_dtype != "float32":
            ch = data_slab[..., -1]  # threshold channel (200 kHz)
            host["thr_slab"] = np.packbits((ch > REFINE_THRESHOLD_LO)
                                           & (ch < REFINE_THRESHOLD_HI),
                                           axis=1)
            label_slab = _convert_labels_host(label_slab)
            if runner.transfer_dtype == "uint8":
                data_slab = torch.from_numpy(_quantize_db_u8(data_slab))
            else:
                # round to nearest even, as ml_dtypes' float32 -> bfloat16
                data_slab = torch.from_numpy(data_slab).to(torch.bfloat16)
        runner.timer.stop("eval_host_slab")

        runner.timer.start("eval_h2d_dispatch")
        staged = _to_device(runner, dict(
            host, data_slab=data_slab, label_slab=label_slab,
            sb_pad=sb_pad, starts=starts), copy_stream)
        runner.timer.stop("eval_h2d_dispatch")
        return staged, len(y0s)

    it = col_groups
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(col_groups, desc="Evaluating ...")
        except ImportError:  # progress bars are optional
            pass

    hist_host = np.zeros((2, metrics.N_F16_BINS), np.int64)
    hist_host += np.asarray(torch.as_tensor(hist).cpu()).astype(np.int64)
    # the process's staging thread (utils.general.process_pool)
    executor = process_pool("eval-prefetch", 1)
    fut = None
    try:
        fut = executor.submit(prepare, *col_groups[0]) if col_groups \
            else None
        pending = None
        for idx, _ in enumerate(it):
            staged, N = fut.result()
            if idx + 1 < len(col_groups):
                fut = executor.submit(prepare, *col_groups[idx + 1])
            runner.timer.start("eval_device_chunk")
            dev = staged.ready()
            group_hist = runner._eval_patches(
                metrics.new_histogram(runner.device), dev["data_slab"],
                dev["label_slab"], dev["sb_pad"], dev.get("keep_slab"),
                dev.get("thr_slab"), dev["starts"], N, grid_h=Hp,
                zarr_pad=is_zarr, meta_slab=dev.get("meta_slab"),
                consts=dev.get("consts"))
            runner.timer.stop("eval_device_chunk")
            # drain one group behind: the copy waits only for the previous
            # group while this one is already enqueued
            if pending is not None:
                hist_host += pending.cpu().numpy().astype(np.int64)
            pending = group_hist
        if pending is not None:
            hist_host += pending.cpu().numpy().astype(np.int64)
    finally:
        settle([fut])
    return hist_host


def _build_keep_mask(reader, eval_mode, extend_size, n_range, n_pings,
                     pad=0):
    """Keep mask from extended school bboxes (extend_label_masks.py:35-98):
    region = bbox +- extend in both axes; trace = the full water column for
    pings within extend of a school.  ``pad`` is an int or a per-axis
    ``(row_pad, col_pad)``; returns a ``(n_range + 2*row_pad,
    n_pings + 2*col_pad)`` bool array where survey pixel ``(y, x)`` lives
    at ``(y + row_pad, x + col_pad)`` — the pad carries the mask of
    out-of-survey grid pixels, which the reference masks too.

    Reference quirks kept for parity (as in the JAX package):
    * off-by-one: the reference's mask crop origin is ``center - shape//2``
      (extend_label_masks.py:64) while the data/label crops use
      ``center - shape//2 + 1``, so its keep mask lands one pixel
      down-right of the annotations: every extended bbox is painted
      shifted by +1 in both axes (trace keeps rows [1, n_range + 1)).
    * no survey clamp: bbox painting is clamped to each crop, not to the
      survey (extend_label_masks.py:90-95), so out-of-survey grid pixels
      inside an extended bbox stay boundary (ignored) rather than counted
      ``-1`` negatives: painted unclamped into the padded frame."""
    pr, pc = (pad, pad) if np.isscalar(pad) else pad
    keep = np.zeros((n_range + 2 * pr, n_pings + 2 * pc), dtype=np.bool_)
    bboxes = reader.get_object_bounding_boxes()  # (n, 4) y0 y1 x0 x1
    for (y0, y1, x0, x1) in bboxes:
        if eval_mode == "region":
            ry0, ry1 = y0 - extend_size, y1 + extend_size
        else:
            ry0, ry1 = 0, n_range
        rx0, rx1 = x0 - extend_size, x1 + extend_size
        keep[max(ry0 + 1 + pr, 0):max(ry1 + 1 + pr, 0),
             max(rx0 + 1 + pc, 0):max(rx1 + 1 + pc, 0)] = True
    return keep
