"""GriddedRunner: the device side of gridded prediction and evaluation.

Holds the served (BatchNorm-folded by default) U-Net on its device and
the per-chunk programs of the JAX package's runner
(``crimac_unet_tpu/pipeline/runner.py``): ``_predict_patches`` (gather +
dB in the gather_db kernel, U-Net forward in sub-batches, softmax,
stitch), ``_predict_slab`` (``infer_mode: slab``: the whole chunk in one
gather_db window and one fully-convolutional forward), ``_mask_output``
(write-mask crop to the on-disk dtype) and ``_eval_patches`` (per-patch
test label chain, with the closing kernel, + forward + PR histogram
update), each with the metadata channels (early or late inject) when
``meta_channels`` is set, and the host builders of those channels.
Driven by pipeline/predict.py and pipeline/eval_gridded.py.

``mesh_devices`` (default 1; 0 = every rank of the process group) runs
the chunk programs data parallel over ``torch.distributed``
(parallel/mesh.py), as the JAX runner does over its device mesh: every
rank holds the whole chunk slab, gathers and forwards its own share of
each sub-batch's patches and all-gathers the probabilities; evaluation
gives each rank whole sub-batches and sums the chunk's histogram over
the ranks; slab mode splits the ping axis, each rank forwarding its
range plus a receptive-field halo.  Every rank then holds the same
outputs.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import LABEL_BOUNDARY_VAL, LABEL_IGNORE_VAL, SEABED_PAD
from ..data.meta_channels import get_in_channels, validate_meta_channels
from ..models.fold_bn import fold_for_serving
from ..models.weights import to_tensors
from ..ops import data_ops, label_ops, metrics
from ..ops.gather_db import gather_db
from ..ops.label_ops import BIG_ROW
from ..ops.stitch import stitch_patches
from ..parallel.mesh import (all_gather_cat, all_reduce_, get_mesh,
                             mesh_rank, mesh_size)
from ..utils.general import PhaseTimer
from .infer_common import _quantize_prob_u8, _round_up, _unpack_bits


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; without a card that raises, it does not fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU unless "
                "the caller passes device='cpu' (CLI: --device cpu)")
        return torch.device("cuda")
    return torch.device(device)


def sub_batch_shape(N: int, fwd_batch: int,
                    hard: int = 1) -> tuple[int, int, int]:
    """Split N patches into ``nb`` sub-batches of size ``B`` (padded
    total ``Np = nb*B``), minimizing padding waste subject to an 8-patch
    granularity: ``nb = ceil(N/fwd_batch)``, then ``B = ceil(N/nb)``
    rounded up to ``hard`` (the mesh size: every rank takes ``B/hard``),
    then to 8 (a multiple of ``hard``) when that fits under the
    ``fwd_batch`` cap (which bounds peak activation memory).  Returns
    ``(B, Np, nb)``."""
    nb = max(1, -(-N // max(fwd_batch, 1)))
    B = _round_up(-(-N // nb), hard)
    soft = _round_up(B, _round_up(8, hard))
    if soft <= max(fwd_batch, B):
        B = soft
    return B, nb * B, nb


class GriddedRunner:
    """Device programs for gridded patch-mode prediction over one model."""

    def __init__(self, model, state_dict, config, device=None):
        self.device = resolve_device(device if device is not None
                                     else config.get("device"))
        # serving optimization: fold BatchNorm into the conv weights
        # (default on; fold_bn: false keeps the BN forward for A/B checks)
        model, state_dict = fold_for_serving(model, to_tensors(state_dict),
                                             config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.window = tuple(config["patch_size"])       # (wh, ww)
        self.overlap = int(config["patch_overlap"])
        self.frequencies = sorted(config["frequencies"])
        self.fwd_batch = int(config.get("fwd_batch", 32))
        self.pipeline_depth = int(config.get("pipeline_depth", 3))
        # h2d slab quantization: 'bfloat16' (default; <=0.02 dB data
        # perturbation), 'float32' (exact), or 'uint8' (host-side dB +
        # 8-bit codes, <=0.147 dB)
        self.transfer_dtype = str(config.get("transfer_dtype", "bfloat16"))
        if self.transfer_dtype not in ("bfloat16", "float32", "uint8"):
            raise ValueError(f"transfer_dtype must be 'bfloat16', "
                             f"'float32' or 'uint8', "
                             f"got {self.transfer_dtype!r}")
        # d2h probabilities: 'float16' (the on-disk dtype) or 'uint8'
        # (round(p * 255) codes, dequantized on the host)
        self.output_dtype = str(config.get("output_dtype", "float16"))
        if self.output_dtype not in ("float16", "uint8"):
            raise ValueError(f"output_dtype must be 'float16' or 'uint8', "
                             f"got {self.output_dtype!r}")
        # 'patch' (the reference's window formulation) or 'slab' (one
        # fully-convolutional forward over the whole chunk; _predict_slab)
        self.infer_mode = str(config.get("infer_mode", "patch"))
        if self.infer_mode not in ("patch", "slab"):
            raise ValueError(f"infer_mode must be 'patch' or 'slab', "
                             f"got {self.infer_mode!r}")
        # static_grid: every chunk of a survey runs one grid shape (the
        # survey-max height, the full chunk width); a row cutoff in
        # _mask_output discards the pad rows (pipeline/predict.py)
        self.static_grid = bool(config.get("static_grid", False))
        self.meta_channels = config.get("meta_channels") or None
        validate_meta_channels(self.meta_channels)
        self.use_meta = get_in_channels(self.meta_channels) > 0
        self.late_meta = bool(config.get("late_meta_inject", False))
        # phases and counters: n_fwd_px / n_pad_px, the input pixels the
        # U-Net forwards and those of them that pad a sub-batch or a slab
        self.timer = PhaseTimer()
        self.forwards = 0           # U-Net forward calls (sub-batches)
        wh, ww = self.window
        self.stride = (wh - 2 * self.overlap, ww - 2 * self.overlap)
        self._grid_cache: dict = {}
        self._origin = torch.zeros(1, dtype=torch.int32, device=self.device)
        # data parallel over the process group's ranks (None: alone);
        # more ranks than the group holds raise (parallel/mesh.get_mesh)
        self.mesh = get_mesh(int(config.get("mesh_devices", 1)))
        self.fwd_batch = _round_up(self.fwd_batch, mesh_size(self.mesh))
        # slab mode's pooling alignment and ping-axis halo past a range's
        # aligned ends, the model's (16 and 96 for the depth-5 U-Net)
        self.alignment = self.model.alignment
        self.slab_halo = self.model.halo
        self._col_starts: dict = {}
        if self.infer_mode == "slab" and self.slab_halo is None:
            raise ValueError(
                f"infer_mode='slab' needs a model whose outputs read a "
                f"finite halo of the input; {type(self.model).__name__} "
                "attends over the whole window, so no slab can be cut "
                "from a survey: serve it with infer_mode: patch")
        if self.infer_mode == "slab":
            # slab outputs agree with patch mode in patch interiors only
            # when the slab's pooling grid lines up with every patch's:
            # stride and overlap multiples of 2**(depth-1).  The baseline
            # geometry (stride 216, overlap 20, alignment 16) is not, so
            # slab and patch outputs differ slightly at every pixel (JAX
            # runner.py:113-144, DIVERGENCES.md); alignment_warning: false
            # silences the warning (config_serving.yaml)
            div = self.alignment
            if (self.stride[0] % div or self.stride[1] % div
                    or self.overlap % div) and \
                    bool(config.get("alignment_warning", True)):
                warnings.warn(
                    f"infer_mode='slab' with stride {self.stride} / overlap "
                    f"{self.overlap} not multiples of 2**(depth-1)={div}: "
                    "the slab pooling grid is misaligned with the patch "
                    "grid, so outputs diverge (slightly) from patch mode at "
                    "every pixel, not only near patch borders "
                    "(see DIVERGENCES.md)", stacklevel=2)

    def _sub_batch_shape(self, N: int) -> tuple[int, int, int]:
        return sub_batch_shape(N, self.fwd_batch, mesh_size(self.mesh))

    def _eval_sub_batch_shape(self, N: int) -> tuple[int, int, int]:
        """Evaluation's split: one rank's, since every rank evaluates
        whole sub-batches (``_eval_patches``)."""
        return sub_batch_shape(N, self.fwd_batch)

    def _my_rows(self, k: int, B: int) -> slice:
        """This rank's patches of sub-batch ``k`` (all ``B`` of them
        alone): each rank gathers and forwards its own ``B/N`` from its
        copy of the slab, as the JAX runner's ``_shard_nb`` does."""
        b = B // mesh_size(self.mesh)
        r = mesh_rank(self.mesh)
        return slice(k * B + r * b, k * B + (r + 1) * b)

    def grid_starts(self, y0s: np.ndarray, x0s: np.ndarray):
        """Device copies of a grid's patch starts, zero-padded to the
        sub-batch total (as the JAX runner pads them) and cached per grid
        — they are identical for every chunk of one grid shape."""
        key = (y0s.tobytes(), x0s.tobytes())
        dev = self._grid_cache.get(key)
        if dev is None:
            _, Np, _ = self._sub_batch_shape(len(y0s))
            pad = np.zeros(Np - len(y0s), np.int32)
            dev = tuple(torch.from_numpy(np.concatenate([a, pad])).to(
                self.device) for a in (y0s, x0s))
            self._grid_cache[key] = dev
        return dev

    def _gather_meta(self, meta_slab, consts, y0s, x0s):
        """(B, wh, ww, M) NHWC metadata patches: the per-patch constant
        channels (portion_year/day) broadcast, then the per-pixel channels
        (time_diff, depth_*) gathered from the (Hp, Wp, Ms) HWC meta slab —
        the reference's channel order (dataset.py:288-351).  ``consts`` is
        (B, Mc); the starts lie inside the slab."""
        wh, ww = self.window
        B = y0s.shape[0]
        parts = []
        if consts.shape[1] > 0:
            parts.append(consts[:, None, None, :].expand(B, wh, ww, -1))
        if meta_slab.shape[-1] > 0:
            dev = meta_slab.device
            rows = (y0s.long()[:, None] + torch.arange(wh, device=dev))
            cols = (x0s.long()[:, None] + torch.arange(ww, device=dev))
            parts.append(meta_slab[rows[:, :, None], cols[:, None, :]])
        return torch.cat(parts, dim=-1)

    def _forward(self, x, meta):
        """U-Net forward with the metadata channels: early inject appends
        them to the input bands, late inject hands them to the model's
        metadata MLP.  ``meta`` is None without metadata channels."""
        if meta is None:
            return self.model(x)
        if self.late_meta:
            return self.model(x, meta)
        return self.model(torch.cat([x, meta.to(x.dtype)], dim=-1))

    def _predict_patches(self, data_slab, y0p, x0p, N, border_ext, R, C,
                         meta_slab=None, consts=None):
        """Gather + dB + forward + softmax + stitch for one chunk: returns
        (R*sh, C*sw, 2) float32 [sandeel, other] probabilities in grid
        coordinates.  ``data_slab`` is the chunk's (Hs <= Hp, Wp, C) HWC
        slab on the device (rows below Hs are the zero pad, re-grown by the
        kernel); ``y0p``/``x0p`` the padded starts of ``grid_starts``;
        ``border_ext`` the data rectangle (y0, y1, x0, x1) or None.  With
        metadata channels the network input is the [0, 1]-scaled dB
        (reference db_with_limits_scaled), the border zeroes only the
        acoustic channels, and ``meta_slab`` (Hp, Wp, Ms) / ``consts``
        (Np, Mc) hold the metadata (``_build_meta_inputs``)."""
        wh, ww = self.window
        B, Np, nb = self._sub_batch_shape(N)
        self.timer.count("n_fwd_px", Np * wh * ww)
        self.timer.count("n_pad_px", (Np - N) * wh * ww)
        b = B // mesh_size(self.mesh)
        sel = torch.empty((nb, b, wh, ww, 2), dtype=torch.float32,
                          device=self.device)
        for k in range(nb):
            sl = self._my_rows(k, B)
            x = gather_db(data_slab, y0p[sl], x0p[sl], self.window,
                          border=border_ext, scaled=self.use_meta,
                          out_dtype=self.model.dtype)
            meta = self._gather_meta(meta_slab, consts[sl], y0p[sl],
                                     x0p[sl]) if self.use_meta else None
            logits = self._forward(x, meta)
            sel[k] = torch.softmax(logits, dim=-1)[..., 1:3]
            self.forwards += 1
        if self.mesh is not None:
            # one collective a chunk: (N, nb, b) rank-major -> (nb, B)
            sel = all_gather_cat(sel[None], self.mesh).transpose(0, 1)
        return stitch_patches(sel.reshape(Np, wh, ww, 2)[:N], R, C,
                              self.overlap)

    def _predict_slab(self, data_slab, border_ext, R, C, meta_full=None):
        """Fully-convolutional whole-chunk forward (``infer_mode: slab``,
        JAX runner.py ``_predict_slab``): returns (R*sh, C*sw, 2) float32
        [sandeel, other] probabilities in grid coordinates.

        The front end is one gather_db launch over the whole grid padded
        to the pooling alignment: N = 1, start (0, 0), window (H16, W16).
        Rows in [Hs, Hp) read as raw zeros (-75 dB, or code 0), and
        everything outside ``border`` comes out 0.0, the H16/W16 pad
        included — the JAX chain's _pad_slab, dB, border ``where`` and
        ``jnp.pad``.  ``border_ext`` is the memmap data rectangle; zarr
        chunks (None) zero only outside the (Hp, Wp) grid.  ``meta_full``
        (Hp, Wp, M) holds the metadata channels of the whole grid
        (``_build_meta_slab_full``), zero-padded to (H16, W16) here.

        Under a mesh of N ranks the ping axis is split (sequence
        parallelism; the JAX runner shards it and lets GSPMD exchange the
        halos): W16 rounds up to ``2**(depth-1) * N``, rank r runs K1 and
        the U-Net on its W16/N pings plus ``halo`` pings on each inner
        side (``slab_halo``: how far an interior output reads past an
        aligned end, rounded up to the pooling alignment, so the window
        keeps the global pooling grid and no interior output sees the
        window's edge), keeps its interior and all-gathers it."""
        sh, sw = self.stride
        o = self.overlap
        Hp, Wp = R * sh + 2 * o, C * sw + 2 * o
        div = self.alignment  # pooling alignment
        n = mesh_size(self.mesh)
        H16, W16 = _round_up(Hp, div), _round_up(Wp, div * n)
        border = border_ext if border_ext is not None else (0, Hp, 0, Wp)
        # this rank's interior [a, b) and its haloed window [c0, c1)
        r = mesh_rank(self.mesh)
        a, b = r * W16 // n, (r + 1) * W16 // n
        c0, c1 = max(a - self.slab_halo, 0), min(b + self.slab_halo, W16)
        self.timer.count("n_fwd_px", H16 * (c1 - c0))
        self.timer.count("n_pad_px", H16 * (c1 - c0)
                         - Hp * max(min(c1, Wp) - c0, 0))
        x = gather_db(data_slab, self._origin, self._col_start(c0),
                      (H16, c1 - c0), border=border, scaled=self.use_meta,
                      out_dtype=self.model.dtype)
        meta = None
        if self.use_meta:
            meta = F.pad(meta_full, (0, 0, 0, W16 - Wp, 0, H16 - Hp))[
                None, :, c0:c1]
        logits = self._forward(x, meta)[0]
        self.forwards += 1
        probs = torch.softmax(logits, dim=-1)[:, a - c0:b - c0]
        if self.mesh is not None:
            probs = all_gather_cat(probs.contiguous(), self.mesh, dim=1)
        return probs[o:o + R * sh, o:o + C * sw, 1:3]

    def _col_start(self, c0: int) -> torch.Tensor:
        """The device copy of a slab window's first column (cached)."""
        t = self._col_starts.get(c0)
        if t is None:
            t = torch.full((1,), c0, dtype=torch.int32, device=self.device)
            self._col_starts[c0] = t
        return t

    def _mask_output(self, stitched, lab_bits, data_slab, sb_row,
                     n_range, n_pings, chunk_w, zarr_pad=False):
        """Crop stitched grid output to the chunk extent, apply the write
        masks, emit the d2h dtype.

        ``lab_bits`` stacks the host-packed label predicates (plane 0 =
        isfinite(label), plane 1 = label == 0, optional plane 2 = channel-0
        sv finiteness under uint8 transfer); ``sb_row`` is the per-ping
        seabed row vector with the reference grid's ``row_cut`` appended.
        Without plane 2 the sv finiteness is read from channel 0 of the
        slab already on the device (survey ping ``s + j`` at slab column
        ``overlap + j``).

        The seabed exclusion depends on the survey format: the reference
        zarr reader shifts the *sliced* bottom mask down by SEABED_PAD
        (data_reader.py:841-846), so a row in the patch band whose top
        data row is ``band_top`` masks from ``max(seabed, band_top) +
        pad`` (``zarr_pad``); the memmap reader clamps to
        ``max(seabed + pad, patch_top)`` (data_reader.py:407-431), which
        within a patch interior is ``seabed + pad``.

        Returns ``(out, keep)``: ``(2, n_range, n_pings)`` float16
        probabilities (uint8 codes under ``output_dtype: uint8``) and the
        bool write mask, which save_labels applies to the exported labels
        (``out != 0`` would drop kept pixels whose probability underflows
        to 0)."""
        Hs, Ws, _ = stitched.shape
        dev = stitched.device
        seabed, row_cut = sb_row[:-1], sb_row[-1]
        img = torch.zeros((n_range, n_pings, 2), dtype=torch.float32,
                          device=dev)
        h, w = min(Hs, n_range), min(Ws, n_pings)
        img[:h, :w] = stitched[:h, :w]
        rows = torch.arange(n_range, device=dev)[:, None]
        o = self.overlap
        if zarr_pad:
            sh = self.stride[0]
            band_top = torch.clamp((rows // sh) * sh - o, min=0)
            below = rows >= torch.maximum(seabed[None, :], band_top) \
                + SEABED_PAD
        else:
            below = rows >= seabed[None, :] + SEABED_PAD
        if lab_bits.shape[0] >= 3:
            sv_fin = _unpack_bits(lab_bits[2], n_pings)
        else:
            # rows below the shipped slab are its zero pad: finite
            w2 = min(chunk_w, n_pings)
            avail = max(min(n_range, data_slab.shape[0] - o), 0)
            sv_fin = torch.ones((n_range, n_pings), dtype=torch.bool,
                                device=dev)
            sv_fin[:avail, :w2] = torch.isfinite(
                data_slab[o:o + avail, o:o + w2, 0])
        keep = (_unpack_bits(lab_bits[0], n_pings) & sv_fin
                & ~(below & _unpack_bits(lab_bits[1], n_pings)))
        keep &= rows < row_cut
        out = torch.where(keep[:, :, None], img, 0.0).permute(
            2, 0, 1).contiguous()
        if self.output_dtype == "uint8":
            return _quantize_prob_u8(out), keep
        return out.to(torch.float16), keep

    def _eval_patches(self, hist, data_slab, label_slab, sb_pad, keep_slab,
                      thr_slab, starts, N, grid_h, zarr_pad=False,
                      meta_slab=None, consts=None):
        """Per-patch test label chain + forward + PR histogram update for
        one column group; adds into the int32 ``hist`` in place and
        returns it.

        ``data_slab`` (Hs <= grid_h, Wp, C) HWC and ``label_slab`` (Hs, Wp)
        are in padded grid coordinates; the rows below Hs are re-grown here
        with the host's fill values (data zeros; labels BOUNDARY, or IGNORE
        for the int8 labels of a quantized transfer).  ``sb_pad`` (Wp,) is
        the absolute seabed row per slab column (BIG_ROW where absent);
        ``keep_slab`` the (grid_h, Wp) region/trace keep mask or None;
        ``thr_slab`` the packed refine-threshold predicate rows of a
        quantized transfer (the int8 label slab is the signal) or None;
        ``starts`` (4, Np) int32: patch starts y0, x0, each patch's first
        data row and its live flag (0 for the sub-batch pad), padded to
        the sub-batch total.  ``zarr_pad``: a zarr survey, with the zarr
        reader's seabed law and no border zeroing (the reference's zarr
        eval transform has none, evaluate.py:47).  ``meta_slab`` (Hp, Wp,
        Ms) and ``consts`` (Np, Mc): the metadata channels when the
        runner has them (``_build_meta_inputs``)."""
        wh, ww = self.window
        dev = data_slab.device
        use_thr = label_slab.dtype == torch.int8
        # re-grow the pad rows the host did not ship
        ph = max(grid_h - data_slab.shape[0], 0)
        if ph:
            data_slab = torch.cat([data_slab, data_slab.new_zeros(
                (ph,) + tuple(data_slab.shape[1:]))])
            label_slab = torch.cat([label_slab, label_slab.new_full(
                (ph, label_slab.shape[1]),
                LABEL_IGNORE_VAL if use_thr else LABEL_BOUNDARY_VAL)])
        thr_bool = None
        if use_thr:
            if thr_slab is None:
                raise ValueError(
                    "int8 (pre-converted) label slab without a threshold "
                    "predicate slab: quantized-transfer eval ships both")
            thr_bool = _unpack_bits(thr_slab, data_slab.shape[1])
            # pad rows are host zeros: (0 > lo) & (0 < hi) is False
            thr_bool = torch.cat([thr_bool, thr_bool.new_zeros(
                (max(grid_h - thr_bool.shape[0], 0), thr_bool.shape[1]))])

        B, Np, nb = self._eval_sub_batch_shape(N)
        ar_h = torch.arange(wh, device=dev)
        ar_w = torch.arange(ww, device=dev)
        # under a mesh each rank counts whole sub-batches, k = rank mod N,
        # into its own histogram, summed over the ranks at the end of the
        # group: every forward then sees what it sees on one rank, so the
        # integer sum is the one rank's bit for bit on any device (split
        # sub-batches run the convolutions at another batch size, whose
        # cuDNN kernels round otherwise)
        mine = hist if self.mesh is None else torch.zeros_like(hist)
        for k in range(mesh_rank(self.mesh), nb, mesh_size(self.mesh)):
            sl = slice(k * B, (k + 1) * B)
            y0b, x0b, py0b, cvb = starts[:, sl]
            rows = (y0b[:, None] + ar_h)[:, :, None]      # (B, wh, 1)
            cols = (x0b[:, None] + ar_w)[:, None, :]      # (B, 1, ww)
            data = data_slab[rows, cols]                  # (B, wh, ww, C)
            if not use_thr:
                # float32 (exact) mode: refine reads the scrubbed raw sv
                # (the reference's eval crops scrub before any transform)
                data = torch.where(torch.isfinite(data), data, 0.0)
            labels = label_slab[rows, cols]
            labels = labels.to(torch.int32) if use_thr \
                else _float_to_int32(labels)

            sb_abs = sb_pad[x0b[:, None] + ar_w]          # (B, ww)
            sy0 = torch.clamp(py0b, min=0)[:, None]
            if zarr_pad:
                # zarr: max(seabed, patch_top) + pad
                # (data_reader.py:841-846)
                thresh = torch.maximum(sb_abs, sy0) + SEABED_PAD
            else:
                # memmap: max(seabed + pad, patch_top)
                # (data_reader.py:407-431)
                thresh = torch.maximum(sb_abs + SEABED_PAD, sy0)
            sb_rows = torch.clamp(thresh - py0b[:, None], -(10 ** 6),
                                  BIG_ROW).to(torch.int32)

            # label test chain (transforms.py:78-92)
            thr = None
            if use_thr:
                lab = labels
                thr = thr_bool[rows, cols]
            else:
                lab = label_ops.convert_label_indexing(
                    labels, mark_unused_species=True)
            lab = label_ops.refine_label_boundary(
                data, lab, threshold_freq_idx=-1, channels_last=True,
                threshold_mask=thr)
            lab = label_ops.mask_label_seabed(lab, sb_rows)
            lab = label_ops.mask_label_overlap(lab, self.overlap)
            if keep_slab is not None:
                lab = torch.where(keep_slab[rows, cols], lab, -1)
            # pad patches contribute nothing (after the keep override,
            # which would otherwise make them -1 negatives)
            lab = torch.where(cvb[:, None, None] > 0, lab, LABEL_IGNORE_VAL)

            d = data_ops.net_db_input(data, scaled=self.use_meta)
            if not zarr_pad:
                # memmap eval zeroes dB data at the boundary (the
                # reference's define_data_transform_test; its zarr eval
                # does not)
                d = data_ops.set_data_border_value(d, lab,
                                                   channels_last=True)
            meta = None
            if self.use_meta:
                meta = self._gather_meta(meta_slab, consts[sl], y0b, x0b)
            probs = torch.softmax(self._forward(d, meta), dim=-1)
            metrics.update_pr_histogram(mine, probs[..., 1], lab)
            self.forwards += 1
        if self.mesh is not None:
            hist += all_reduce_(mine, self.mesh)
        return hist


def _float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts (``astype(jnp.int32)``): truncation
    toward zero, NaN -> 0, saturation at the int32 range.  torch's cast
    leaves NaN and out-of-range values undefined, and CPU and CUDA differ
    there; a memmap label file of a float dtype can hold NaN."""
    x = torch.where(torch.isnan(x), 0.0, x).to(torch.float64)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _build_meta_inputs(runner, reader, Hp, Wp, row0_data, col0_data,
                       centers_x):
    """Host construction of the metadata inputs of the gridded device
    programs (memmap-only, like the reference): the per-pixel channels as
    an (Ms, Hp, Wp) slab in padded grid coordinates + the (N, Mc)
    per-patch constant channels, in float64 host arithmetic cast once to
    float32 (JAX runner.py ``_build_meta_inputs``).

    The reference meta grid is offset (-1, -1) relative to the data crop
    (``arange(center - w//2, ...)`` without the +1 shift,
    dataset.py:306-345), hence the ``- 1`` below."""
    if reader.data_format != "memmap":
        raise ValueError(
            "metadata channels are memmap-only (reference "
            "dataset.py:245-252)")
    mc = runner.meta_channels
    wh = runner.window[0]
    n_pings = reader.shape[1]
    rows = np.arange(Hp, dtype=np.float64) + row0_data - 1
    cols = np.arange(Wp) + col0_data - 1
    cc = np.clip(cols, 0, n_pings - 1)
    centers_x = np.asarray(centers_x)

    consts_parts = []
    if mc.get("portion_year"):
        consts_parts.append(np.full(len(centers_x),
                                    reader.portion_of_year_scalar))
    if mc.get("portion_day"):
        idx = np.clip(centers_x, 0, reader.portion_of_day_vector.size - 1)
        pd = reader.portion_of_day_vector[idx]
        consts_parts.append(np.sin(2 * np.pi * pd))
        consts_parts.append(np.cos(2 * np.pi * pd))
    consts = (np.stack(consts_parts, axis=1) if consts_parts
              else np.zeros((len(centers_x), 0)))

    slab_parts = []
    if mc.get("time_diff"):
        slab_parts.append(np.broadcast_to(
            reader.time_vector_diff[cc][None, :], (Hp, Wp)))
    if any(mc.get(k) for k in ("depth_rel", "depth_abs_surface",
                               "depth_abs_seabed")):
        sb = np.asarray(reader.get_seabed(0, n_pings)).astype(np.float64)
        sbc = sb[cc]
        if mc.get("depth_rel"):
            slab_parts.append(rows[:, None] / sbc[None, :])
        if mc.get("depth_abs_surface"):
            slab_parts.append(np.broadcast_to(rows[:, None] / wh, (Hp, Wp)))
        if mc.get("depth_abs_seabed"):
            slab_parts.append((sbc[None, :] - rows[:, None]) / wh)
    meta_slab = (np.stack(slab_parts).astype(np.float32) if slab_parts
                 else np.zeros((0, Hp, Wp), np.float32))
    return meta_slab, consts.astype(np.float32)


def _build_meta_slab_full(runner, reader, Hp, Wp, row0_data, col0_data):
    """(Hp, Wp, M) metadata channels of the fully-convolutional slab
    forward (``infer_mode: slab``), in the patch path's channel order
    (reference dataset.py:288-351): portion_year, portion_day sin/cos,
    time_diff, depth_rel, depth_abs_surface, depth_abs_seabed (JAX
    runner.py ``_build_meta_slab_full``).

    The per-pixel families use the patch law of ``_build_meta_inputs``
    exactly.  The per-patch-constant ones differ by construction: the
    slab forward has no patches, so each column carries its own ping's
    portion_day instead of the owning patch center's (portion_year is a
    survey scalar either way; DIVERGENCES.md)."""
    mc = runner.meta_channels
    per_pixel, _ = _build_meta_inputs(runner, reader, Hp, Wp, row0_data,
                                      col0_data, np.zeros(0, np.int64))
    # the per-pixel families' clipped column mapping, -1 meta-grid offset
    # included, so all channels stay aligned
    cols = np.arange(Wp) + col0_data - 1
    cc = np.clip(cols, 0, reader.shape[1] - 1)
    parts = []
    if mc.get("portion_year"):
        parts.append(np.full((Hp, Wp), reader.portion_of_year_scalar,
                             np.float32))
    if mc.get("portion_day"):
        pd = reader.portion_of_day_vector[cc]
        for f in (np.sin, np.cos):
            parts.append(np.broadcast_to(
                f(2 * np.pi * pd)[None, :].astype(np.float32), (Hp, Wp)))
    consts_full = (np.stack(parts) if parts
                   else np.zeros((0, Hp, Wp), np.float32))
    full = np.concatenate([consts_full, per_pixel], axis=0)
    return np.ascontiguousarray(full.transpose(1, 2, 0)).astype(np.float32)
