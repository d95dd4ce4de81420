"""K1: fused patch gather + non-finite scrub + dB + clip + border zero.

The predict path's front end: from the chunk's HWC slab on the device,
gather every patch window, turn raw sv (or host dB codes) into the
network's dB input, zero the pixels outside the data rectangle and emit
NHWC patches in the compute dtype — one pass, one launch per forward
sub-batch.  Kernel: ``csrc/gather_db.cu`` (replaces
``crimac_unet_tpu/ops/pallas_gather.py`` ``gather_db_pallas`` and the XLA
gather of ``crimac_unet_tpu/pipeline/runner.py:345-358``), registered as the
operator ``crimac::gather_db`` (ops/cuda_lib.py ``define_op``).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .data_ops import net_db_input

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(slab, y0s, x0s, window, border, out_dtype):
    if slab.dim() != 3 or slab.shape[0] < 1 or slab.shape[1] < 1 \
            or slab.shape[2] < 1:
        raise ValueError(f"slab must be a non-empty (H, W, C) HWC array, "
                         f"got shape {tuple(slab.shape)}")
    if slab.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"slab dtype {slab.dtype} not in "
                         f"{list(cuda_lib.DTYPE_CODES)}")
    if not slab.is_contiguous():
        raise ValueError("slab must be contiguous")
    for name, t in (("y0s", y0s), ("x0s", x0s)):
        if t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if y0s.shape != x0s.shape or y0s.shape[0] < 1:
        raise ValueError(f"y0s/x0s must have one equal, non-zero length, "
                         f"got {tuple(y0s.shape)} and {tuple(x0s.shape)}")
    wh, ww = window
    if wh < 1 or ww < 1:
        raise ValueError(f"bad window {window}")
    if border is not None and len(border) != 4:
        raise ValueError(f"border must be (y0, y1, x0, x1), got {border}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")


def _gather_db_cuda(slab, y0s, x0s, wh, ww, border, scaled, out_dtype):
    Hs, Wp, Cf = slab.shape
    N = y0s.shape[0]
    if N > 65535 or slab.numel() >= 2 ** 31:
        raise ValueError(f"gather_db takes at most 65535 patches and "
                         f"2**31 slab elements, got {N} / {slab.numel()}")
    out = torch.empty((N, wh, ww, Cf), dtype=out_dtype, device=slab.device)
    by0, by1, bx0, bx1 = border if border is not None else (0, 0, 0, 0)
    err = cuda_lib.lib().crimac_gather_db(
        slab.data_ptr(), cuda_lib.DTYPE_CODES[slab.dtype], Hs, Wp, Cf,
        y0s.data_ptr(), x0s.data_ptr(), N, wh, ww, int(border is not None),
        by0, by1, bx0, bx1, int(scaled), out.data_ptr(),
        cuda_lib.DTYPE_CODES[out_dtype], cuda_lib.stream_of(slab))
    cuda_lib.check(err, "gather_db")
    cuda_lib.launches["gather_db"] += 1
    return out


def _gather_db_cpu(slab, y0s, x0s, wh, ww, border, scaled, out_dtype):
    return gather_db_reference(slab, y0s, x0s, (wh, ww), border, scaled,
                               out_dtype)


def _gather_db_fake(slab, y0s, x0s, wh, ww, border, scaled, out_dtype):
    return slab.new_empty((y0s.shape[0], wh, ww, slab.shape[2]),
                          dtype=out_dtype)


_OP = cuda_lib.define_op(
    "gather_db(Tensor slab, Tensor y0s, Tensor x0s, SymInt wh, SymInt ww, "
    "int[]? border, bool scaled, ScalarType out_dtype) -> Tensor",
    _gather_db_cuda, _gather_db_cpu, _gather_db_fake)


def gather_db(slab: torch.Tensor, y0s: torch.Tensor, x0s: torch.Tensor,
              window, border=None, scaled: bool = False,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(Hs, Wp, Cf) HWC slab + (N,) int32 patch starts -> (N, wh, ww, Cf)
    dB patches in ``out_dtype`` (``crimac::gather_db``).

    ``slab`` is float32/bfloat16 raw sv or uint8 dB codes.  Pixels outside
    the slab (rows at or beyond Hs: the zero pad the host did not ship)
    read as raw zeros.  ``border`` = (y0, y1, x0, x1), the data rectangle
    in slab coordinates: pixels outside it come out 0.0.  CPU tensors take
    the plain version; CUDA tensors the kernel."""
    _check(slab, y0s, x0s, window, border, out_dtype)
    cuda_lib.require_device(slab, y0s, x0s)
    wh, ww = window
    return _OP(slab, y0s, x0s, wh, ww,
               None if border is None else [int(v) for v in border],
               bool(scaled), out_dtype)


def gather_db_reference(slab, y0s, x0s, window, border=None, scaled=False,
                        out_dtype=torch.float32):
    """Plain PyTorch version of :func:`gather_db` (same contract)."""
    wh, ww = window
    Hs, Wp, _ = slab.shape
    dev = slab.device
    rows = y0s.long()[:, None] + torch.arange(wh, device=dev)    # (N, wh)
    cols = x0s.long()[:, None] + torch.arange(ww, device=dev)    # (N, ww)
    inside = (((rows >= 0) & (rows < Hs))[:, :, None]
              & ((cols >= 0) & (cols < Wp))[:, None, :])
    patches = slab[rows.clamp(0, Hs - 1)[:, :, None],
                   cols.clamp(0, Wp - 1)[:, None, :]]       # (N, wh, ww, Cf)
    patches = torch.where(inside[..., None], patches,
                          torch.zeros((), dtype=slab.dtype, device=dev))
    d = net_db_input(patches, scaled)
    if border is not None:
        by0, by1, bx0, bx1 = (int(v) for v in border)
        outside = (((rows < by0) | (rows >= by1))[:, :, None]
                   | ((cols < bx0) | (cols >= bx1))[:, None, :])
        d = torch.where(outside[..., None], 0.0, d)
    return d.to(out_dtype)
