"""K4: the 7x7-disc binary closing of the eval label chain.

``binary_closing(mask, clip_mask)`` closes each (H, W) mask of a batch
with the disc of ops/morphology.py, zeroing the dilation outside
``clip_mask`` before the erosion (the reference's crop-then-close,
refine_label_boundary.py:85-96).  Kernel: ``csrc/closing.cu`` (replaces
``crimac_unet_tpu/ops/pallas_morphology.py`` ``binary_closing_pallas``).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .morphology import DISC_7X7
from .morphology import binary_closing as _closing_plain


def _check(mask: torch.Tensor, clip_mask: torch.Tensor) -> None:
    for name, t in (("mask", mask), ("clip_mask", clip_mask)):
        if t.dtype != torch.bool:
            raise ValueError(f"binary_closing takes torch.bool tensors, "
                             f"{name} is {t.dtype}")
        if t.dim() != 3 or t.numel() == 0:
            raise ValueError(f"binary_closing takes non-empty (B, H, W) "
                             f"tensors, {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"binary_closing needs contiguous tensors "
                             f"({name} is not)")
    if mask.shape != clip_mask.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and clip_mask "
                         f"{tuple(clip_mask.shape)} differ in shape")
    if mask.shape[0] > 65535:
        raise ValueError("binary_closing takes at most 65535 masks a call")


def binary_closing(mask: torch.Tensor, clip_mask: torch.Tensor
                   ) -> torch.Tensor:
    """(B, H, W) bool mask and clip mask -> closed (B, H, W) bool."""
    _check(mask, clip_mask)
    if cuda_lib.require_device(mask, clip_mask) == "cpu":
        return binary_closing_reference(mask, clip_mask)
    B, H, W = mask.shape
    out = torch.empty_like(mask)
    err = cuda_lib.lib().crimac_binary_closing(
        mask.data_ptr(), clip_mask.data_ptr(), out.data_ptr(), B, H, W,
        cuda_lib.stream_of(mask))
    cuda_lib.check(err, "binary_closing")
    cuda_lib.launches["binary_closing"] += 1
    return out


def binary_closing_reference(mask: torch.Tensor, clip_mask: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of :func:`binary_closing`: the convolution counts of
    ops/morphology.py."""
    return _closing_plain(mask, DISC_7X7, clip_mask=clip_mask)
