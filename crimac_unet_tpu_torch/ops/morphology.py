"""Binary morphology with the 7x7 disc, as torch convolution counts.

The reference closes the in-threshold mask with
``scipy.ndimage.binary_closing`` and a 7x7 disc inside the
label-refinement transform (refine_label_boundary.py:50-62, :96).  Here,
as in the JAX package's ``crimac_unet_tpu/ops/morphology.py``, dilation is
``count > 0`` and erosion ``count == sum(structure)`` of a zero-padded
``F.conv2d`` of the 0/1 mask: scipy's ``border_value=0`` for both
operators.  The counts are small integers, exact in float32 (and in TF32,
whose 10-bit mantissa holds 0 and 1 exactly) in any summation order.

All functions are batched over a leading axis.  :func:`binary_closing`
with a clip mask is the plain version of the closing kernel
(ops/closing.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 7x7 disc structuring element (refine_label_boundary.py:50-58)
DISC_7X7 = np.array([
    [0, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1, 1],
    [0, 1, 1, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 0, 0],
], dtype=np.float32)


def _structure_count(mask: torch.Tensor, structure: np.ndarray
                     ) -> torch.Tensor:
    """(B, H, W) 0/1 mask -> (B, H, W) float32 counts of set neighbours
    under the (symmetric) structuring element, zero-padded."""
    kh, kw = structure.shape
    kernel = torch.as_tensor(structure, dtype=torch.float32,
                             device=mask.device)[None, None]
    out = F.conv2d(mask[:, None].to(torch.float32), kernel,
                   padding=(kh // 2, kw // 2))
    return out[:, 0]


def binary_dilation(mask: torch.Tensor, structure=DISC_7X7) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with border_value=0 (batched)."""
    return _structure_count(mask, structure) > 0.5


def binary_erosion(mask: torch.Tensor, structure=DISC_7X7) -> torch.Tensor:
    """scipy.ndimage.binary_erosion with border_value=0 (batched)."""
    total = float(np.sum(structure))
    return _structure_count(mask, structure) > total - 0.5


def binary_closing(mask: torch.Tensor, structure=DISC_7X7,
                   clip_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Dilation then erosion.  ``clip_mask`` (if given) zeroes the dilated
    mask outside a region before eroding — scipy's closing of a *cropped*
    array (the reference closes within each patch's non-boundary bbox,
    refine_label_boundary.py:85-96, so beyond-crop pixels erode as
    zeros)."""
    dil = binary_dilation(mask, structure)
    if clip_mask is not None:
        dil = dil & clip_mask
    return binary_erosion(dil, structure)
