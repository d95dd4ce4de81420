"""dB transforms of raw sv as torch tensor functions, and the train and
test data chains of the train and eval steps.

Same constants and float32 arithmetic as the reference's numpy transforms
(crimac_unet/batch/data_transforms/db_with_limits.py:20-39).  NaN (from the
log of a negative sv) propagates through the clips, as ``jnp.clip`` and
``torch.clamp`` both propagate it.
"""

from __future__ import annotations

import torch

from ..constants import LABEL_BOUNDARY_VAL, LABEL_IGNORE_VAL

DB_EPS = 1e-10
DB_LOW = -75.0
DB_HIGH = 0.0


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with IEEE division.  The divisor is a tensor on x's device:
    torch computes ``cuda_tensor / python_scalar`` as a multiply by the
    rounded reciprocal, one ulp away from the division the kernels (and
    the JAX package) do."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def remove_nan_inf(data, labels, new_value=0.0):
    """Non-finite data -> ``new_value``; labels where *channel 0* is
    non-finite -> IGNORE (reference remove_nan_inf.py:22-33).  Layout:
    data (B, C, H, W), labels (B, H, W)."""
    labels = torch.where(torch.isfinite(data[:, 0]), labels,
                         LABEL_IGNORE_VAL)
    data = torch.where(torch.isfinite(data), data, new_value)
    return data, labels


def db(data: torch.Tensor, eps: float = DB_EPS) -> torch.Tensor:
    """Decibel transform 10*log10(x + eps)
    (reference db_with_limits.py:37-39)."""
    return 10.0 * torch.log10(data + eps)


def db_with_limits(data, limit_low=DB_LOW, limit_high=DB_HIGH):
    """dB transform clipped to [low, high]
    (reference db_with_limits.py:20-24)."""
    return torch.clamp(db(data), limit_low, limit_high)


def db_with_limits_scaled(data, limit_low=DB_LOW, limit_high=DB_HIGH):
    """dB transform scaled to [0, 1] — used for metadata-channel runs
    (reference db_with_limits.py:28-35)."""
    d = torch.clamp(db(data), max=0.0)
    d = torch.clamp(d, limit_low, limit_high)
    return 1.0 + _div(d, abs(limit_low))


def set_data_border_value(data, labels, border_value=0.0,
                          channels_last=False):
    """Zero data (in dB space, after db_with_limits) where labels mark the
    data boundary; test time only (reference set_data_border_value.py:19-23,
    transforms.py:57-64).  ``channels_last`` broadcasts over NHWC patch
    batches."""
    border = labels == LABEL_BOUNDARY_VAL
    border = border[:, :, :, None] if channels_last \
        else border[:, None, :, :]
    return torch.where(border, border_value, data)


def data_transform_train(data, labels, scaled=False):
    """Train-time data chain [remove_nan_inf, db_with_limits]
    (reference transforms.py:48-54)."""
    data, labels = remove_nan_inf(data, labels)
    data = db_with_limits_scaled(data) if scaled else db_with_limits(data)
    return data, labels


def data_transform_test(data, labels, scaled=False):
    """Test-time data chain adds border zeroing
    (reference transforms.py:57-64)."""
    data, labels = data_transform_train(data, labels, scaled)
    return set_data_border_value(data, labels), labels


# transfer_dtype='uint8': dB codes per the [-75, 0] clip range.  code =
# round((dB + 75) * 255/75); dequant = code * 75/255 - 75
# (pipeline/infer_common.py _quantize_db_u8 is the host half).
DB_U8_SCALE = 255.0 / 75.0


def net_db_input(x: torch.Tensor, scaled: bool) -> torch.Tensor:
    """Network-input transform of gathered patches, float32 out: uint8
    arrays hold host-computed dB codes (dequantize only; the scaled meta
    variant reduces to code/255), anything else holds raw sv (scrub
    non-finite to 0, then db_with_limits[_scaled]).  The plain version of
    the gather_db kernel's arithmetic."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32)
        return _div(x, 255.0) if scaled else _div(x, DB_U8_SCALE) - 75.0
    x = x.to(torch.float32)
    x = torch.where(torch.isfinite(x), x, 0.0)
    return db_with_limits_scaled(x) if scaled else db_with_limits(x)
