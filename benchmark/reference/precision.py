"""The precision every reference computes in: float32 with TF32 off."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
