"""K2/K3: the level-0 2x2 stride-2 max pool of the eval-mode U-Net.

``maxpool2x2`` pools a channels_last (B, H, W, C) activation; and
``relu_pool_skip`` takes the RAW level-0 conv output (BatchNorm folded
into the conv) and returns ``(pooled, skip)`` with ``skip = relu(x)`` and
``pooled = maxpool2x2(skip)``, reading x once.  NaN propagates as in
XLA's ``reduce_window(max)`` and torch's ``max_pool2d``.  Kernels:
``csrc/pool.cu`` (replace ``crimac_unet_tpu/ops/pallas_pool.py``
``maxpool2x2`` and ``relu_pool_skip``), registered as the operators
``crimac::maxpool2x2`` and ``crimac::relu_pool_skip`` (ops/cuda_lib.py
``define_op``): CUDA tensors launch the kernel, CPU tensors take the
plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (B, H, W, C) tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes {_DTYPES}, got {x.dtype}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name} needs even H and W, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (B, H, W, C) tensor "
                         "(a channels_last activation permuted to NHWC)")
    cuda_lib.require_device(x)


def _check_int32(x: torch.Tensor, name: str) -> None:
    """The kernels index with int32: checked on real tensors only (a
    symbolic batch of an exported graph has no such bound)."""
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2**31 elements")


def _vec(C: int, *tensors: torch.Tensor) -> int:
    """8 channels per thread (16-byte bfloat16 accesses) where C and the
    pointers allow it, else 1."""
    if C % 8:
        return 1
    align = 8 * tensors[0].element_size()
    return 8 if all(t.data_ptr() % align == 0 for t in tensors) else 1


def _pooled_like(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.new_empty((B, H // 2, W // 2, C))


def _maxpool2x2_cuda(x: torch.Tensor) -> torch.Tensor:
    _check_int32(x, "maxpool2x2")
    B, H, W, C = x.shape
    out = _pooled_like(x)
    err = cuda_lib.lib().crimac_maxpool2x2(
        x.data_ptr(), out.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], B, H, W,
        C, _vec(C, x, out), cuda_lib.stream_of(x))
    cuda_lib.check(err, "maxpool2x2")
    cuda_lib.launches["maxpool2x2"] += 1
    return out


def _relu_pool_skip_cuda(x: torch.Tensor):
    _check_int32(x, "relu_pool_skip")
    B, H, W, C = x.shape
    pooled = _pooled_like(x)
    skip = torch.empty_like(x)
    err = cuda_lib.lib().crimac_relu_pool_skip(
        x.data_ptr(), pooled.data_ptr(), skip.data_ptr(),
        cuda_lib.DTYPE_CODES[x.dtype], B, H, W, C, _vec(C, x, pooled, skip),
        cuda_lib.stream_of(x))
    cuda_lib.check(err, "relu_pool_skip")
    cuda_lib.launches["relu_pool_skip"] += 1
    return pooled, skip


def maxpool2x2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`maxpool2x2`: ``F.max_pool2d``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def relu_pool_skip_reference(x: torch.Tensor):
    """Plain version of :func:`relu_pool_skip`."""
    skip = torch.relu(x)
    return maxpool2x2_reference(skip), skip


# the fakes return contiguous NHWC tensors, as the kernels and the plain
# versions do, so a traced graph sees the strides that run
_MAXPOOL_OP = cuda_lib.define_op(
    "maxpool2x2(Tensor x) -> Tensor", _maxpool2x2_cuda, maxpool2x2_reference,
    _pooled_like)
_RELU_POOL_SKIP_OP = cuda_lib.define_op(
    "relu_pool_skip(Tensor x) -> (Tensor, Tensor)", _relu_pool_skip_cuda,
    relu_pool_skip_reference,
    lambda x: (_pooled_like(x), torch.empty_like(x)))


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C) 2x2 stride-2 VALID max
    (``crimac::maxpool2x2``)."""
    _check(x, "maxpool2x2")
    return _MAXPOOL_OP(x)


def relu_pool_skip(x: torch.Tensor):
    """Raw (B, H, W, C) conv output -> (pooled (B, H/2, W/2, C),
    skip = relu(x) (B, H, W, C)) (``crimac::relu_pool_skip``)."""
    _check(x, "relu_pool_skip")
    return _RELU_POOL_SKIP_OP(x)
