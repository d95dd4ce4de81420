"""P1-P3: the pool probe's three layouts of the 2x2 stride-2 max pool.

``scripts/pallas_pool_probe.py`` asks whether a hand-written kernel
closes the level-0 pool's gap to its byte bound, in three layouts of the
same (B, H, W, C) bfloat16 pool: ``pool_pallas_nhwc`` (a row block
staged in fast memory), ``pool_pallas_lane128`` (the flat (B, H, W*C)
view, C = 64, each 128-element group one W-pair) and
``pool_pallas_packed`` (the flat view as (..., W/2, 2, C)).  Their
counterparts are the CUDA kernels of ``csrc/pool_probe.cu``; each
wrapper launches its kernel on a CUDA tensor and takes the plain PyTorch
version, written in the variant's own view, on a CPU tensor.  NaN
propagates as in ``F.max_pool2d`` and K2 (``ops/pool.py``).

A port-only module, as ``ops/gather_db_study.py`` is: the package's
forward runs K2 / K3; ``scripts/torch_pool_probe.py`` times these three
beside them.
"""

from __future__ import annotations

import torch

from . import cuda_lib

_SMEM_BYTES = 232448          # a block's shared memory on sm_90 (P1's tile)


def _check(x: torch.Tensor, name: str) -> str:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (B, H, W, C) tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bfloat16, got {x.dtype}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name} needs even H and W, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (B, H, W, C) tensor")
    kind = cuda_lib.require_device(x)
    if kind == "cuda" and x.numel() >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2**31 elements")
    return kind


def _aligned(x: torch.Tensor, out: torch.Tensor, nbytes: int,
             name: str) -> None:
    if x.data_ptr() % nbytes or out.data_ptr() % nbytes:
        raise ValueError(f"{name} needs {nbytes}-byte aligned tensors")


def _pooled_like(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.new_empty((B, H // 2, W // 2, C))


# ------------------------------------------------------------ plain versions
def pool_nhwc_reference(x: torch.Tensor) -> torch.Tensor:
    """P1's plain version: (B, H/2, 2, W/2, 2, C), the max over both 2s
    (``_pool_kernel_nhwc``'s reshape + max)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def pool_lane128_reference(x: torch.Tensor) -> torch.Tensor:
    """P2's plain version: the flat (B, H, W*C) view as (..., W/2, 128),
    the max of each group's two 64-element halves, then of each row pair
    (``_pool_kernel_lane128``)."""
    B, H, W, C = x.shape
    y = x.reshape(B, H, W // 2, 128)
    wmax = torch.maximum(y[..., :64], y[..., 64:])
    return wmax.reshape(B, H // 2, 2, W // 2 * 64).amax(dim=2) \
        .reshape(B, H // 2, W // 2, C)


def pool_packed_reference(x: torch.Tensor) -> torch.Tensor:
    """P3's plain version: the flat view as (B, H, W/2, 2, C), the max over
    the pair, then over each row pair (``_pool_kernel_packed``)."""
    B, H, W, C = x.shape
    y = x.reshape(B, H, W // 2, 2, C).amax(dim=3)
    return y.reshape(B, H // 2, 2, W // 2, C).amax(dim=2)


# ------------------------------------------------------------------ kernels
def pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """P1: (B, H, W, C) -> (B, H/2, W/2, C), two input rows a block staged
    through shared memory (C a multiple of 8, 4 W C bytes within a block's
    shared memory)."""
    if _check(x, "pool_nhwc") == "cpu":
        return pool_nhwc_reference(x)
    B, H, W, C = x.shape
    if C % 8 or 4 * W * C > _SMEM_BYTES:
        raise ValueError(f"pool_nhwc needs C % 8 == 0 and two rows within "
                         f"{_SMEM_BYTES} bytes of shared memory, got W {W}, "
                         f"C {C}")
    out = _pooled_like(x)
    _aligned(x, out, 16, "pool_nhwc")
    err = cuda_lib.lib().crimac_pool_probe_nhwc(
        x.data_ptr(), out.data_ptr(), B, H, W, C, cuda_lib.stream_of(x))
    cuda_lib.check(err, "pool_probe_nhwc")
    cuda_lib.launches["pool_probe_nhwc"] += 1
    return out


def pool_lane128(x: torch.Tensor) -> torch.Tensor:
    """P2: the same pool with each 128-element W-pair group one warp and
    the half-group max one shuffle (C = 64, as the Pallas function
    asserts)."""
    kind = _check(x, "pool_lane128")
    if x.shape[3] != 64:
        raise ValueError(f"pool_lane128 takes C = 64, got {x.shape[3]}")
    if kind == "cpu":
        return pool_lane128_reference(x)
    B, H, W, _ = x.shape
    out = _pooled_like(x)
    _aligned(x, out, 8, "pool_lane128")
    err = cuda_lib.lib().crimac_pool_probe_lane128(
        x.data_ptr(), out.data_ptr(), B, H, W, cuda_lib.stream_of(x))
    cuda_lib.check(err, "pool_probe_lane128")
    cuda_lib.launches["pool_probe_lane128"] += 1
    return out


def pool_packed(x: torch.Tensor) -> torch.Tensor:
    """P3: the same pool, one thread an output bfloat16x2 word (C even)."""
    kind = _check(x, "pool_packed")
    if x.shape[3] % 2:
        raise ValueError(f"pool_packed takes an even C, got {x.shape[3]}")
    if kind == "cpu":
        return pool_packed_reference(x)
    B, H, W, C = x.shape
    out = _pooled_like(x)
    _aligned(x, out, 4, "pool_packed")
    err = cuda_lib.lib().crimac_pool_probe_packed(
        x.data_ptr(), out.data_ptr(), B, H, W, C, cuda_lib.stream_of(x))
    cuda_lib.check(err, "pool_probe_packed")
    cuda_lib.launches["pool_probe_packed"] += 1
    return out


# name -> (kernel, plain version, the Pallas function it replaces)
VARIANTS = {
    "pool_probe_nhwc": (pool_nhwc, pool_nhwc_reference,
                        "scripts/pallas_pool_probe.py:67"),
    "pool_probe_lane128": (pool_lane128, pool_lane128_reference,
                           "scripts/pallas_pool_probe.py:97"),
    "pool_probe_packed": (pool_packed, pool_packed_reference,
                          "scripts/pallas_pool_probe.py:126"),
}
