"""Multi-head attention of the SegFormer encoder (models/segformer.py).

``attention(q, k, v)`` is ``softmax(q k^T / sqrt(d)) v`` over (B, heads,
N, d) queries and (B, heads, M, d) keys and values, with no mask and no
dropout, as every stage of MiT computes it.  All four stages' attention
goes through this one function, so a device trace names its kernels:

* CUDA in bfloat16 or float16 runs PyTorch's scaled-dot-product
  attention held to its flash backend (kernels ``flash_fwd_*`` and
  ``flash_bwd_*``): scores and softmax in float32 on chip, never written
  to device memory, the backward recomputing them.  Held to one backend so
  that a library update cannot move the traced kernels to another one
  silently; a shape the flash backend refuses raises.
* Anything else (the CPU, a float32 program) takes the math backend, the
  plain law.

:class:`PairCounter` counts the query-key pairs each call scores
(B * heads * N * M), host integers from the shapes: a training step's
count over ``12 * d`` is its attention FLOPs (the forward's two products
and the backward's four).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FLASH_DTYPES = (torch.bfloat16, torch.float16)


class PairCounter:
    """The query-key pairs scored since the counter was last taken."""

    def __init__(self):
        self.pairs = 0

    def take(self) -> int:
        n, self.pairs = self.pairs, 0
        return n


def _backend(q: torch.Tensor):
    """The ``SDPBackend`` a call on ``q`` is held to."""
    from torch.nn.attention import SDPBackend
    if q.is_cuda and q.dtype in _FLASH_DTYPES:
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.MATH


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              counter: PairCounter | None = None) -> torch.Tensor:
    """(B, h, N, d) queries, (B, h, M, d) keys and values -> (B, h, N, d)
    in ``q``'s dtype."""
    from torch.nn.attention import sdpa_kernel
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"attention takes (B, h, N, d) queries and (B, h, "
                         f"M, d) keys and values, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if counter is not None:
        B, h, N, _ = q.shape
        counter.pairs += B * h * N * k.shape[2]
    with sdpa_kernel(_backend(q)):
        return F.scaled_dot_product_attention(q, k, v)
