"""Train-time data augmentation as batched device ops.

Distributionally identical to the reference's per-worker numpy
augmentation (crimac_unet/batch/data_augmentation/add_noise.py:19-34,
flip_x_axis.py:19-24) and to the JAX package's
``crimac_unet_tpu/ops/augment.py``; the bit streams differ from both by
design, as the RNGs differ.  Each op is split into its draw (masks and
factors from an explicit ``torch.Generator`` on the data's device) and its
apply step, so tests can inject the JAX package's draws into the apply
step.

Layout: data (B, C, H, W) raw sv, meta (B, M, H, W), labels (B, H, W).

``shard=(rank, n)``: the batch is rank ``rank``'s rows of an ``n``-rank
data mesh's global batch (parallel/mesh.py).  The draws are then made for
the global batch, from the generator every rank seeds alike, and this
rank's rows of them applied, so ``n`` ranks augment as one device does.
"""

from __future__ import annotations

import torch


def draw_noise(gen: torch.Generator, shape, device) -> tuple:
    """add_noise's draws: per-sample apply (p = 0.5), per-pixel change
    (p = 0.05) and increase (p = 0.5), up ~ U[1, 10), down ~ U[0, 1)."""
    B = shape[0]

    def u(s):
        return torch.rand(s, generator=gen, device=device)

    return (u((B,)) < 0.5, u(shape) < 0.05, u(shape) < 0.5,
            1.0 + 9.0 * u(shape), u(shape))


def add_noise(data, apply, change, increase, up, down):
    """Where ``apply`` (per sample) and ``change`` (per pixel): multiply
    by ``up`` where ``increase``, else by ``down``."""
    factor = torch.where(change, torch.where(increase, up, down), 1.0)
    factor = torch.where(apply[:, None, None, None], factor, 1.0)
    return data * factor.to(data.dtype)


def draw_flip(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """flip_x_axis's per-sample draw (p = 0.5)."""
    return torch.rand((batch,), generator=gen, device=device) < 0.5


def _global_draws(gen, data, shard):
    """The noise and flip draws of the global batch, cut to this rank's
    rows (all of them without ``shard``)."""
    r, n = shard or (0, 1)
    b = data.shape[0]
    shape = (b * n,) + tuple(data.shape[1:])
    noise = [t[r * b:(r + 1) * b]
             for t in draw_noise(gen, shape, data.device)]
    return noise, draw_flip(gen, b * n, data.device)[r * b:(r + 1) * b]


def _flip_where(flip, arr):
    mask = flip.reshape(flip.shape + (1,) * (arr.ndim - 1))
    return torch.where(mask, arr.flip(-1), arr)


def flip_x_axis(data, labels, flip):
    """Flip the ping (x) axis of data and labels where ``flip``."""
    return _flip_where(flip, data), _flip_where(flip, labels)


def augment_train(gen: torch.Generator, data, labels, shard=None):
    """Train augmentation chain [add_noise, flip_x_axis]
    (reference transforms.py:39-45)."""
    noise, flip = _global_draws(gen, data, shard)
    return flip_x_axis(add_noise(data, *noise), labels, flip)


def augment_train_meta(gen: torch.Generator, data, meta, labels,
                       shard=None):
    """Metadata variant: noise on the acoustic channels only, one flip
    shared by data, meta and labels (reference add_noise.py:37-62,
    flip_x_axis.py:26-31)."""
    noise, flip = _global_draws(gen, data, shard)
    data = add_noise(data, *noise)
    return (_flip_where(flip, data), _flip_where(flip, meta),
            _flip_where(flip, labels))
