"""Train-time data augmentation as batched device ops.

Distributionally identical to the reference's per-worker numpy
augmentation (crimac_unet/batch/data_augmentation/add_noise.py:19-34,
flip_x_axis.py:19-24) and to the JAX package's
``crimac_unet_tpu/ops/augment.py``; the bit streams differ from both by
design, as the RNGs differ.  Each op is split into its draw (masks and
factors from an explicit ``torch.Generator`` on the data's device) and its
apply step, so tests can inject the JAX package's draws into the apply
step.

Layout: data (B, C, H, W) raw sv, labels (B, H, W).
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


def _flip_where(flip, arr):
    mask = flip.reshape(flip.shape + (1,) * (arr.ndim - 1))
    return torch.where(mask, arr.flip(-1), arr)


def flip_x_axis(data, labels, flip):
    """Flip the ping (x) axis of data and labels where ``flip``."""
    return _flip_where(flip, data), _flip_where(flip, labels)


def augment_train(gen: torch.Generator, data, labels):
    """Train augmentation chain [add_noise, flip_x_axis]
    (reference transforms.py:39-45)."""
    data = add_noise(data, *draw_noise(gen, data.shape, data.device))
    return flip_x_axis(data, labels,
                       draw_flip(gen, data.shape[0], data.device))
