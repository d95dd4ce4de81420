"""FLOP and byte counts from shapes, and the card's published peaks.

``conv2d_flops`` and ``unet_forward_flops`` are frozen copies of
``crimac_unet_tpu_torch/utils/flops.py`` at commit d20381e (conv FLOPs
only, multiply-adds counted twice; BN, ReLU and pools are under 1 %).
The kernels' bytes count each input byte read once and each output byte
written once, from the shapes of the call.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 80 GB datasheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES = 3.35e12


def conv2d_flops(h: int, w: int, k: int, cin: int, cout: int) -> int:
    """Multiply-add-counted (x2) FLOPs of a same-padded k x k conv producing
    an (h, w, cout) map."""
    return 2 * h * w * k * k * cin * cout


def unet_forward_flops(height: int, width: int, in_channels: int = 4,
                       n_classes: int = 3, depth: int = 5,
                       start_filts: int = 64) -> int:
    """Per-example forward FLOPs of the reference U-Net topology
    (models/unet.py:263-284: two 3x3 convs per level, maxpool between
    levels, 2x2 stride-2 transpose-conv up, concat skip, 1x1 head).
    Conv FLOPs only — BN/ReLU/pool are bandwidth-bound and <1 %."""
    total = 0
    h, w = height, width
    cin = in_channels
    for i in range(depth):
        cout = start_filts * 2 ** i
        total += conv2d_flops(h, w, 3, cin, cout)
        total += conv2d_flops(h, w, 3, cout, cout)
        cin = cout
        if i < depth - 1:
            h, w = h // 2, w // 2
    for j in range(depth - 1):
        cu = cin                  # channels entering the up block
        cout = cu // 2
        # transpose conv 2x2 stride 2: every input pixel hits 4 outputs
        total += 2 * h * w * 4 * cu * cout
        h, w = 2 * h, 2 * w
        # conv1 on [upsampled ++ skip] = 2*cout channels in
        total += conv2d_flops(h, w, 3, 2 * cout, cout)
        total += conv2d_flops(h, w, 3, cout, cout)
        cin = cout
    total += conv2d_flops(h, w, 1, cin, n_classes)
    return int(total)


def train_step_flops(batch, height, width, **model) -> int:
    """A training step: forward, and the backward's two products (input
    and weight gradients), each as many FLOPs as the forward."""
    return 3 * batch * unet_forward_flops(height, width, **model)


def k1_bytes(slab_rows, slab_cols, channels, slab_itemsize, n_out,
             out_h, out_w, out_itemsize=2) -> int:
    """K1 (gather + dB): the slab rows it reads, once, and its NHWC
    output."""
    return (slab_rows * slab_cols * channels * slab_itemsize
            + n_out * out_h * out_w * channels * out_itemsize)


def k3_bytes(n, h, w, c, itemsize=2) -> int:
    """K3 (relu + 2x2 pool + skip): its input once, the skip and the
    pooled map written."""
    return n * h * w * c * itemsize * 2 + n * (h // 2) * (w // 2) * c \
        * itemsize


def k4_bytes(n, h, w) -> int:
    """K4 (binary closing): the bool mask and clip mask read, the closed
    mask written."""
    return 3 * n * h * w


def power_limit_watts():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
