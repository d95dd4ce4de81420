"""FLOP accounting and MFU (model FLOPs utilization) of the port.

The port's counterpart of ``crimac_unet_tpu/utils/flops.py``: analytic
model FLOPs per forward / train step, a count of the FLOPs PyTorch's
operators report for a call (``torch.utils.flop_counter``), and MFU, the
analytic FLOPs over measured device time and the card's peak.

Two FLOP sources, cross-checked in tests/test_torch_measure.py:
  * :func:`unet_forward_flops` — closed-form conv FLOPs of the flagship
    U-Net (the reference topology: depth levels of two 3x3 convs, 2x2
    transpose-conv upsampling, skip concats, 1x1 head);
  * :func:`counted_flops` — ``FlopCounterMode``'s count of the operators
    the call runs (convolutions and matrix products).
"""

from __future__ import annotations

# Peak dense bf16 tensor-core throughput per card, FLOP/s, keyed by a
# substring of torch.cuda.get_device_name.  NVIDIA H100 SXM5 (80 GB
# HBM3): 989.4 TFLOP/s bf16 dense, NVIDIA's H100 datasheet.  Other cards
# and the CPU have no entry (None: report FLOP/s without an MFU).
_PEAK_FLOPS = [
    ("H100 80GB HBM3", 989.4e12),
]


def device_peak_flops(device=None) -> float | None:
    """Peak bf16 FLOP/s of ``device`` (default: the current CUDA device),
    or None for the CPU and for cards without an entry."""
    import torch

    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else
        torch.device("cpu"))
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_FLOPS:
        if key in name:
            return peak
    return None


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


def unet_train_step_flops(height: int, width: int, **kw) -> int:
    """Forward + backward FLOPs per example: backward of a conv stack costs
    ~2x the forward (grad wrt activations + grad wrt weights)."""
    return 3 * unet_forward_flops(height, width, **kw)


def counted_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call ``fn(*args, **kwargs)`` as PyTorch's flop counter
    counts its operators (convolutions, matrix products; elementwise work
    counts 0).  The call runs once, on the arguments' device."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def mfu(total_flops: float, seconds: float, device=None) -> float | None:
    """total_flops / seconds as a fraction of the card's peak (None where
    the peak is unknown)."""
    peak = device_peak_flops(device)
    if peak is None or seconds <= 0:
        return None
    return total_flops / seconds / peak


def format_rate(flops: float, seconds: float) -> str:
    return f"{flops / max(seconds, 1e-12) / 1e12:.2f} TFLOP/s"
