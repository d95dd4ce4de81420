"""Does an int8 path reach the H100's int8 tensor cores at the U-Net's
shapes?  The port's counterpart of ``scripts/int8_probe.py``.

At the four shapes that carry most of the forward's FLOPs, (32, 256,
256, 64 -> 64) ... (32, 32, 32, 512 -> 512), it times

* the bfloat16 3x3 SAME conv with float32 accumulation (channels_last
  ``F.conv2d``, the port's production), and
* the same conv on int8 inputs (x * 16 and w * 16, clipped to +-127)
  accumulated in int32.  torch's cuDNN binding has no int8 convolution,
  so this is im2col (the nine shifted taps of the zero-padded NHWC input
  concatenated along channels, (B H W, 9 C_in) int8) and ONE int8 GEMM
  through ``torch._int_mm`` (cuBLASLt) with the (9 C_in, C_out) weight;
  the im2col's copy is inside the time, and im2col and the GEMM are
  also timed alone.

Each with ``utils/timing.py`` ``burst_time`` (as the JAX probe), its
TF/s or TOP/s against the card's dense peaks (bf16 989.4 TFLOP/s,
``utils/flops.py``; int8 1978.9 TOP/s, :data:`PEAK_INT8_OPS`), and the
speedup.  The int8 conv is exact integer arithmetic: :func:`check_exact`
holds it to an int64 reference on a slice.

    python scripts/torch_int8_probe.py
    python scripts/torch_int8_probe.py --device cpu --batch 2 --size 32

Prints a table and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402

# NVIDIA H100 SXM5 80 GB, dense int8 tensor-core rate (NVIDIA's H100
# datasheet: 3957.8 TOPS with sparsity, half of it dense)
PEAK_INT8_OPS = 1978.9e12

# (H, W, Cin, Cout) of the JAX probe at size 256, batch 32
SHAPES = [(256, 256, 64, 64), (128, 128, 128, 128), (64, 64, 256, 256),
          (32, 32, 512, 512)]


def quantize(a: torch.Tensor) -> torch.Tensor:
    """The JAX probe's int8 inputs: clip(a * 16, -127, 127) cast to int8
    (truncation toward zero, as numpy's astype)."""
    return (a * 16).clamp(-127, 127).to(torch.int8)


def im2col(x_nhwc, kh=3, kw=3):
    """(B, H, W, C) -> (B H W, kh kw C): the taps of the zero-padded
    input, tap (dy, dx) at channel block dy * kw + dx."""
    B, H, W, C = x_nhwc.shape
    xp = F.pad(x_nhwc, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    taps = [xp[:, dy:dy + H, dx:dx + W, :] for dy in range(kh)
            for dx in range(kw)]
    return torch.cat(taps, dim=-1).reshape(B * H * W, kh * kw * C)


def int8_weight(w_hwio):
    """(kh, kw, C_in, C_out) int8 -> the (kh kw C_in, C_out) GEMM operand
    as the transposed view of a contiguous (C_out, kh kw C_in) tensor
    (column-major, cuBLASLt's int8 layout)."""
    kh, kw, ci, co = w_hwio.shape
    return w_hwio.reshape(kh * kw * ci, co).t().contiguous().t()


def conv_int8(x_nhwc, wm):
    """The int8 3x3 SAME conv with int32 sums: (B, H, W, C_out) int32."""
    B, H, W, _ = x_nhwc.shape
    return torch._int_mm(im2col(x_nhwc), wm).reshape(B, H, W, wm.shape[1])


def conv_bf16(x, w):
    """Production: bfloat16 channels_last ``F.conv2d`` (float32 sums)."""
    return F.conv2d(x, w, None, padding=1)


def check_exact(xi_nhwc, wi_hwio, got, n=1) -> bool:
    """The int8 conv of the first ``n`` samples equal to an int64
    reference: a float64 convolution, exact here (every product and
    partial sum is an integer below 2**53), cast to int64."""
    x = xi_nhwc[:n].permute(0, 3, 1, 2).double()
    w = wi_hwio.permute(3, 2, 0, 1).double()
    want = F.conv2d(x, w, None, padding=1).permute(0, 2, 3, 1)
    return bool(torch.equal(got[:n].long(), want.round().long()))


def run(device="cuda", batch=32, size=256, burst=20, log=print) -> dict:
    from crimac_unet_tpu_torch.utils.timing import burst_time
    dev = common.device_of(device)
    card = common.card_name(dev)
    peak = tc.peak_flops(dev)
    log(f"device: {card}; peaks bf16 {peak / 1e12:.1f} TFLOP/s, int8 "
        f"{PEAK_INT8_OPS / 1e12:.1f} TOP/s (dense)")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for H, W, Ci, Co in SHAPES:
        H, W = H * size // 256, W * size // 256
        x = torch.randn((batch, H, W, Ci), generator=gen, device=dev)
        w = torch.randn((3, 3, Ci, Co), generator=gen, device=dev)
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xi, wi = quantize(x), quantize(w)
        del x, w
        wm = int8_weight(wi)
        exact = check_exact(xi, wi, conv_int8(xi[:1], wm))
        t_bf = burst_time(conv_bf16, xb, wb, reps=2, burst=burst)
        t_i8 = burst_time(conv_int8, xi, wm, reps=2, burst=burst)
        cols = im2col(xi)
        t_col = burst_time(im2col, xi, reps=2, burst=burst)
        t_mm = burst_time(torch._int_mm, cols, wm, reps=2, burst=burst)
        del cols
        ops = 2 * batch * H * W * Ci * Co * 9
        rows.append(dict(batch=batch, H=H, W=W, cin=Ci, cout=Co,
                         bf16_ms=t_bf * 1e3, int8_ms=t_i8 * 1e3,
                         bf16_tflops=ops / t_bf / 1e12,
                         int8_tops=ops / t_i8 / 1e12,
                         bf16_peak_share=ops / t_bf / peak,
                         int8_peak_share=ops / t_i8 / PEAK_INT8_OPS,
                         speedup=t_bf / t_i8, int8_exact=exact,
                         im2col_ms=t_col * 1e3, int_mm_ms=t_mm * 1e3,
                         int_mm_tops=ops / t_mm / 1e12))
        r = rows[-1]
        log(f"B{batch} {H}x{W} {Ci}->{Co}: bf16 {r['bf16_ms']:8.3f} ms "
            f"({r['bf16_tflops']:6.1f} TF/s, {r['bf16_peak_share']:5.1%})   "
            f"int8 {r['int8_ms']:8.3f} ms ({r['int8_tops']:6.1f} TOP/s, "
            f"{r['int8_peak_share']:5.1%})   speedup {r['speedup']:4.2f}x; "
            f"int8 exact {exact}; of it im2col {r['im2col_ms']:.3f} ms, "
            f"_int_mm alone {r['int_mm_ms']:.3f} ms ({r['int_mm_tops']:.1f} "
            f"TOP/s)")
        del xb, wb, xi, wi, wm
    bad = [(r["H"], r["cin"]) for r in rows if not r["int8_exact"]]
    if bad:
        raise RuntimeError(f"int8 conv differs from its int64 reference at "
                           f"{bad}")
    return {"device": card, "batch": batch, "size": size,
            "peak_bf16": peak, "peak_int8": PEAK_INT8_OPS,
            "form": "im2col + one torch._int_mm", "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.size), args.out)


if __name__ == "__main__":
    main()
