"""The 3x3 conv's weight gradient in two formulations on the card: the
port's counterpart of ``scripts/dldw_probe.py``.

Would nine tap GEMMs beat cuDNN's weight gradient at the 256x256
layers, where the training roofline (``scripts/torch_roofline_bwd.py``)
finds the backward furthest from its bound?  Per layer shape of the JAX
probe (down0.conv1, down0.conv2, up3.conv1, up3.conv2 and the
down1.conv2 control) at ``--batch`` (default 8), bfloat16:

* default: torch's weight gradient of the channels_last ``F.conv2d``,
  as the train step gets it: ``torch.autograd.grad`` of one recorded
  forward with respect to the weight only (the forward is recorded once,
  out of the timing);
* taps: nine shifted GEMMs ``dw[ky, kx] = x_pad[shift]^T g``, each
  (C_in, B H W) x (B H W, C_out) with a float32 result (``torch.mm``'s
  ``out_dtype``, the JAX probe's ``preferred_element_type``).

Reported as the JAX probe does: rel |d| (max |taps - default| / max
|default|) first, then ms (``torch_timing_common.device_ms``), TF/s and
the speedup.

    python scripts/torch_dldw_probe.py [--batch 8]
    python scripts/torch_dldw_probe.py --device cpu --batch 1 --size 32

Prints a table and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_l0_probe import mm_f32  # noqa: E402

# the JAX probe's offenders: (name, H, W, Cin, Cout) at size 256
SHAPES = [("down0.conv1", 256, 256, 4, 64),
          ("down0.conv2", 256, 256, 64, 64),
          ("up3.conv1", 256, 256, 128, 64),
          ("up3.conv2", 256, 256, 64, 64),
          ("down1.conv2 (ctrl)", 128, 128, 128, 128)]
REL_TOL = 2e-2          # taps against default, bfloat16 (see run)


def shapes(size=256):
    """SHAPES scaled to ``size`` (the control at half of it)."""
    return [(n, h * size // 256, w * size // 256, ci, co)
            for n, h, w, ci, co in SHAPES]


def recorded_conv(x, w):
    """One forward of the channels_last conv, recorded for the weight's
    gradient: (output, weight leaf)."""
    w = w.detach().requires_grad_(True)
    return F.conv2d(x, w, None, padding=w.shape[-1] // 2), w


def dw_default(y, w, g):
    """torch's weight gradient of the recorded conv ``y = conv(x, w)``:
    (C_out, C_in, kh, kw), in ``w``'s dtype."""
    return torch.autograd.grad(y, w, g, retain_graph=True)[0]


def dw_taps(x, g, kh=3, kw=3):
    """The weight gradient as kh x kw shifted GEMMs with float32 results:
    (kh, kw, C_in, C_out).  ``x`` (B, C_in, H, W), ``g`` (B, C_out, H, W),
    both channels_last."""
    B, Ci, H, W = x.shape
    Co = g.shape[1]
    xp = F.pad(x, (kw // 2,) * 2 + (kh // 2,) * 2).permute(0, 2, 3, 1)
    g2 = g.permute(0, 2, 3, 1).reshape(-1, Co)
    rows = []
    for ky in range(kh):
        rows.append(torch.stack([
            mm_f32(xp[:, ky:ky + H, kx:kx + W, :].reshape(-1, Ci).t(), g2)
            for kx in range(kw)]))
    return torch.stack(rows)


def draws(B, H, W, Ci, Co, rng):
    """The JAX probe's draws for one shape, float32 NHWC / HWIO."""
    x = (rng.randn(B, H, W, Ci) * .1).astype(np.float32)
    g = (rng.randn(B, H, W, Co) * .1).astype(np.float32)
    w = (rng.randn(3, 3, Ci, Co) * .05).astype(np.float32)
    return x, g, w


def run(device="cuda", batch=8, size=256, n=5, log=print) -> dict:
    """Each shape: the rel |d| of the taps against the default, then both
    timed.  bfloat16 operands; the default's gradient is bfloat16 (cuDNN
    rounds its float32 sum once), the taps' float32, so the two differ by
    the default's rounding: rel |d| <= REL_TOL (about 2.5 bfloat16 ulps of
    the largest entry)."""
    dev = common.device_of(device)
    card = common.card_name(dev)
    dtype = torch.bfloat16
    log(f"device: {card}; batch {batch}, bf16 operands")
    rng = np.random.RandomState(0)
    rows = []
    for name, H, W, Ci, Co in shapes(size):
        x, g, w = (torch.from_numpy(a).to(dev, dtype) for a in
                   draws(batch, H, W, Ci, Co, rng))
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        g = g.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y, wl = recorded_conv(x, w)
        want = dw_default(y, wl, g).float().permute(2, 3, 1, 0)
        got = dw_taps(x, g)
        rel = float((got - want).abs().max() / want.abs().max().clamp_min(1e-9))
        flops = 2 * batch * H * W * 9 * Ci * Co
        t0, _ = tc.device_ms(lambda i: dw_default(y, wl, g), dev, n=n)
        t1, _ = tc.device_ms(lambda i: dw_taps(x, g), dev, n=n)
        rows.append(dict(layer=name, H=H, W=W, cin=Ci, cout=Co, rel=rel,
                         rel_ok=rel <= REL_TOL, default_ms=t0, taps_ms=t1,
                         default_tflops=flops / (t0 * 1e-3) / 1e12,
                         taps_tflops=flops / (t1 * 1e-3) / 1e12,
                         speedup=t0 / max(t1, 1e-12), gflop=flops / 1e9))
        log(f"  {name:<18} rel|d| {rel:.2e}  default {t0:8.4f} ms "
            f"({rows[-1]['default_tflops']:6.1f} TF)  taps {t1:8.4f} ms "
            f"({rows[-1]['taps_tflops']:6.1f} TF)  speedup "
            f"{rows[-1]['speedup']:5.2f}x")
        del y, wl
    bad = [r["layer"] for r in rows if not r["rel_ok"]]
    if bad:
        raise RuntimeError(f"tap dW differs from the default beyond "
                           f"{REL_TOL}: {bad}")
    return {"device": card, "batch": batch, "size": size,
            "rel_tol": REL_TOL, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.size), args.out)


if __name__ == "__main__":
    main()
