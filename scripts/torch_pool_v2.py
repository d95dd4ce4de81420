"""The level-0 pool kernel alone and inside the serving forward: the
port's counterpart of ``scripts/pallas_pool_v2.py``.

Stage 1: K2 ``maxpool2x2`` against ``F.max_pool2d`` alone at (B, 256,
256, 64) bfloat16, held bit for bit first (NaN and +-Inf seeded), each
timed against the pool's byte bound.

Stage 2: the BatchNorm-folded serving forward of the flagship U-Net
(depth 5, start_filts 64, bfloat16, (B, 256, 256, 4) dB input, seeded
weights) in two arms:

* ON: the level-0 pool through K3 ``relu_pool_skip``, the port's
  production path (``models/unet.py`` ``DownConv.forward``);
* OFF: relu, then ``F.max_pool2d`` at every level (:func:`forward_off`,
  which walks the model's ``down_convs`` / ``up_convs`` as
  ``UNet._forward`` does with ``pool_kernels=False``), the JAX package's
  "auto" path (``crimac_unet_tpu/ops/pallas_pool.py`` ``resolve_flag``).

Each arm is timed per forward with its MFU (``utils/flops.py``
``unet_forward_flops`` over the card's bf16 peak), and the logits of the
two compared (the pool is exact, so their max |d| is expected to be 0).
Timing: ``scripts/torch_timing_common.py``.

    python scripts/torch_pool_v2.py [--batch 32]
    python scripts/torch_pool_v2.py --device cpu --batch 2 --size 64 \\
        --depth 3 --start-filts 8

Prints the readings and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_pool_probe import pool_bytes  # noqa: E402
from scripts.torch_roofline import (_equal_nan, _randn,  # noqa: E402
                                    seeded_state_dict, serving_model,
                                    with_nonfinite)


@torch.no_grad()
def forward_off(model, x):
    """The eval forward of ``model`` with every pool ``F.max_pool2d`` after
    the relu (no pool kernel): ``UNet._forward`` with ``pool_kernels``
    False on level 0.  ``x`` (B, H, W, C) NHWC; NHWC float32 logits."""
    from crimac_unet_tpu_torch.models.unet import _conv, _nchw, _nhwc
    if model.training or model.late_meta_inject:
        raise ValueError("forward_off runs the eval forward without late "
                         "metadata inject")
    dtype = model.dtype
    h = _nchw(x.contiguous()).to(dtype)
    skips = []
    for down in model.down_convs:
        h, skip = down(h, dtype, pool_kernels=False)
        skips.append(skip)
    for i, up in enumerate(model.up_convs):
        h = up(skips[-(i + 2)], h, dtype)
    return _nhwc(_conv(h, model.conv_final, dtype).float())


def db_input(B, H, W, seed=0) -> np.ndarray:
    """The JAX script's serving input: lognormal sv in dB, clipped to
    [-75, 0], float32 (B, H, W, 4)."""
    rng = np.random.RandomState(seed)
    sv = rng.lognormal(-12, 3, (B, H, W, 4)).astype(np.float32)
    return np.clip(10 * np.log10(sv + 1e-10), -75, 0).astype(np.float32)


def standalone(B, H, W, dev, peak, n, log) -> dict:
    """Stage 1: K2 and ``F.max_pool2d`` bit-equal, then timed."""
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2,
                                                maxpool2x2_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    C = 64
    x = _randn((B, H, W, C), torch.bfloat16, dev, gen)
    equal = all(_equal_nan(maxpool2x2(v), maxpool2x2_reference(v))
                for v in (x, with_nonfinite(x)))
    log("kernel: " + ("bit-equal" if equal else "DIFFERS")
        + " vs F.max_pool2d (NaN, +-Inf seeded)")
    if not equal:
        raise RuntimeError("K2 differs from F.max_pool2d")
    t_bound = tc.bound_s(0, pool_bytes(B, H, W, C), peak)[0] * 1e3
    nset = tc.copies(B * H * W * C * 2, dev)
    xs = [x] + [_randn((B, H, W, C), torch.bfloat16, dev, gen)
                for _ in range(nset - 1)]
    out = {"k2_equal": equal, "bound_ms": t_bound}
    for key, fn in (("maxpool2d_ms", maxpool2x2_reference),
                    ("k2_ms", maxpool2x2)):
        out[key], _ = tc.device_ms(lambda i, f=fn: f(xs[i % nset]), dev,
                                   n=n)
    log(f"  F.max_pool2d standalone: {out['maxpool2d_ms']:.4f} ms "
        f"({t_bound / out['maxpool2d_ms']:.1%} of the {t_bound:.4f} ms "
        f"bound)")
    log(f"  K2 maxpool2x2 standalone: {out['k2_ms']:.4f} ms "
        f"({t_bound / out['k2_ms']:.1%})")
    return out


def in_context(B, H, W, depth, sf, dev, peak, n, log) -> dict:
    """Stage 2: the folded serving forward, ON (K3) and OFF
    (``F.max_pool2d``): ms a forward, MFU, K3 launches a call, logits'
    max |d|."""
    from crimac_unet_tpu_torch.utils.flops import unet_forward_flops
    cfg = {"depth": depth, "start_filts": sf, "compute_dtype": "bfloat16",
           "frequencies": common.FREQS}
    model = serving_model(seeded_state_dict(cfg), cfg, dev)
    nset = tc.copies(B * H * W * 4 * 4, dev)
    xs = [torch.from_numpy(db_input(B, H, W, seed=s)).to(dev)
          for s in range(nset)]
    fl = unet_forward_flops(H, W, depth=depth, start_filts=sf) * B
    arms = {"on": model, "off": lambda x: forward_off(model, x)}
    out, logits = {"flops": fl}, {}
    for tag, fn in arms.items():
        logits[tag], c = tc.launches_of(lambda f=fn: f(xs[0]), dev)
        ms, host = tc.device_ms(lambda i, f=fn: f(xs[i % nset]), dev, n=n)
        out[tag] = {"ms": ms, "host_ms": host,
                    "mfu": fl / max(ms * 1e-3, 1e-12) / peak,
                    "k3_launches": c["relu_pool_skip"],
                    "launches": {k: v for k, v in c.items() if v}}
        log(f"  serving forward pool kernel {tag.upper():<3}: {ms:.4f} ms "
            f"(host enqueue {host:.4f})  MFU {out[tag]['mfu']:.2%}; K3 "
            f"{c['relu_pool_skip']} a call")
    d = (logits["on"] - logits["off"]).abs()
    out["max_abs_dlogit"] = float(d.max())
    out["max_abs_logit"] = float(logits["on"].abs().max())
    out["logits_equal"] = bool(torch.equal(logits["on"], logits["off"]))
    out["logits_finite"] = bool(torch.isfinite(logits["on"]).all())
    out["logits_shape"] = list(logits["on"].shape)
    out["on_over_off"] = out["on"]["ms"] / max(out["off"]["ms"], 1e-12)
    log(f"  logits max |d| ON vs OFF: {out['max_abs_dlogit']} (max "
        f"|logit| {out['max_abs_logit']:.4f}); ON / OFF time "
        f"{out['on_over_off']:.4f}")
    return out


def run(device="cuda", batch=32, size=256, depth=5, start_filts=64, n=10,
        log=print) -> dict:
    dev = common.device_of(device)
    card = common.card_name(dev)
    peak = tc.peak_flops(dev)
    log(f"device: {card}")
    res = {"device": card, "batch": batch, "size": size, "depth": depth,
           "start_filts": start_filts}
    res["standalone"] = standalone(batch, size, size, dev, peak, n, log)
    res["forward"] = in_context(batch, size, size, depth, start_filts, dev,
                                peak, max(n // 2, 2), log)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-filts", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.size, args.depth,
                      args.start_filts), args.out)


if __name__ == "__main__":
    main()
