"""The pool probe's three kernels on the card: the port's counterpart of
``scripts/pallas_pool_probe.py``.

Can a hand-written kernel close the level-0 pool's gap to its byte
bound?  The JAX probe asked it with three Pallas layouts of the 2x2
stride-2 max pool; their CUDA counterparts are P1 ``pool_nhwc``, P2
``pool_lane128`` and P3 ``pool_packed`` (``ops/pool_probe.py``,
``csrc/pool_probe.cu``).  Each is first held bit for bit, NaN and +-Inf
positions included, to ``F.max_pool2d`` and to its own plain version on
the seeded input of ``torch_roofline.pool_kernels_equal``; then
``F.max_pool2d``, K2 ``maxpool2x2``, P1-P3 and their plain versions are
timed at (B, 256, 256, 64) bfloat16 against the byte bound

    (B H W C + B H W C / 4) x 2 bytes / 3.35 TB/s

(the JAX probe's count with the H100's HBM rate).  Timing:
``scripts/torch_timing_common.py`` (CUDA events around bursts queued
behind a device-side sleep, inputs rotated past 2x the L2).

    python scripts/torch_pool_probe.py [--batch 32]
    python scripts/torch_pool_probe.py --device cpu --batch 2 --size 32

Prints a table and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import (_equal_nan, _randn,  # noqa: E402
                                    with_nonfinite)


def pool_bytes(B, H, W, C, bytes_el=2) -> int:
    """The pool's least traffic: the input read once, the quarter-size
    output written once."""
    return (B * H * W * C + B * H * W * C // 4) * bytes_el


def max_abs_err(got, want) -> float:
    """max |got - want| where both are finite-or-equal; inf when the NaN
    positions differ."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    g, w = got.float(), want.float()
    same = (g == w) | torch.isnan(w)
    if bool(same.all()):
        return 0.0
    return float((g - w)[~same].abs().max())


def probe_kernels_equal(x_nhwc) -> dict:
    """{variant: {"equal", "max_abs_err"}}: P1-P3 on ``x`` and on a copy
    with NaN and +-Inf written in, against ``F.max_pool2d`` and against
    each variant's plain version: bit for bit, NaN positions included."""
    from crimac_unet_tpu_torch.ops.pool import maxpool2x2_reference
    from crimac_unet_tpu_torch.ops.pool_probe import VARIANTS
    out = {}
    for name, (kernel, plain, _) in VARIANTS.items():
        ok, err = True, 0.0
        for x in (x_nhwc, with_nonfinite(x_nhwc)):
            got = kernel(x)
            for want in (maxpool2x2_reference(x), plain(x)):
                ok &= _equal_nan(got, want)
                err = max(err, max_abs_err(got, want))
        tc.synchronize(x_nhwc.device)
        out[name] = {"equal": bool(ok), "max_abs_err": err}
    return out


def run(device="cuda", batch=32, size=256, chan=64, n=20, log=print) -> dict:
    """The bit-equality checks, then every pool timed at ``batch``."""
    from crimac_unet_tpu_torch.ops import cuda_lib
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2,
                                                maxpool2x2_reference)
    from crimac_unet_tpu_torch.ops.pool_probe import VARIANTS
    dev = common.device_of(device)
    card = common.card_name(dev)
    peak = tc.peak_flops(dev)
    B, H, W, C = batch, size, size, chan
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"device: {card}; pool 2x2/s2 on {B}x{H}x{W}x{C} bf16")
    x = _randn((B, H, W, C), torch.bfloat16, dev, gen)
    checks = probe_kernels_equal(x)
    for name, r in checks.items():
        log(f"  {name}: " + ("bit-equal" if r["equal"] else
                             f"DIFFERS (max |d| {r['max_abs_err']})")
            + " to F.max_pool2d and its plain version (NaN, +-Inf seeded)")
    bad = [k for k, r in checks.items() if not r["equal"]]
    if bad:
        raise RuntimeError(f"pool probe kernels differ from F.max_pool2d: "
                           f"{bad}")

    nbytes = pool_bytes(B, H, W, C)
    t_bound = tc.bound_s(0, nbytes, peak)[0] * 1e3
    floor_ms, _ = tc.launch_floor_ms(dev)
    log(f"  HBM bound {t_bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{tc.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    nset = tc.copies(B * H * W * C * 2, dev)
    xs = [x] + [_randn((B, H, W, C), torch.bfloat16, dev, gen)
                for _ in range(nset - 1)]
    arms = [("F.max_pool2d", maxpool2x2_reference),
            ("K2 maxpool2x2", maxpool2x2)]
    for name, (kernel, plain, _) in VARIANTS.items():
        arms += [(name, kernel), (f"{name} plain", plain)]
    tc.synchronize(dev)
    before = dict(cuda_lib.launches)
    rows = []
    log(f"  {'pool':<28} {'ms':>8} {'host ms':>8} {'of bound':>8}  limit")
    for name, fn in arms:
        ms, host = tc.device_ms(lambda i, f=fn: f(xs[i % nset]), dev, n=n)
        rows.append(dict(name=name, ms=ms, host_ms=host, bound_ms=t_bound,
                         share=t_bound / max(ms, 1e-9),
                         limit=tc.limit_of(ms, floor_ms, "HBM")))
        log(f"  {name:<28} {ms:8.4f} {host:8.4f} {t_bound / ms:8.1%}  "
            f"{rows[-1]['limit']}")
    tc.synchronize(dev)
    timed = {k: v - before[k] for k, v in cuda_lib.launches.items()}
    return {"device": card, "batch": B, "size": size, "chan": C,
            "bound_ms": t_bound, "bound_by": "bytes", "bytes": nbytes,
            "launch_floor_ms": floor_ms, "checks": checks, "rows": rows,
            "timed_launches": timed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--chan", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.size, args.chan),
                  args.out)


if __name__ == "__main__":
    main()
