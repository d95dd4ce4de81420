"""Formulations of the level-0 U-Net ops timed on the card: the port's
counterpart of ``scripts/l0_probe.py``.

The per-layer roofline (``scripts/torch_roofline.py``) puts the 256x256
level furthest from its bounds.  This tool times formulations of its
ops that compute the same function, to see whether a layout recovers
the slack:

* pool 2x2/s2 on (B, 256, 256, 64): ``F.max_pool2d`` (production of the
  deeper levels, the JAX probe's "prod"), reshape + ``amax``, four
  strided-slice maxima, and the port's production kernels K2
  ``maxpool2x2`` and K3 ``relu_pool_skip`` (on the raw conv output: relu,
  skip and pool, its own byte count);
* conv 3x3 64->64 with bias and relu: channels_last ``F.conv2d`` (the
  port's production, ``models/unet.py`` ``_conv``), contiguous NCHW,
  output channels zero-padded 64 -> 128, space-to-depth as one 2x2 VALID
  conv on the :func:`s2d_kernel` weight (16/9 the FLOPs), and
  space-to-depth as per-phase GEMMs with float32 sums;
* transposed conv 2x2/s2 128->64 at 128x128: ``F.conv_transpose2d``
  against one GEMM and depth-to-space.

As in the JAX probe every formulation is held to production on a
2-sample slice before it is timed: pools bit for bit, convs within
rtol = atol = 0.05.  Each row is timed (``torch_timing_common``) against
max(FLOPs / the bf16 peak, bytes / 3.35 TB/s).  Weights are drawn in the
JAX probe's HWIO layout from the seed and mapped with
``torch_roofline.port_weights``.  Activations are (B, C, H, W) in
channels_last memory, as the port runs them.

    python scripts/torch_l0_probe.py [--batch 32] [--train-batch 8]
    python scripts/torch_l0_probe.py --device cpu --batch 2 \\
        --train-batch 0 --size 32

Prints the tables and one JSON line (and writes it to ``--out``).
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
from scripts.torch_roofline import (_equal_nan, _randn,  # noqa: E402
                                    convT_bias, conv_bias, k3_bytes,
                                    port_weights)

TOL = 0.05                  # the JAX probe's rtol = atol for the convs


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def mm_f32(a, b):
    """``a @ b`` with a float32 result from bfloat16 operands (the JAX
    probe's ``preferred_element_type=float32``): ``torch.mm``'s
    ``out_dtype`` on a card, float32 products off it."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# ------------------------------------------------------------------- pools
def pool_prod(x):
    return F.max_pool2d(x, 2, 2)


def pool_reshape(x):
    B, C, H, W = x.shape
    y = _nhwc(x).reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
    return _nchw(y)


def pool_strided(x):
    return torch.maximum(
        torch.maximum(x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]),
        torch.maximum(x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]))


def pool_k2(x):
    from crimac_unet_tpu_torch.ops.pool import maxpool2x2
    return _nchw(maxpool2x2(_nhwc(x).contiguous()))


def pool_k3(x):
    """K3 on the raw conv output: (pooled, skip = relu(x))."""
    from crimac_unet_tpu_torch.ops.pool import relu_pool_skip
    pooled, skip = relu_pool_skip(_nhwc(x).contiguous())
    return _nchw(pooled), _nchw(skip)


# ------------------------------------------------------------------- convs
def conv_copad(x, w_pad, b):
    """The conv with output channels zero-padded to ``w_pad``'s (the FLOPs
    doubled at 64 -> 128), the real channels kept."""
    y = F.conv2d(x, w_pad, None, padding=1)[:, :b.shape[0]]
    return torch.relu(y + b.view(1, -1, 1, 1))


def pad_out_channels(w, co_to):
    """(Co, Ci, 3, 3) -> (co_to, Ci, 3, 3), zeros appended, in ``w``'s
    memory format."""
    z = torch.zeros((co_to - w.shape[0], *w.shape[1:]), dtype=w.dtype,
                    device=w.device)
    return _cl(torch.cat([w, z]))


def s2d(x_nhwc):
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel block (py*2+px)*C+c
    holds phase (py, px)."""
    B, H, W, C = x_nhwc.shape
    y = x_nhwc.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, H // 2, W // 2, 4 * C)


def d2s(z_nhwc, C):
    B, Hh, Wh, _ = z_nhwc.shape
    y = z_nhwc.reshape(B, Hh, Wh, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * Hh, 2 * Wh, C)


def s2d_kernel(w_hwio: np.ndarray) -> np.ndarray:
    """A 3x3 (Ci, Co) HWIO kernel as the equivalent 2x2 kernel of the
    space-to-depth image (2, 2, 4Ci, 4Co), float32: output phase (oy, ox)
    at (i, j) reads padded rows 2i+oy+dy, i.e. s2d row offset
    (oy+dy)//2 with phase (oy+dy)%2 (the JAX probe's rearrangement)."""
    Ci, Co = w_hwio.shape[2], w_hwio.shape[3]
    k2 = np.zeros((2, 2, 4 * Ci, 4 * Co), np.float32)
    wf = np.asarray(w_hwio, np.float32)
    for oy in range(2):
        for ox in range(2):
            for dy in range(3):
                di, py = divmod(oy + dy, 2)
                for dx in range(3):
                    dj, px = divmod(ox + dx, 2)
                    k2[di, dj,
                       (py * 2 + px) * Ci:(py * 2 + px + 1) * Ci,
                       (oy * 2 + ox) * Co:(oy * 2 + ox + 1) * Co] += \
                        wf[dy, dx]
    return k2


def s2d_weight(k2_hwio: np.ndarray, device, dtype):
    """The 2x2 s2d kernel in the port's (O, I, 2, 2) channels_last form."""
    t = torch.from_numpy(np.ascontiguousarray(k2_hwio.transpose(3, 2, 0, 1)))
    return _cl(t.to(device, dtype))


def conv_s2d2x2(x, k2, b):
    """The 3x3 SAME conv as ONE 2x2 VALID conv on the space-to-depth image
    (4Ci in, 4Co out, 16/9 the FLOPs), then depth-to-space; ``k2`` from
    :func:`s2d_weight`, a once-per-weight transform out of the timing."""
    Co = k2.shape[0] // 4
    xp = _nhwc(F.pad(x, (1, 1, 1, 1)))
    z = _cl(_nchw(s2d(xp)))
    y = _nhwc(F.conv2d(z, k2, None))
    y = _nchw(d2s(y, Co))
    return torch.relu(y + b.view(1, -1, 1, 1))


def conv_s2d(x, w, b):
    """The 3x3 SAME conv as per-phase GEMMs on the padded image's 2x2
    phases: each output phase sums nine (B H/2 W/2, Ci) x (Ci, Co)
    products in float32 (``mm_f32``), cast once, then the phases
    interleave."""
    B, C, H, W = x.shape
    wt = w.permute(2, 3, 1, 0)                       # (3, 3, Ci, Co)
    Co = wt.shape[-1]
    xp = _nhwc(F.pad(x, (1, 1, 1, 1)))
    ph = [[xp[:, py::2, px::2, :] for px in range(2)] for py in range(2)]
    outs = []
    for oy in range(2):
        row = []
        for ox in range(2):
            acc = None
            for dy in range(3):
                iy, py = divmod(oy + dy, 2)
                for dx in range(3):
                    ix, px = divmod(ox + dx, 2)
                    tap = ph[py][px][:, iy:iy + H // 2, ix:ix + W // 2, :]
                    p = mm_f32(tap.reshape(-1, C), wt[dy, dx])
                    acc = p if acc is None else acc + p
            row.append(acc.to(x.dtype).reshape(B, H // 2, W // 2, Co))
        outs.append(torch.stack(row, dim=3))         # (B, H/2, W/2, 2, Co)
    y = torch.stack(outs, dim=2).reshape(B, H, W, Co)
    return torch.relu(_nchw(y) + b.view(1, -1, 1, 1))


def convT_weight(w):
    """The port's (Ci, Co, 2, 2) transpose-conv weight as the (Ci, 4Co)
    matrix whose block (oy*2+ox) is output phase (oy, ox)."""
    Ci, Co = w.shape[0], w.shape[1]
    return w.permute(0, 2, 3, 1).reshape(Ci, 4 * Co).contiguous()


def convT_s2d(x, wm, b):
    """The 2x2/s2 transpose conv as ONE GEMM, (B h w, Ci) x (Ci, 4Co),
    then depth-to-space; ``wm`` from :func:`convT_weight`."""
    B, Ci, h, w = x.shape
    Co = wm.shape[1] // 4
    z = (_nhwc(x).reshape(-1, Ci) @ wm).reshape(B, h, w, 4 * Co)
    return _nchw(d2s(z, Co)) + b.view(1, -1, 1, 1)


# ------------------------------------------------------------------ inputs
def hwio_draws(B, H, W, C=64, seed=0):
    """The JAX probe's draws, in its order, float32: x (B, H, W, C), w
    (3, 3, C, C), b (C,), then the transpose conv's xt (B, H/2, W/2, 2C),
    wt (2, 2, 2C, C), bt (C,)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * .1).astype(np.float32)
    w = (rng.randn(3, 3, C, C) * .05).astype(np.float32)
    b = (rng.randn(C) * .05).astype(np.float32)
    xt = (rng.randn(B, H // 2, W // 2, 2 * C) * .1).astype(np.float32)
    wt = (rng.randn(2, 2, 2 * C, C) * .05).astype(np.float32)
    bt = (rng.randn(C) * .05).astype(np.float32)
    return x, w, b, xt, wt, bt


def port_inputs(draws, device, dtype):
    """The draws in the port's layouts: activations channels_last NCHW,
    conv weights OIHW, transpose-conv weights (I, O, 2, 2) flipped
    (``port_weights``)."""
    x, w, b, xt, wt, bt = draws
    C = w.shape[-1]
    specs = [("l0.conv", "conv3", 0, 0, 0, C, C),
             ("l0.convT", "convT", 0, 0, 0, 2 * C, C)]
    ws = port_weights({"l0.conv": (w, b), "l0.convT": (wt, bt)}, specs,
                      device, dtype)

    def act(a):
        return _cl(torch.from_numpy(a).to(device, dtype).permute(0, 3, 1, 2))
    return {"x": act(x), "w": ws["l0.conv"][0], "b": ws["l0.conv"][1],
            "xt": act(xt), "wt": ws["l0.convT"][0], "bt": ws["l0.convT"][1],
            "k2": s2d_weight(s2d_kernel(w), device, dtype)}


def variants(p):
    """{group: [(name, fn(x_like), flops, bytes)]} of one batch's inputs
    ``p``: each fn takes the (possibly rotated) activation."""
    x, w, b = p["x"], p["w"], p["b"]
    B, C, H, W = x.shape
    el = x.element_size()
    w_pad = pad_out_channels(w, 2 * w.shape[0])
    w_nchw, wm = w.contiguous(), convT_weight(p["wt"])
    pool_by = (B * H * W * C + B * H * W * C // 4) * el
    conv_fl = 2 * B * H * W * 9 * C * C
    conv_by = (2 * B * H * W * C + 9 * C * C) * el
    Ct = p["xt"].shape[1]
    ct_fl = 2 * B * (H // 2) * (W // 2) * 4 * Ct * C
    ct_by = (B * (H // 2) * (W // 2) * Ct + B * H * W * C + 4 * Ct * C) * el
    return {
        "pool": [("F.max_pool2d (prod)", pool_prod, 0, pool_by),
                 ("reshape+amax", pool_reshape, 0, pool_by),
                 ("4x strided slice max", pool_strided, 0, pool_by),
                 ("K2 maxpool2x2", pool_k2, 0, pool_by),
                 ("K3 relu_pool_skip (+skip)", pool_k3, 0,
                  k3_bytes(B, H, W, C, el))],
        # production: channels_last F.conv2d + bias + relu (conv_bias);
        # "NCHW conv" runs it on contiguous NCHW inputs and OIHW weights
        "conv": [("channels_last conv (prod)",
                  lambda a: conv_bias(a, w, b), conv_fl, conv_by),
                 ("NCHW conv", lambda a: conv_bias(a, w_nchw, b), conv_fl,
                  conv_by),
                 ("Co zero-pad 64->128", lambda a: conv_copad(a, w_pad, b),
                  conv_fl, conv_by),
                 ("s2d 2x2 conv (16/9 FLOPs)",
                  lambda a: conv_s2d2x2(a, p["k2"], b), conv_fl, conv_by),
                 ("s2d per-phase GEMMs", lambda a: conv_s2d(a, w, b),
                  conv_fl, conv_by)],
        "convT": [("conv_transpose (prod)",
                   lambda a: convT_bias(a, p["wt"], p["bt"]), ct_fl, ct_by),
                  ("s2d one GEMM", lambda a: convT_s2d(a, wm, p["bt"]),
                   ct_fl, ct_by)],
    }


def _close(got, want, tol=TOL):
    """(max |d|, ok) with the JAX probe's assert_allclose(rtol, atol)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), bool((d <= tol + tol * w.abs()).all())


def check_slice(p) -> dict:
    """Every formulation against production on ``p``'s activations (the
    2-sample slice): pools bit for bit, convs within TOL (the JAX probe's
    order)."""
    groups = variants(p)
    x = p["x"]
    out = {}
    want = pool_prod(x)
    for name, fn, _, _ in groups["pool"]:
        if name.startswith("K3"):
            pooled, skip = fn(x)
            ok = _equal_nan(pooled, pool_prod(torch.relu(x))) and \
                _equal_nan(skip, torch.relu(x))
        else:
            ok = _equal_nan(fn(x), want)
        out[name] = {"max_abs_err": 0.0 if ok else float("inf"),
                     "ok": bool(ok), "tol": "bit-equal"}
    for group, inp in (("conv", x), ("convT", p["xt"])):
        rows = groups[group]
        ref = rows[0][1](inp)
        for name, fn, _, _ in rows:
            a = inp.contiguous() if name == "NCHW conv" else inp
            err, ok = _close(fn(a), ref)
            out[name] = {"max_abs_err": err, "ok": ok, "tol": TOL}
    return out


def run_batch(B, size, dev, peak, floor_ms, n, log, seed=0) -> dict:
    """One batch: the checks on a 2-sample slice drawn as the JAX probe
    draws (numpy, HWIO weights), then every row timed on (B, ...)
    activations drawn on the device with the same weights."""
    p = port_inputs(hwio_draws(2, size, size, seed=seed), dev,
                    torch.bfloat16)
    checks = check_slice(p)
    bad = [k for k, r in checks.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"level-0 formulations differ from production at "
                           f"batch {B}: {bad} ({checks})")
    gen = torch.Generator(device=dev).manual_seed(seed + B)
    C = p["x"].shape[1]
    nset = tc.copies(B * size * size * C * 2, dev)
    xs = [_randn((B, C, size, size), torch.bfloat16, dev, gen,
                 channels_last=True) for _ in range(nset)]
    xts = [_randn((B, 2 * C, size // 2, size // 2), torch.bfloat16, dev,
                  gen, channels_last=True) for _ in range(nset)]
    xs_nchw = [a.contiguous() for a in xs]
    groups = variants(dict(p, x=xs[0], xt=xts[0]))
    rows = []
    for group, label in (("pool", f"pool 2x2/s2 at {B}x{size}x{size}x64"),
                         ("conv", f"conv3x3 64->64 at {B}x{size}x{size}"),
                         ("convT", f"convT 2x2/s2 128->64 at "
                                   f"{B}x{size // 2}x{size // 2}")):
        log(f"\n== {label} bf16 ==")
        for name, fn, fl, by in groups[group]:
            src = xts if group == "convT" else \
                xs_nchw if name == "NCHW conv" else xs
            t_bound, lim = tc.bound_s(fl, by, peak)
            ms, host = tc.device_ms(lambda i, f=fn: f(src[i % nset]), dev,
                                    n=n)
            rows.append(dict(group=group, name=name, batch=B, ms=ms,
                             host_ms=host, bound_ms=t_bound * 1e3,
                             share=t_bound * 1e3 / max(ms, 1e-9),
                             limit=tc.limit_of(ms, floor_ms, lim),
                             gflop=fl / 1e9, mb=by / 1e6))
            log(f"  {name:<28} {ms:8.4f} ms  bound {t_bound * 1e3:.4f} ms "
                f"({lim})  {rows[-1]['share']:6.1%} of bound")
    return {"batch": B, "checks": checks, "rows": rows}


def run(device="cuda", batch=32, train_batch=8, size=256, n=10,
        log=print) -> dict:
    dev = common.device_of(device)
    card = common.card_name(dev)
    peak = tc.peak_flops(dev)
    floor_ms, _ = tc.launch_floor_ms(dev)
    log(f"device: {card}; bf16 peak {peak / 1e12:.1f} TFLOP/s, HBM "
        f"{tc.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    res = {"device": card, "size": size, "peak_flops": peak,
           "launch_floor_ms": floor_ms, "batches": []}
    for B in (batch, train_batch):
        if B:
            res["batches"].append(run_batch(B, size, dev, peak, floor_ms, n,
                                            log))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.train_batch, args.size),
                  args.out)


if __name__ == "__main__":
    main()
