"""Per-layer roofline of the port's serving U-Net forward on the card:
the port's counterpart of ``scripts/roofline.py``.

Every layer of the inference-geometry forward (batch 32, 256x256x4,
depth 5 / start_filts 64, BatchNorm folded, bf16) is timed alone and
held to its roofline bound

    t_bound = max(FLOPs / 989.4 TFLOP/s,  bytes / 3.35 TB/s)

(the H100 SXM's bf16 tensor-core peak, ``utils/flops.py``, and its HBM
rate), so each layer lands at its bound, bandwidth-bound by nature, or
short of it.  The layers are the ones the port runs: ``F.conv2d`` /
``F.conv_transpose2d`` in bf16 on channels_last activations and weights
under torch's default cuDNN settings (``models/unet.py``,
``pipeline/runner.py``), the level-0 pool as the serving forward runs it
(K3 ``crimac::relu_pool_skip`` on the raw conv2 output) and every pool
level as K2 ``crimac::maxpool2x2`` beside ``F.max_pool2d``, each kernel
held bit for bit to its plain version at that shape before it is timed.
Then a streaming-read probe (one HBM read pass over the largest
activation), the whole folded serving forward, sum-of-layers against
whole, the highest MFU the roofline floor allows, and in-context block
times from growing prefixes of the forward.

Timing: ``scripts/torch_timing_common.py`` (CUDA events around bursts
queued behind a device-side sleep, inputs rotated past 2x the L2, rows
within 2x the launch floor marked ``launch``).

    python scripts/torch_roofline.py [--batch 32] [--train-batch 4]
    python scripts/torch_roofline.py --device cpu --batch 2 --size 64 \\
        --depth 3 --start-filts 8

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


def layer_specs(B, H, W, depth=5, sf=64, cin0=4, n_classes=3):
    """(name, kind, B, H, W, Cin, Cout) for every op of the folded-BN
    inference forward, in execution order."""
    specs = []
    h, w, cin = H, W, cin0
    for i in range(depth):
        cout = sf * 2 ** i
        specs.append((f"down{i}.conv1", "conv3", B, h, w, cin, cout))
        specs.append((f"down{i}.conv2", "conv3", B, h, w, cout, cout))
        cin = cout
        if i < depth - 1:
            specs.append((f"down{i}.pool", "pool", B, h, w, cout, cout))
            h, w = h // 2, w // 2
    for j in range(depth - 1):
        cout = cin // 2
        specs.append((f"up{j}.convT", "convT", B, h, w, cin, cout))
        h, w = 2 * h, 2 * w
        specs.append((f"up{j}.concat", "concat", B, h, w, cout, 2 * cout))
        specs.append((f"up{j}.conv1", "conv3", B, h, w, 2 * cout, cout))
        specs.append((f"up{j}.conv2", "conv3", B, h, w, cout, cout))
        cin = cout
    specs.append(("head.conv1x1", "conv1", B, h, w, cin, n_classes))
    return specs


def op_cost(kind, B, H, W, Ci, Co, bytes_el=2):
    """(FLOPs, min HBM bytes) of one op.  Bytes = inputs + outputs +
    weights, bf16; the true minimum traffic if VMEM captures all reuse."""
    px_in, px_out = B * H * W, B * H * W
    if kind == "conv3":
        flops = 2 * px_out * 9 * Ci * Co
        by = (px_in * Ci + px_out * Co + 9 * Ci * Co) * bytes_el
    elif kind == "conv1":
        flops = 2 * px_out * Ci * Co
        by = (px_in * Ci + px_out * Co + Ci * Co) * bytes_el
    elif kind == "convT":  # 2x2 stride 2: each input px -> 4 outputs
        flops = 2 * px_in * 4 * Ci * Co
        by = (px_in * Ci + 4 * px_out * Co + 4 * Ci * Co) * bytes_el
    elif kind == "pool":
        flops = 0
        by = (px_in * Ci + px_in // 4 * Ci) * bytes_el
    elif kind == "concat":  # H,W here are post-upsample; Ci=half, Co=full
        flops = 0
        by = 2 * px_in * Co * bytes_el
    else:
        raise ValueError(kind)
    return flops, by


def k3_bytes(B, H, W, C, bytes_el=2) -> int:
    """K3's least traffic: the raw input read once, the pooled output and
    the relu'd skip written once."""
    return B * H * W * C * bytes_el * 9 // 4


# ------------------------------------------------------------- the layers
# Port layout: activations (B, C, H, W) in channels_last memory, conv
# weights (O, I, kh, kw), transpose-conv weights (I, O, 2, 2), as
# models/unet.py runs them.
def conv_bias(x, w, b, relu=True):
    y = F.conv2d(x, w, None, padding=w.shape[-1] // 2) + b.view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


def convT_bias(x, w, b):
    return F.conv_transpose2d(x, w, None, stride=2) + b.view(1, -1, 1, 1)


def concat(up, skip):
    """The decoder's concat: the upsampled map first (models/unet.py
    ``UpConv``; roofline.py puts the skip first)."""
    return torch.cat([up, skip], dim=1)


def pool0(y):
    """The serving forward's level-0 pool: K3 on the raw conv2 output ->
    (pooled, relu'd skip), NCHW channels_last views."""
    from crimac_unet_tpu_torch.models.unet import _nchw, _nhwc
    from crimac_unet_tpu_torch.ops.pool import relu_pool_skip
    pooled, skip = relu_pool_skip(_nhwc(y))
    return _nchw(pooled), _nchw(skip)


def hwio_weights(specs, seed=7):
    """Random weights in the JAX scripts' HWIO layout for every conv-family
    op of ``specs`` (roofline.py ``build_weights``'s draws, float32)."""
    rng = np.random.RandomState(seed)
    ws = {}
    for name, kind, b, h, w, ci, co in specs:
        if kind in ("conv3", "conv1", "convT"):
            k = {"conv3": 3, "conv1": 1, "convT": 2}[kind]
            ws[name] = ((rng.randn(k, k, ci, co) * .05).astype(np.float32),
                        (rng.randn(co) * .05).astype(np.float32))
    return ws


def port_weights(hwio: dict, specs, device="cpu", dtype=torch.bfloat16,
                 channels_last=True):
    """HWIO weights -> the port's layout on ``device``: conv (O, I, kh,
    kw); transpose conv (I, O, 2, 2) spatially flipped (flax's
    ConvTranspose against torch's, models/weights.py); a decoder conv1's
    input halves swapped, since the port concatenates [up, skip] where
    roofline.py concatenates [skip, up]."""
    kinds = {s[0]: s[1] for s in specs}
    out = {}
    for name, (w, b) in hwio.items():
        if kinds[name] == "convT":
            t = w[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            t = w.transpose(3, 2, 0, 1)
            if name.startswith("up") and name.endswith(".conv1"):
                half = t.shape[1] // 2
                t = np.concatenate([t[:, half:], t[:, :half]], axis=1)
        wt = torch.from_numpy(np.ascontiguousarray(t)).to(device, dtype)
        if channels_last and wt.shape[-1] > 1:
            wt = wt.contiguous(memory_format=torch.channels_last)
        out[name] = (wt, torch.from_numpy(b).to(device, dtype))
    return out


def forward_prefix(x, ws, specs, n_ops):
    """The first ``n_ops`` ops of the serving forward with real skip
    connections, as ``models/unet.py`` runs it BatchNorm-folded: the
    level-0 conv2 raw into K3, deeper pools ``F.max_pool2d``, the head
    without relu.  ``x`` (B, C, H, W) channels_last; returns the same
    layout."""
    skips = []
    y = x
    for name, kind, *_rest in specs[:n_ops]:
        if kind in ("conv3", "conv1"):
            w, b = ws[name]
            y = conv_bias(y, w, b, relu=kind == "conv3"
                          and name != "down0.conv2")
        elif kind == "pool":
            if name == "down0.pool":
                y, skip = pool0(y)
            else:
                skip, y = y, F.max_pool2d(y, 2, 2)
            skips.append(skip)
        elif kind == "convT":
            w, b = ws[name]
            y = convT_bias(y, w, b)
        elif kind == "concat":
            y = concat(y, skips.pop())
    return y


def prefix_cuts(specs):
    """(block, n_ops) after each down / up block and the head."""
    cuts, last = [], None
    for idx, (name, *_r) in enumerate(specs):
        blk = name.split(".")[0]
        if last is not None and blk != last:
            cuts.append((last, idx))
        last = blk
    cuts.append((last, len(specs)))
    return cuts


def serving_model(state_dict, cfg, device):
    """The port's folded serving U-Net as ``GriddedRunner`` holds it:
    BatchNorm folded into the convs, channels_last, eval mode."""
    from crimac_unet_tpu_torch.models.fold_bn import fold_for_serving
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.models.weights import to_tensors
    model, sd = fold_for_serving(build_unet(cfg), to_tensors(state_dict), cfg)
    model.load_state_dict(sd)
    return model.to(device, memory_format=torch.channels_last).eval()


def seeded_state_dict(cfg, seed=0):
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    return init_random_(build_unet(cfg),
                        torch.Generator().manual_seed(seed)).state_dict()


# ------------------------------------------------------------- the tables
def _randn(shape, dtype, device, gen, scale=0.1, channels_last=False):
    t = (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) \
        if channels_last else t


def _sets(k, make):
    return [make() for _ in range(k)]


def _equal_nan(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got.float(), nan=0.0),
                            torch.nan_to_num(want.float(), nan=0.0)))


def with_nonfinite(x):
    """A copy of ``x`` with NaN, +Inf and -Inf written at three strides."""
    seeded = x.clone()
    flat = seeded.view(-1)
    n = flat.numel()
    flat[::max(n // 97, 1)] = float("nan")
    flat[3::max(n // 89, 1)] = float("inf")
    flat[5::max(n // 83, 1)] = float("-inf")
    return seeded


def pool_kernels_equal(x_nhwc) -> dict:
    """K2 and K3 against their plain versions (``ops/pool.py``) on ``x``
    and on a copy with NaN and +-Inf written in: bit for bit, NaN
    positions included."""
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2,
                                                maxpool2x2_reference,
                                                relu_pool_skip,
                                                relu_pool_skip_reference)
    k2 = k3 = True
    for x in (x_nhwc, with_nonfinite(x_nhwc)):
        k2 &= _equal_nan(maxpool2x2(x), maxpool2x2_reference(x))
        for got, want in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
            k3 &= _equal_nan(got, want)
    return {"k2_equal": bool(k2), "k3_equal": bool(k3)}


def _row(name, kind, flops, nbytes, ms, host_ms, peak, floor_ms, **extra):
    t_bound, lim = tc.bound_s(flops, nbytes, peak)
    return dict(layer=name, kind=kind, gflop=flops / 1e9, mb=nbytes / 1e6,
                bound_ms=t_bound * 1e3, ms=ms, host_ms=host_ms,
                eff=t_bound * 1e3 / max(ms, 1e-9),
                mfu=flops / max(ms * 1e-3, 1e-12) / peak,
                limit=tc.limit_of(ms, floor_ms, lim), **extra)


def streaming_probe(B, H, W, device, peak, floor_ms, n=10, log=print):
    """One HBM read pass over the largest activation (B, H, W, 64) bf16:
    ``torch.sum`` into float32."""
    gen = torch.Generator(device=device).manual_seed(11)
    nb = B * H * W * 64 * 2
    xs = _sets(tc.copies(nb, device), lambda: _randn((B, H, W, 64), torch.bfloat16,
                                             device, gen))
    ms, host = tc.device_ms(lambda i: torch.sum(xs[i % len(xs)],
                                                dtype=torch.float32),
                            device, n=n)
    row = _row("probe.read", "probe", 0, nb, ms, host, peak, floor_ms)
    log(f"streaming-read probe ({B}x{H}x{W}x64 bf16): {ms:.4f} ms for "
        f"{nb / 1e6:.1f} MB -> {nb / ms / 1e6:.1f} GB/s (HBM "
        f"{tc.HBM_BYTES_PER_S / 1e9:.0f}; bound {row['bound_ms']:.4f} ms)")
    return row


def run_layers(B, H, W, peak, tag, device, floor_ms, depth=5, sf=64,
               dtype=torch.bfloat16, n=20, log=print):
    """Every layer of ``layer_specs`` timed alone; returns (rows, sums)."""
    from crimac_unet_tpu_torch.ops.pool import maxpool2x2
    from crimac_unet_tpu_torch.utils.flops import unet_forward_flops
    gen = torch.Generator(device=device).manual_seed(0)
    el = torch.finfo(dtype).bits // 8
    rows = []
    log(f"\n== {tag}: per-layer roofline, batch {B}, {H}x{W}, "
        f"{str(dtype).split('.')[-1]} ==")
    log(f"{'layer':<14} {'GFLOP':>8} {'MB':>8} {'bound':>8} {'meas':>8} "
        f"{'eff':>5} {'MFU':>5}  limit      F.max_pool2d / K2 / K3")
    for name, kind, b, h, w, ci, co in layer_specs(B, H, W, depth, sf):
        flops, nbytes = op_cost(kind, b, h, w, ci, co, el)
        extra = {}
        if kind in ("conv3", "conv1"):
            k = 3 if kind == "conv3" else 1
            relu = kind == "conv3" and name != "down0.conv2"
            nset = tc.copies((b * h * w * ci + k * k * ci * co) * el, device)
            xs = _sets(nset, lambda: _randn((b, ci, h, w), dtype, device,
                                            gen, channels_last=True))
            ws = _sets(nset, lambda: _randn((co, ci, k, k), dtype, device,
                                            gen, .05, channels_last=True))
            bias = _randn((co,), dtype, device, gen, .05)
            ms, host = tc.device_ms(lambda i: conv_bias(
                xs[i % nset], ws[i % nset], bias, relu), device, n=n)
        elif kind == "convT":
            nset = tc.copies((b * h * w * ci + 4 * ci * co) * el, device)
            xs = _sets(nset, lambda: _randn((b, ci, h, w), dtype, device,
                                            gen, channels_last=True))
            ws = _sets(nset, lambda: _randn((ci, co, 2, 2), dtype, device,
                                            gen, .05, channels_last=True))
            bias = _randn((co,), dtype, device, gen, .05)
            ms, host = tc.device_ms(lambda i: convT_bias(
                xs[i % nset], ws[i % nset], bias), device, n=n)
        elif kind == "pool":
            nset = tc.copies(b * h * w * ci * el, device)
            xs = _sets(nset, lambda: _randn((b, h, w, ci), dtype, device,
                                            gen))       # NHWC contiguous
            extra.update(pool_kernels_equal(xs[0]))
            k2_ms, k2_host = tc.device_ms(lambda i: maxpool2x2(
                xs[i % nset]), device, n=n)
            mp_ms, _ = tc.device_ms(lambda i: F.max_pool2d(
                xs[i % nset].permute(0, 3, 1, 2), 2, 2), device, n=n)
            extra.update(k2_ms=k2_ms, maxpool2d_ms=mp_ms,
                         k2_bound_ms=tc.bound_s(0, nbytes, peak)[0] * 1e3)
            ms, host = k2_ms, k2_host
            if name == "down0.pool":
                k3_ms, k3_host = tc.device_ms(lambda i: pool0(
                    xs[i % nset].permute(0, 3, 1, 2)), device, n=n)
                nbytes = k3_bytes(b, h, w, ci, el)
                extra.update(k3_ms=k3_ms, k3_bound_ms=tc.bound_s(
                    0, nbytes, peak)[0] * 1e3)
                ms, host = k3_ms, k3_host
        else:  # concat: the upsampled half and the skip half
            nset = tc.copies(2 * b * h * w * ci * el, device)
            ups = _sets(nset, lambda: _randn((b, ci, h, w), dtype, device,
                                             gen, channels_last=True))
            sks = _sets(nset, lambda: _randn((b, ci, h, w), dtype, device,
                                             gen, channels_last=True))
            ms, host = tc.device_ms(lambda i: concat(
                ups[i % nset], sks[i % nset]), device, n=n)
        row = _row(name, kind, flops, nbytes, ms, host, peak, floor_ms,
                   **extra)
        rows.append(row)
        pools = ""
        if kind == "pool":
            pools = (f"{extra['maxpool2d_ms']:.4f}m / K2 "
                     f"{extra['k2_ms']:.4f}m") + (
                f" / K3 {extra['k3_ms']:.4f}m" if "k3_ms" in extra else "")
        log(f"{name:<14} {row['gflop']:8.2f} {row['mb']:8.2f} "
            f"{row['bound_ms']:7.4f}m {ms:7.4f}m {row['eff']:5.0%} "
            f"{row['mfu']:5.0%}  {row['limit']:<9}  {pools}")
    t_sum = sum(r["ms"] for r in rows)
    t_bound = sum(r["bound_ms"] for r in rows)
    tot = unet_forward_flops(H, W, depth=depth, start_filts=sf) * B
    log(f"{'SUM':<14} {tot / 1e9:8.2f} {'':>8} {t_bound:7.4f}m "
        f"{t_sum:7.4f}m {t_bound / max(t_sum, 1e-9):5.0%} "
        f"{tot / max(t_sum * 1e-3, 1e-12) / peak:5.0%}")
    return rows, {"sum_ms": t_sum, "bound_ms": t_bound, "flops": tot}


def run_whole_forward(B, H, W, peak, device, cfg, n=4, log=print):
    """The folded serving forward end to end (what predict runs): (ms,
    host enqueue ms, launches of K3 a call)."""
    from crimac_unet_tpu_torch.utils.flops import unet_forward_flops
    model = serving_model(seeded_state_dict(cfg), cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    xs = _sets(tc.copies(B * H * W * 4 * 2, device), lambda: _randn(
        (B, H, W, 4), model.dtype, device, gen))
    k3 = tc.launches_of(lambda: model(xs[0]), device)[1]["relu_pool_skip"]
    ms, host = tc.device_ms(lambda i: model(xs[i % len(xs)]), device, n=n)
    fl = unet_forward_flops(H, W, depth=cfg["depth"],
                            start_filts=cfg["start_filts"]) * B
    log(f"\nwhole forward (folded BN, {cfg['compute_dtype']}): {ms:.4f} ms "
        f"(host enqueue {host:.4f} ms)  "
        f"{fl / max(ms * 1e-3, 1e-12) / 1e12:.1f} TFLOP/s  MFU "
        f"{fl / max(ms * 1e-3, 1e-12) / peak:.2%}; K3 {k3} a call")
    return ms, host, k3


def run_prefixes(B, H, W, peak, device, depth=5, sf=64,
                 dtype=torch.bfloat16, n=4, log=print):
    """In-context block times: growing prefixes of the forward, one cut
    after each block, diffed."""
    specs = layer_specs(B, H, W, depth, sf)
    ws = port_weights(hwio_weights(specs), specs, device, dtype)
    gen = torch.Generator(device=device).manual_seed(3)
    xs = _sets(tc.copies(B * H * W * 4 * 2, device), lambda: _randn(
        (B, 4, H, W), dtype, device, gen, channels_last=True))
    log(f"\n== in-context per-block times (prefix diffs), batch {B} ==")
    log(f"{'block':<10} {'GFLOP':>8} {'bound':>8} {'meas':>8} {'eff':>5} "
        f"{'MFU':>5}")
    rows, t_prev, lo = [], 0.0, 0
    for blk, n_ops in prefix_cuts(specs):
        t, _ = tc.device_ms(lambda i, _n=n_ops: forward_prefix(
            xs[i % len(xs)], ws, specs, _n), device, n=n)
        fl = by = 0
        t_bound = 0.0
        for name, kind, b, h, w, ci, co in specs[lo:n_ops]:
            f_, by_ = op_cost(kind, b, h, w, ci, co)
            fl += f_
            by += by_
            t_bound += tc.bound_s(f_, by_, peak)[0] * 1e3
        dt = t - t_prev
        log(f"{blk:<10} {fl / 1e9:8.2f} {t_bound:7.4f}m {dt:7.4f}m "
            f"{t_bound / max(dt, 1e-9):5.0%} "
            f"{fl / max(dt * 1e-3, 1e-12) / peak:5.0%}")
        rows.append(dict(block=blk, n_ops=n_ops, ms=dt, prefix_ms=t,
                         bound_ms=t_bound, gflop=fl / 1e9))
        t_prev, lo = t, n_ops
    log(f"{'TOTAL':<10} {sum(r['gflop'] for r in rows):8.2f} "
        f"{sum(r['bound_ms'] for r in rows):7.4f}m {t_prev:7.4f}m")
    return rows


def run(device="cuda", batch=32, train_batch=0, size=256, depth=5,
        start_filts=64, prefixes=True, n=20, log=print) -> dict:
    """The forward roofline at ``batch`` (and ``train_batch`` when > 0),
    bf16 as the serving forward runs: the launch floor, the streaming
    probe, the per-layer tables, the whole folded forward and the prefix
    diffs."""
    dev = common.device_of(device)
    compute_dtype, dtype = "bfloat16", torch.bfloat16
    peak = tc.peak_flops(dev)
    card = common.card_name(dev)
    floor_ms, floor_host = tc.launch_floor_ms(dev)
    log(f"device: {card}; peak {peak / 1e12:.1f} TFLOP/s bf16, HBM "
        f"{tc.HBM_BYTES_PER_S / 1e9:.0f} GB/s, L2 {tc.L2_BYTES / 2**20:.0f}"
        f" MiB (inputs rotated over > 2x L2)")
    log(f"launch floor (an empty op): device {floor_ms:.4f} ms, host "
        f"enqueue {floor_host:.4f} ms; rows within {tc.FLOOR_FACTOR:g}x the "
        f"device floor are marked 'launch'")
    cfg = {"depth": depth, "start_filts": start_filts,
           "compute_dtype": compute_dtype, "frequencies": common.FREQS}
    res = {"device": card, "peak_flops": peak,
           "hbm_bytes_per_s": tc.HBM_BYTES_PER_S, "l2_bytes": tc.L2_BYTES,
           "launch_floor_ms": floor_ms, "launch_floor_host_ms": floor_host,
           "batch": batch, "size": size, "depth": depth,
           "start_filts": start_filts, "compute_dtype": compute_dtype}
    res["probe"] = streaming_probe(batch, size, size, dev, peak, floor_ms,
                                   log=log)
    rows, sums = run_layers(batch, size, size, peak, "inference", dev,
                            floor_ms, depth, start_filts, dtype, n, log)
    whole, whole_host, k3 = run_whole_forward(batch, size, size, peak, dev,
                                              cfg, log=log)
    max_mfu = sums["flops"] / max(sums["bound_ms"] * 1e-3, 1e-12) / peak
    log(f"sum-of-layers {sums['sum_ms']:.4f} ms vs whole {whole:.4f} ms "
        f"(ratio {sums['sum_ms'] / max(whole, 1e-9):.2f}x); roofline-bound "
        f"floor {sums['bound_ms']:.4f} ms -> max achievable MFU at this "
        f"geometry {max_mfu:.1%}")
    res.update(layers=rows, sum_of_layers_ms=sums["sum_ms"],
               bound_floor_ms=sums["bound_ms"], forward_flops=sums["flops"],
               whole_forward_ms=whole, whole_forward_host_ms=whole_host,
               whole_mfu=sums["flops"] / max(whole * 1e-3, 1e-12) / peak,
               whole_k3_launches=k3, max_mfu=max_mfu)
    res["prefixes"] = run_prefixes(batch, size, size, peak, dev, depth,
                                   start_filts, dtype, log=log) \
        if prefixes else []
    if train_batch:
        trows, tsums = run_layers(train_batch, size, size, peak,
                                  "train-batch fwd", dev, floor_ms, depth,
                                  start_filts, dtype, n, log)
        twhole, thost, _ = run_whole_forward(train_batch, size, size, peak,
                                             dev, cfg, log=log)
        res["train_batch"] = {
            "batch": train_batch, "layers": trows,
            "sum_of_layers_ms": tsums["sum_ms"],
            "bound_floor_ms": tsums["bound_ms"],
            "whole_forward_ms": twhole, "whole_forward_host_ms": thost,
            "whole_mfu": tsums["flops"] / max(twhole * 1e-3, 1e-12) / peak}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-batch", type=int, default=0,
                    help="also roofline at this (small) train batch")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-filts", type=int, default=64)
    ap.add_argument("--no-prefix", action="store_true",
                    help="skip the in-context prefix-diff pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.train_batch, args.size,
                      args.depth, args.start_filts,
                      prefixes=not args.no_prefix), args.out)


if __name__ == "__main__":
    main()
