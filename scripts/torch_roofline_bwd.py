"""Per-layer roofline of the port's TRAINING step (forward + backward +
BatchNorm + SGD) on the card: the port's counterpart of
``scripts/roofline_bwd.py``.

For every layer of the training forward (batch 8, 256x256x4, depth 5 /
start_filts 64, bf16 convolutions on channels_last activations, float32
BatchNorm statistics) this times

  * the conv / transpose-conv / pool forward op alone, and
  * the op's forward + backward (``torch.autograd.grad`` for dx AND dw),

so t_bwd = t_fwdbwd - t_fwd per op, against the JAX script's analytic
backward bound (a conv's dL/dx and dL/dw each cost the forward's FLOPs;
bytes: read the cotangent, x and w, write dx and dw; a pool's backward
moves twice its forward's bytes).  The BatchNorm rows time the train
step's BatchNorm + ReLU (``ops/bn_relu.py`` ``bn_relu_train``: float32
batch statistics, running statistics updated, cast back, the ReLU; its
kernels on the card), forward and forward + backward, against the bytes
of its 8 passes over the map (forward: read it for the statistics, read
it and write the output; backward: read the output's gradient and the
map for the sums, read both again and write the map's gradient), and
beside it the law it replaced (``models/unet.py`` ``_bn_train`` and
``torch.relu`` in plain PyTorch ops).  The pools take
``F.max_pool2d``'s autograd, as the training forward does (the kernels
have no backward, as the Pallas ones have no VJP).  The update row times the port's optimizer step
(``pipeline/engine.py`` ``make_optimizer``: ``torch.optim.SGD``,
momentum 0.95) over the flagship's 31 044 227 float32 parameters with
float32 gradients (read p, m, g, write p, m: 20 bytes a parameter).
The sum is held to the port's own full train step at the same batch
(``make_train_step``: augmentation, the K4 label chain, forward, loss,
backward, update), timed by CUDA events over ``--steps`` steps as
``chip_smoke.py`` phases 12-14 time it.

Timing: ``scripts/torch_timing_common.py``.

    python scripts/torch_roofline_bwd.py [--batch 8]
    python scripts/torch_roofline_bwd.py --device cpu --batch 2 --size 32 \\
        --depth 3 --start-filts 8 --steps 3

Prints the tables and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import (_randn, _sets, layer_specs,  # noqa: E402
                                    op_cost)

CLASS_WEIGHTS = (10.0, 300.0, 250.0)


def conv_fwd(x, w, b, kind):
    """One conv-family op with its bias, no relu (roofline_bwd.py
    ``conv_fwd``), in the port's layout."""
    if kind == "convT":
        y = F.conv_transpose2d(x, w, None, stride=2)
    else:
        y = F.conv2d(x, w, None, padding=w.shape[-1] // 2)
    return y + b.view(1, -1, 1, 1)


def conv_fwdbwd(kind, x, w, b, ct):
    """(y, dx, dw): the op and its cotangent ``ct`` pulled back to the
    input and the weight."""
    y = conv_fwd(x, w, b, kind)
    dx, dw = torch.autograd.grad(y, (x, w), ct)
    return y, dx, dw


def pool_fwdbwd(x, ct):
    y = F.max_pool2d(x, 2, 2)
    (dx,) = torch.autograd.grad(y, (x,), ct)
    return y, dx


def bn_relu(x, bn):
    """The train step's BatchNorm + ReLU (``bn_relu_train``: float32 batch
    statistics, running statistics updated in place, the output in
    ``x``'s dtype, the compute dtype)."""
    from crimac_unet_tpu_torch.ops.bn_relu import bn_relu_train
    return bn_relu_train(x, bn)


def bn_relu_law(x, bn):
    """The law ``bn_relu`` replaced: ``_bn_train`` and its relu as plain
    PyTorch ops, in ``x``'s dtype."""
    from crimac_unet_tpu_torch.models.unet import _bn_train
    return torch.relu(_bn_train(x, bn, x.dtype))


def bn_fwdbwd(x, bn, ct, fn=bn_relu):
    """(y, dx, dgamma, dbeta) of ``fn`` (``bn_relu`` or ``bn_relu_law``)."""
    y = fn(x, bn)
    dx, dg, db = torch.autograd.grad(y, (x, bn.weight, bn.bias), ct)
    return y, dx, dg, db


def sgd_update(opt):
    """The update row: one step of the port's optimizer (the gradients
    already in place)."""
    opt.step()


def train_config(batch, size=256, depth=5, start_filts=64,
                 compute_dtype="bfloat16"):
    """The reference recipe's step settings at ``batch``
    (``scripts/r3_tpu_session.py`` ``stage_train_decomp``)."""
    return {"patch_size": [size, size], "frequencies": common.FREQS,
            "lr": 0.005, "lr_step": 1000, "lr_reduction": 0.5,
            "momentum": 0.95, "depth": depth, "start_filts": start_filts,
            "compute_dtype": compute_dtype, "train_dtype": compute_dtype,
            "batch_size": batch, "loss_type": "CE"}


def train_model(cfg, device, seed=0):
    """The training model as ``SegPipeUNet`` builds it (float32 master
    parameters, contiguous, train mode) with torch's default
    initialisation from a seeded generator, and its optimizer state."""
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.pipeline import engine
    model = build_unet(dict(cfg, compute_dtype=cfg["train_dtype"]))
    state = engine.init_train_state(model, cfg,
                                    torch.Generator().manual_seed(seed))
    model.to(device)
    state.optimizer = engine.make_optimizer(model, cfg)
    return state


def step_inputs(batch, size, device, seed=0):
    """Raw sv crops (B, 4, H, W) float32 and raw label codes (B, H, W)
    int32 ({0, 27, 1}) for ``make_train_step``."""
    rng = np.random.RandomState(seed)
    data = (10.0 ** rng.uniform(-8, -2, (batch, 4, size, size))).astype(
        np.float32)
    labels = np.array([0, 27, 1], np.int32)[
        rng.choice(3, size=(batch, size, size))]
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(labels).to(device))


def time_step(state, cfg, data, labels, device, steps=50, warmup=5):
    """The port's full train step, ms a step by CUDA events over
    ``steps`` back-to-back steps with no host sync inside (phases 12-14's
    reading; host-paced where the host's enqueue is the slower), and the
    K4 launches per step."""
    import time

    from crimac_unet_tpu_torch.ops import cuda_lib
    from crimac_unet_tpu_torch.pipeline import engine
    step = engine.make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(5)
    for _ in range(warmup):
        step(state, data, labels, gen)
    tc.synchronize(device)
    k4 = cuda_lib.launches["binary_closing"]
    if tc.is_cuda(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step(state, data, labels, gen)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, data, labels, gen)
        ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, (cuda_lib.launches["binary_closing"] - k4) / steps


def run(device="cuda", batch=8, size=256, depth=5, start_filts=64,
        steps=50, n=10, log=print) -> dict:
    """Per-op forward and backward rows, the BatchNorm rows, the update
    row and the full step at ``batch``, bf16 as the recipe trains."""
    from crimac_unet_tpu_torch.utils.flops import unet_train_step_flops
    dev = common.device_of(device)
    compute_dtype, dtype = "bfloat16", torch.bfloat16
    el = torch.finfo(dtype).bits // 8
    peak = tc.peak_flops(dev)
    card = common.card_name(dev)
    floor_ms, floor_host = tc.launch_floor_ms(dev)
    B, H, W = batch, size, size
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"device: {card}; train-geometry roofline at batch {B}, {H}x{W}, "
        f"{compute_dtype} convs + float32 BN; peak {peak / 1e12:.1f} "
        f"TFLOP/s, HBM {tc.HBM_BYTES_PER_S / 1e9:.0f} GB/s; launch floor "
        f"{floor_ms:.4f} ms (host {floor_host:.4f} ms)")
    log(f"{'layer':<14} {'fwd bound':>9} {'fwd meas':>9} {'f-eff':>5} "
        f"{'bwd bound':>9} {'bwd meas':>9} {'b-eff':>5}  limit")
    rows, bn_rows = [], []

    def grad_leaf(t):
        return t.requires_grad_(True)

    for name, kind, b_, h, w, ci, co in layer_specs(B, H, W, depth,
                                                    start_filts):
        flops, byts = op_cost(kind, b_, h, w, ci, co, el)
        t_bf, lim = tc.bound_s(flops, byts, peak)
        if kind in ("conv3", "conv1", "convT"):
            k = {"conv3": 3, "conv1": 1, "convT": 2}[kind]
            oh, ow = (2 * h, 2 * w) if kind == "convT" else (h, w)
            wshape = (ci, co, k, k) if kind == "convT" else (co, ci, k, k)
            nset = tc.copies((b_ * h * w * ci + b_ * oh * ow * co
                              + k * k * ci * co) * el, dev)
            xs = _sets(nset, lambda: grad_leaf(_randn(
                (b_, ci, h, w), dtype, dev, gen, channels_last=True)))
            ws = _sets(nset, lambda: grad_leaf(_randn(wshape, dtype, dev,
                                                      gen, .05)))
            cts = _sets(nset, lambda: torch.ones(
                (b_, co, oh, ow), dtype=dtype, device=dev).contiguous(
                    memory_format=torch.channels_last))
            bias = _randn((co,), dtype, dev, gen, .05)
            fl_b = 2 * flops
            by_b = (b_ * oh * ow * co + 2 * b_ * h * w * ci
                    + 2 * k * k * ci * co) * el
            t_bb = tc.bound_s(fl_b, by_b, peak)[0]
            with torch.no_grad():
                t_f, h_f = tc.device_ms(lambda i: conv_fwd(
                    xs[i % nset], ws[i % nset], bias, kind), dev, n=n)
            t_fb, h_fb = tc.device_ms(lambda i: conv_fwdbwd(
                kind, xs[i % nset], ws[i % nset], bias, cts[i % nset]),
                dev, n=n)
            if kind != "conv1":
                # training convs also pay a BN + ReLU on the output: 3
                # passes over it forward, 5 backward
                t_pass = b_ * oh * ow * co * el / tc.HBM_BYTES_PER_S * 1e3
                bn = nn.BatchNorm2d(co).to(dev)
                nb = tc.copies(2 * b_ * oh * ow * co * el, dev)
                xo = _sets(nb, lambda: grad_leaf(_randn(
                    (b_, co, oh, ow), dtype, dev, gen, channels_last=True)))
                row = dict(layer=name, bound_pass_ms=t_pass,
                           fwd_bound_ms=3 * t_pass, bwd_bound_ms=5 * t_pass)
                for pre, fn in (("", bn_relu), ("law_", bn_relu_law)):
                    with torch.no_grad():
                        t_bn_f, _ = tc.device_ms(lambda i: fn(
                            xo[i % nb], bn), dev, n=n)
                    t_bn_fb, _ = tc.device_ms(lambda i: bn_fwdbwd(
                        xo[i % nb], bn, cts[0], fn), dev, n=n)
                    row.update({pre + "fwd_ms": t_bn_f,
                                pre + "fwdbwd_ms": t_bn_fb,
                                pre + "bwd_ms": max(t_bn_fb - t_bn_f, 0.0)})
                bn_rows.append(row)
        elif kind == "pool":
            fl_b, by_b = 0, 2 * byts   # read y-grad + x, write dx
            t_bb = by_b / tc.HBM_BYTES_PER_S
            nset = tc.copies(b_ * h * w * ci * el, dev)
            xs = _sets(nset, lambda: grad_leaf(_randn(
                (b_, ci, h, w), dtype, dev, gen, channels_last=True)))
            ct = torch.ones((b_, ci, h // 2, w // 2), dtype=dtype,
                            device=dev).contiguous(
                                memory_format=torch.channels_last)
            with torch.no_grad():
                t_f, h_f = tc.device_ms(lambda i: F.max_pool2d(
                    xs[i % nset], 2, 2), dev, n=n)
            t_fb, h_fb = tc.device_ms(lambda i: pool_fwdbwd(
                xs[i % nset], ct), dev, n=n)
        else:   # concat: its backward is two slices; not timed
            continue
        t_b = max(t_fb - t_f, 0.0)
        row = dict(layer=name, kind=kind, fwd_ms=t_f, fwdbwd_ms=t_fb,
                   bwd_ms=t_b, fwd_host_ms=h_f, fwdbwd_host_ms=h_fb,
                   fwd_bound_ms=t_bf * 1e3, bwd_bound_ms=t_bb * 1e3,
                   fwd_gflop=flops / 1e9, bwd_gflop=fl_b / 1e9,
                   limit=tc.limit_of(t_f, floor_ms, lim))
        rows.append(row)
        log(f"{name:<14} {t_bf * 1e3:8.4f}m {t_f:8.4f}m "
            f"{t_bf * 1e3 / max(t_f, 1e-9):5.0%} {t_bb * 1e3:8.4f}m "
            f"{t_b:8.4f}m {t_bb * 1e3 / max(t_b, 1e-9):5.0%}  {row['limit']}")

    log("\n-- BN + ReLU train-mode rows (float32 statistics): bn_relu_train"
        " | the plain-op law --")
    for r in bn_rows:
        log(f"{r['layer']:<14} fwd {r['fwd_ms']:8.4f}m "
            f"({r['fwd_bound_ms'] / max(r['fwd_ms'], 1e-9):4.0%}) bwd "
            f"{r['bwd_ms']:8.4f}m "
            f"({r['bwd_bound_ms'] / max(r['bwd_ms'], 1e-9):4.0%}) | law fwd "
            f"{r['law_fwd_ms']:8.4f}m bwd {r['law_bwd_ms']:8.4f}m (bound "
            f"fwd {r['fwd_bound_ms']:7.4f}m, bwd {r['bwd_bound_ms']:7.4f}m)")

    cfg = train_config(B, size, depth, start_filts, compute_dtype)
    state = train_model(cfg, dev)
    params = [p for p in state.model.parameters()]
    n_params = sum(p.numel() for p in params)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
    sgd_update(state.optimizer)      # creates the momentum buffers
    upd_by = n_params * (4 * 4 + 4)
    t_upd_bound = upd_by / tc.HBM_BYTES_PER_S
    t_upd, _ = tc.device_ms(lambda i: sgd_update(state.optimizer), dev, n=n)
    log(f"\nSGD-momentum update ({n_params} params): {t_upd:.4f} ms (HBM "
        f"bound {t_upd_bound * 1e3:.4f} ms)")

    sum_f = sum(r["fwd_ms"] for r in rows)
    sum_b = sum(r["bwd_ms"] for r in rows)
    sum_bn = sum(r["fwd_ms"] + r["bwd_ms"] for r in bn_rows)
    total = sum_f + sum_b + sum_bn + t_upd
    bound = (sum(r["fwd_bound_ms"] + r["bwd_bound_ms"] for r in rows)
             + sum(r["fwd_bound_ms"] + r["bwd_bound_ms"] for r in bn_rows)
             + t_upd_bound * 1e3)
    step_flops = B * unet_train_step_flops(H, W, depth=depth,
                                           start_filts=start_filts)
    data, labels = step_inputs(B, size, dev)
    step_ms, k4 = time_step(train_model(cfg, dev), cfg, data, labels, dev,
                            steps)
    log(f"\nSUM per-op: fwd {sum_f:.4f} + bwd {sum_b:.4f} + BN {sum_bn:.4f}"
        f" + sgd {t_upd:.4f} = {total:.4f} ms")
    log(f"roofline floor (same decomposition): {bound:.4f} ms -> max train "
        f"MFU {step_flops / max(bound * 1e-3, 1e-12) / peak:.1%}")
    log(f"analytic step FLOPs {step_flops / 1e12:.3f} T -> per-op-sum MFU "
        f"{step_flops / max(total * 1e-3, 1e-12) / peak:.1%}; the port's "
        f"full step {step_ms:.4f} ms by CUDA events over {steps} steps "
        f"(MFU {step_flops / max(step_ms * 1e-3, 1e-12) / peak:.1%}, K4 "
        f"{k4:g} a step), residual {step_ms - total:.4f} ms")
    return {"device": card, "batch": B, "size": size, "depth": depth,
            "start_filts": start_filts, "compute_dtype": compute_dtype,
            "peak_flops": peak, "hbm_bytes_per_s": tc.HBM_BYTES_PER_S,
            "launch_floor_ms": floor_ms, "launch_floor_host_ms": floor_host,
            "layers": rows, "bn_rows": bn_rows, "n_params": n_params,
            "update_ms": t_upd, "update_bound_ms": t_upd_bound * 1e3,
            "sum_fwd_ms": sum_f, "sum_bwd_ms": sum_b, "sum_bn_ms": sum_bn,
            "sum_ms": total, "bound_floor_ms": bound,
            "step_flops": step_flops,
            "max_train_mfu": step_flops / max(bound * 1e-3, 1e-12) / peak,
            "sum_mfu": step_flops / max(total * 1e-3, 1e-12) / peak,
            "step_ms": step_ms, "step_steps": steps,
            "step_mfu": step_flops / max(step_ms * 1e-3, 1e-12) / peak,
            "step_k4_launches": k4}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-filts", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50,
                    help="full train steps timed by CUDA events")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.batch, args.size, args.depth,
                      args.start_filts, steps=args.steps), args.out)


if __name__ == "__main__":
    main()
