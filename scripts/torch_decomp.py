"""Predict-chunk and train-step decompositions on the card: the port's
counterpart of ``scripts/r3_tpu_session.py`` ``stage_decomp`` and
``stage_train_decomp``.

``predict``: the first chunk's staged arguments of
``GriddedRunner._predict_patches`` are captured off ``predict_reader``
on the bench survey (1000 range x 4000 pings x 4 frequencies, seed 3;
flagship U-Net, seeded weights, bf16, patch 256 / overlap 20, fwd_batch
32).  Then three things are timed on them: the full chunk (K1 once and
K3 once per forward sub-batch, softmax, stitch), the forward alone at
the padded batch, and K1 alone; the full chunk's output is held bit for
bit to what ``predict_reader`` computed for the chunk, and K1's to its
plain version.  Reported with the JAX stage's keys.

``train``, at batch 4 and 8 (the reference recipe's settings, bf16
compute, float32 master parameters): forward + loss, forward + backward
(value and gradient), the full step (``make_train_step``: augmentation,
the K4 label chain, forward, loss, backward, SGD) and the forward + loss
with eval-mode BatchNorm (running statistics; its level-0 pool is K2).
Each as device time (CUDA events, the call queued behind a device-side
sleep), host enqueue wall, wall with the sync, and the device kernels a
call launches with their summed time (``torch.profiler``).

    python scripts/torch_decomp.py [predict|train|both] [--batches 4,8]
    python scripts/torch_decomp.py both --device cpu --pings 1000 \\
        --depth 3 --start-filts 8 --size 64 --batches 2

Prints the tables and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import _equal_nan, seeded_state_dict  # noqa: E402
from scripts.torch_roofline_bwd import (CLASS_WEIGHTS, step_inputs,  # noqa: E402
                                        train_config, train_model)


def capture_first_chunk(runner, reader, preload_n_pings=1000):
    """(args, kwargs, output) of the first ``_predict_patches`` call of a
    ``predict_reader`` pass (the pass stops after its first chunk)."""
    from crimac_unet_tpu_torch.pipeline.predict import predict_reader
    staged = {}
    real = runner._predict_patches

    def capture(*args, **kw):
        out = real(*args, **kw)
        if "args" not in staged:
            staged.update(args=args, kw=kw, out=out.clone())
        return out

    runner._predict_patches = capture
    try:
        chunks = predict_reader(runner, reader, preload_n_pings)
        next(chunks)
        chunks.close()
    finally:
        del runner._predict_patches
    return staged["args"], staged["kw"], staged["out"]


def run_predict(device="cuda", survey=None, model=None, state_dict=None,
                preload_n_pings=1000, n=4, log=print) -> dict:
    """The predict-chunk decomposition (``stage_decomp``'s keys)."""
    from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                     gather_db_reference)
    from crimac_unet_tpu_torch.utils import flops as F
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = state_dict if state_dict is not None else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    runner = common.make_runner(sd, cfg, dev)
    args, kw, want = capture_first_chunk(runner, reader, preload_n_pings)
    data_slab, y0p, x0p, N, border = args[:5]
    B, Np, nb = runner._sub_batch_shape(N)
    real = runner._predict_patches

    # the full chunk: K1 and K3 once per sub-batch, bit-equal to the pass
    f0 = runner.forwards
    got, launches = tc.launches_of(lambda: real(*args, **kw), dev)
    launches["forwards"] = runner.forwards - f0
    full_equal = _equal_nan(got, want)

    def k1(slab, k=0):
        return gather_db(slab, y0p[k * B:(k + 1) * B],
                         x0p[k * B:(k + 1) * B], runner.window,
                         border=border, scaled=runner.use_meta,
                         out_dtype=runner.model.dtype)

    k1_equal = _equal_nan(k1(data_slab), gather_db_reference(
        data_slab, y0p[:B], x0p[:B], runner.window, border=border,
        scaled=runner.use_meta, out_dtype=runner.model.dtype))
    xs = [k1(data_slab, k) for k in range(nb)]
    slabs = [data_slab] + [data_slab.clone() for _ in range(
        tc.copies(data_slab.numel() * data_slab.element_size(), dev) - 1)]

    t_full, h_full = tc.device_ms(lambda i: real(*args, **kw), dev, n=n)

    def fwd_only(i):
        for x in xs:
            runner.model(x)
    t_fwd, h_fwd = tc.device_ms(fwd_only, dev, n=n)
    t_k1, h_k1 = tc.device_ms(lambda i: k1(slabs[i % len(slabs)]), dev,
                              n=10 * n)
    wh, ww = runner.window
    fwd_flops = F.unet_forward_flops(wh, ww, in_channels=4,
                                     depth=cfg["depth"],
                                     start_filts=cfg["start_filts"])

    def mfu(fl, ms):
        return F.mfu(fl, ms * 1e-3, dev)
    res = {
        "n_useful_patches": int(N), "padded_to": int(nb * B),
        "sub_batches": int(nb), "sub_batch": int(B),
        "full_chunk_ms": t_full, "full_chunk_host_ms": h_full,
        "fwd_only_padded_ms": t_fwd, "fwd_only_host_ms": h_fwd,
        "k1_ms": t_k1, "k1_host_ms": h_k1,
        "overhead_ms": t_full - t_fwd,
        "mfu_useful_full": mfu(N * fwd_flops, t_full),
        "mfu_padded_fwd": mfu(nb * B * fwd_flops, t_fwd),
        "mfu_useful_fwd": mfu(N * fwd_flops, t_fwd),
        "full_equal": bool(full_equal), "k1_equal": bool(k1_equal),
        "launches": launches, "slab_shape": list(data_slab.shape),
        "slab_dtype": str(data_slab.dtype).split(".")[-1]}
    log(f"predict decomposition, first chunk of {reader.name}: {N} useful "
        f"patches in {nb} sub-batch(es) of {B}, slab "
        f"{tuple(data_slab.shape)} {res['slab_dtype']}")
    log(f"  full chunk {t_full:.4f} ms (host enqueue {h_full:.4f}), forward "
        f"alone at the padded batch {t_fwd:.4f} ms (host {h_fwd:.4f}), K1 "
        f"alone {t_k1:.4f} ms (host {h_k1:.4f}); overhead "
        f"{res['overhead_ms']:.4f} ms; MFU useful/full "
        f"{tc.fmt(res['mfu_useful_full'], '.2%')}, padded/fwd "
        f"{tc.fmt(res['mfu_padded_fwd'], '.2%')}, useful/fwd "
        f"{tc.fmt(res['mfu_useful_fwd'], '.2%')}")
    log(f"  full chunk bit-equal to predict_reader's: {full_equal}; K1 "
        f"bit-equal to its plain version: {k1_equal}; launches {launches}")
    return res


def train_inputs(batch, size, seed=0):
    """The JAX stage's step inputs: (B, H, W, 4) float32 N(0, 1) and
    (B, H, W) int32 classes {0, 1, 2} from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, 4).astype(np.float32)
    return x, rng.choice([0, 1, 2], size=(batch, size, size)).astype(
        np.int32)


def run_train(device="cuda", batches=(4, 8), size=256, depth=5,
              start_filts=64, compute_dtype="bfloat16", reps=3,
              log=print) -> dict:
    """The train-step decomposition (``stage_train_decomp``'s keys, plus
    host enqueue, wall, kernels and K2 / K4 launches a call)."""
    from crimac_unet_tpu_torch.pipeline import engine
    from crimac_unet_tpu_torch.utils import flops as F
    dev = common.device_of(device)
    res = {}
    for batch in batches:
        cfg = train_config(batch, size, depth, start_filts, compute_dtype)
        state = train_model(cfg, dev)
        model = state.model
        x, y = (torch.from_numpy(a).to(dev)
                for a in train_inputs(batch, size))
        data, labels = step_inputs(batch, size, dev)
        step = engine.make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(5)

        def loss_of(logits):
            return engine.weighted_ce_loss(logits, y, CLASS_WEIGHTS)

        def fwd():
            model.train()
            with torch.no_grad():
                return loss_of(model(x))

        def grad():
            model.train()
            model.zero_grad(set_to_none=True)
            loss = loss_of(model(x))
            loss.backward()
            return loss

        def full():
            return step(state, data, labels, gen)

        def fwd_evalbn():
            model.eval()
            loss = loss_of(model(x))
            model.train()
            return loss

        # the losses before any train-mode call moves the running stats
        losses = {"fwd_evalbn": float(fwd_evalbn()), "fwd": float(fwd()),
                  "grad": float(grad().detach())}
        calls = {"fwd": fwd, "grad": grad, "full_step": full,
                 "fwd_evalbn": fwd_evalbn}
        r = {"losses": losses}
        for name, fn in calls.items():
            _, counts = tc.launches_of(fn, dev)
            ms, host = tc.device_ms(lambda i: fn(), dev, n=1, reps=reps)
            kernels, kernel_ms = tc.profile_kernels(fn, dev, calls=2)
            r[name] = {"device_ms": ms, "host_enqueue_ms": host,
                       "wall_ms": tc.median_ms(fn, dev, reps),
                       "kernels": kernels, "kernel_ms": kernel_ms,
                       "launches": counts}
        fwd_flops = batch * F.unet_forward_flops(
            size, size, in_channels=4, depth=depth, start_filts=start_filts)

        def mfu(fl, ms):
            return F.mfu(fl, ms * 1e-3, dev)
        t_f, t_g = r["fwd"]["device_ms"], r["grad"]["device_ms"]
        t_fe = r["fwd_evalbn"]["device_ms"]
        r.update(fwd_ms=t_f, fwd_evalbn_ms=t_fe, grad_ms=t_g,
                 full_step_ms=r["full_step"]["device_ms"],
                 bwd_over_fwd=(t_g - t_f) / max(t_f, 1e-9),
                 fwd_mfu=mfu(fwd_flops, t_f),
                 fwd_evalbn_mfu=mfu(fwd_flops, t_fe),
                 grad_mfu_3x=mfu(3 * fwd_flops, t_g))
        res[f"b{batch}"] = r
        log(f"train decomposition, batch {batch} ({compute_dtype}): loss "
            f"{losses['fwd']:.6f} (eval BN {losses['fwd_evalbn']:.6f})")
        log(f"  {'call':<11} {'device':>9} {'enqueue':>9} {'wall':>9} "
            f"{'kernels':>8} {'kern ms':>9}  launches")
        for name in calls:
            c = r[name]
            log(f"  {name:<11} {c['device_ms']:8.4f}m "
                f"{c['host_enqueue_ms']:8.4f}m {c['wall_ms']:8.4f}m "
                f"{tc.fmt(c['kernels'], '8.1f')} "
                f"{tc.fmt(c['kernel_ms'], '8.4f')}m  "
                f"{ {k: v for k, v in c['launches'].items() if v} }")
        log(f"  bwd/fwd {r['bwd_over_fwd']:.2f}; MFU fwd "
            f"{tc.fmt(r['fwd_mfu'], '.2%')}, eval-BN fwd "
            f"{tc.fmt(r['fwd_evalbn_mfu'], '.2%')}, grad (3x fwd FLOPs) "
            f"{tc.fmt(r['grad_mfu_3x'], '.2%')}")
    return res


def run(device="cuda", survey=None, model=None, batches=(4, 8), size=256,
        parts=("predict", "train"), ckpt=None, log=print) -> dict:
    """Both decompositions (or those in ``parts``); ``ckpt`` the predict
    weights (default seeded), ``model`` overrides the flagship."""
    m = common.model_config(model)
    res = {"device": common.card_name(common.device_of(device))}
    if "predict" in parts:
        res["predict"] = run_predict(
            device, survey, model,
            None if ckpt is None else common.state_dict(ckpt), log=log)
    if "train" in parts:
        res["train"] = run_train(device, batches, size, m["depth"],
                                 m["start_filts"], m["compute_dtype"],
                                 log=log)
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    ap.add_argument("part", nargs="?", default="both",
                    choices=("predict", "train", "both"))
    ap.add_argument("--batches", default="4,8")
    ap.add_argument("--size", type=int, default=256,
                    help="train crop size")
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-filts", type=int, default=64)
    args = ap.parse_args(argv)
    model = {"depth": args.depth, "start_filts": args.start_filts,
             "patch_size": [args.size, args.size]}
    parts = ("predict", "train") if args.part == "both" else (args.part,)
    sv = common.bench_survey(args.work, W=args.pings) \
        if "predict" in parts else None
    common.finish(run(args.device, sv, model,
                      tuple(int(b) for b in args.batches.split(",")),
                      args.size, parts, args.ckpt), args.out)


if __name__ == "__main__":
    main()
