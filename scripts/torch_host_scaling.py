"""Host-assembly scaling of the prediction pipeline, measured: the port's
counterpart of ``scripts/host_scaling.py``.

The JAX script ran on a one-core host and could only project a linear
multi-core curve.  The card's host has several cores, so this measures:

1. CPU-seconds per chunk of every host component of each transfer
   preset (``torch_host_slab_profile.py``'s components, each output held
   to the pipeline's chunk 0): float32 transfer, bfloat16 (the default)
   and uint8 (the serving preset), with pings/s per core and the linear
   projection the JAX script printed;
2. the decoder's thread fan-out: ``CRIMAC_CHUNKIO_THREADS``
   (``data/blosc_codec.py``) at 1, 2, 4, 8 and the cores this process may
   use, the slab held identical at every count.  The variable reaches only
   the native decoder (``chunkio``); with another backend the curve is
   that codec's own (``zarrlite``'s zlib thread pool) and the fan-out row
   is reported as not measured;
3. concurrent chunk assemblies (what the pipeline's prefetch threads do):
   k threads each building whole chunks' host inputs (the slab at the
   default transfer, the label slice, both write-mask planes) for k = 1,
   2, 4, 8 and the cores, pings/s measured beside k x the one-thread rate,
   every slab identical to the one-thread one.

    python scripts/torch_host_scaling.py
    python scripts/torch_host_scaling.py --device cpu --pings 1000 \\
        --depth 3 --start-filts 8 --patch 64 --overlap 10

Prints the tables and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_host_slab_profile as slab_profile  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import seeded_state_dict  # noqa: E402

THREADS_ENV = "CRIMAC_CHUNKIO_THREADS"
SHARED = ("label_slice", "packbits_isfinite", "packbits_zero",
          "h2d_pinned", "zarr_compress")


def cores() -> int:
    return len(os.sched_getaffinity(0))


def counts() -> list:
    return sorted({1, 2, 4, 8, cores()})


def preset_parts(components: dict) -> dict:
    """Each transfer preset's host components (per chunk)."""
    bf16_fill = (["fill_bf16_bits"] if "fill_bf16_bits" in components
                 else ["fill_f32", "bf16_cast"])
    return {"float32": ["fill_f32", *SHARED],
            "bfloat16": [*bf16_fill, *SHARED],
            "uint8": ["fill_f32", "u8_quantize", *SHARED]}


def assemble(reader, cfg, c, bits: bool) -> np.ndarray:
    """One chunk's host inputs at the default transfer, as ``prepare``
    builds them; returns the slab (the label work's outputs are
    dropped)."""
    from crimac_unet_tpu_torch.pipeline.infer_common import _fill_hwc_slab
    g = c.g
    freqs = sorted(cfg["frequencies"])
    slab = np.zeros((g.Hs, g.Wp, len(freqs)),
                    np.uint16 if bits else np.float32)
    _fill_hwc_slab(reader, freqs, slab, g.slab_x0, g.slab_x1, g.slab_y1,
                   c.o, g.x_off)
    lab = reader.get_label_slice(c.s, c.w, 0, g.row_cut)
    fin = np.zeros((g.nr, g.C * c.sw), bool)
    zero = np.zeros((g.nr, g.C * c.sw), bool)
    fin[:g.row_cut, :c.w] = np.isfinite(lab).T
    zero[:g.row_cut, :c.w] = (lab == 0).T
    np.packbits(fin, axis=1)
    np.packbits(zero, axis=1)
    if not bits:
        import torch
        return torch.from_numpy(slab).to(torch.bfloat16).view(
            torch.uint16).numpy()
    return slab


def decoder_threads(reader, cfg, c, reps=3) -> dict:
    """fill_f32 wall and CPU at each decoder thread count; the slab
    identical to the default count's."""
    from crimac_unet_tpu_torch.pipeline.infer_common import _fill_hwc_slab
    g = c.g
    freqs = sorted(cfg["frequencies"])

    def fill():
        slab = np.zeros((g.Hs, g.Wp, len(freqs)), np.float32)
        _fill_hwc_slab(reader, freqs, slab, g.slab_x0, g.slab_x1, g.slab_y1,
                       c.o, g.x_off)
        return slab
    ref = fill()
    old = os.environ.get(THREADS_ENV)
    rows = {}
    try:
        for nt in counts():
            os.environ[THREADS_ENV] = str(nt)
            w, cpu, out = slab_profile.best_of(fill, reps)
            rows[nt] = {"wall_ms": w * 1e3, "cpu_ms": cpu * 1e3,
                        "slab_equal": out.tobytes() == ref.tobytes()}
    finally:
        if old is None:
            os.environ.pop(THREADS_ENV, None)
        else:
            os.environ[THREADS_ENV] = old
    return rows


def concurrent_assemblies(reader, cfg, preload=1000, per_thread=2,
                          reps=2) -> dict:
    """k threads assembling ``per_thread`` chunks each (chunks taken in
    turn over the survey): pings/s and every slab against the one-thread
    slab of the same chunk."""
    from crimac_unet_tpu_torch.data import blosc_codec
    bits = blosc_codec.scatter_available()
    first = slab_profile.chunk_at(reader, cfg, 0, preload)
    chunks = [first] + [slab_profile.chunk_at(reader, cfg, i, preload)
                        for i in range(1, first.n_chunks)]
    ref = [assemble(reader, cfg, c, bits).tobytes() for c in chunks]
    rows = {}
    for k in counts():
        jobs = [i % len(chunks) for i in range(k * per_thread)]
        best, equal = float("inf"), True
        for _ in range(reps):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=k) as ex:
                outs = list(ex.map(lambda i: assemble(reader, cfg,
                                                      chunks[i], bits),
                                   jobs))
            best = min(best, time.perf_counter() - t0)
            equal &= all(o.tobytes() == ref[i] for o, i in zip(outs, jobs))
        pings = sum(chunks[i].w for i in jobs)
        rows[k] = {"wall_ms": best * 1e3, "pings_per_sec": pings / best,
                   "slab_equal": bool(equal)}
    one = rows[1]["pings_per_sec"]
    for k, r in rows.items():
        r["linear_projection"] = k * one
    return rows


def run(device="cuda", survey=None, model=None, ckpt=None, work=None,
        reps=3, preload=1000, log=print) -> dict:
    from crimac_unet_tpu_torch.data import blosc_codec
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = common.state_dict(ckpt) if ckpt is not None \
        else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    work = Path(work or common.WORK)
    work.mkdir(parents=True, exist_ok=True)
    rows, equal, ctx, c = slab_profile.profile(sd, cfg, reader, dev, work,
                                               reps, preload)
    backend = blosc_codec.backend()
    res = {"device": common.card_name(dev), "cores": cores(),
           "codec_backend": backend, "components": rows, "equal": equal,
           "chunk_pings": c.w, **{k: ctx[k] for k in ("store_compressor",
                                                     "slab_shape")}}
    log(f"host scaling on {cores()} cores (codec backend {backend}; store "
        f"compressor {ctx['store_compressor']}); components of chunk "
        f"{ctx['chunk']} (wall / CPU ms, equal to the pipeline's chunk 0):")
    for name, r in rows.items():
        log(f"  {name:<18} {r['wall_ms']:9.3f} / {r['cpu_ms']:9.3f}  "
            f"{equal.get(name)}")
    res["presets"] = {}
    log(f"per-preset host CPU per {c.w}-ping chunk -> pings/s per core; "
        f"LINEAR projection:")
    for name, parts in preset_parts(rows).items():
        cpu_s = sum(rows[p]["cpu_ms"] for p in parts) / 1e3
        per_core = c.w / max(cpu_s, 1e-12)
        proj = {n: n * per_core for n in sorted({1, 2, 4, 8, 16, cores()})}
        res["presets"][name] = {"parts": parts, "cpu_s_per_chunk": cpu_s,
                                "pings_per_sec_per_core": per_core,
                                "linear_projection": proj}
        log(f"  {name:<9} {cpu_s * 1e3:9.1f} ms CPU/chunk -> {per_core:9.1f}"
            f" pings/s/core; x{cores()} cores <= {proj[cores()]:.1f}")
    res["decoder_threads"] = decoder_threads(reader, cfg, c, reps)
    res["fanout_measured"] = backend == "chunkio"
    log(f"decoder threads ({THREADS_ENV}), fill_f32 wall / CPU ms, slab "
        f"identical:" + ("" if res["fanout_measured"] else
                         f" [backend {backend}: the variable reaches only "
                         f"the native decoder, so this is the {backend} "
                         f"codec's own curve and the fan-out row is not "
                         f"measured]"))
    for nt, r in res["decoder_threads"].items():
        log(f"  threads={nt:<3} {r['wall_ms']:9.3f} / {r['cpu_ms']:9.3f}  "
            f"{r['slab_equal']}")
    res["concurrent"] = concurrent_assemblies(reader, cfg, preload)
    log("concurrent chunk assemblies (default transfer): k threads -> "
        "measured pings/s vs k x one thread, slabs identical:")
    for k, r in res["concurrent"].items():
        log(f"  k={k:<3} {r['pings_per_sec']:10.1f} vs "
            f"{r['linear_projection']:10.1f}  {r['slab_equal']}")
    return res


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    ap.add_argument("--reps", type=int, default=3)
    tc.add_model_flags(ap)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.device, sv, tc.model_from(args), args.ckpt,
                      args.work, args.reps), args.out)


if __name__ == "__main__":
    main()
