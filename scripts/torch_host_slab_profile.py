"""Component breakdown of the prediction pipeline's host work for one
chunk: the port's counterpart of ``scripts/host_slab_profile.py``.

Each component of ``pipeline/predict.py``'s ``prepare`` and writer is
timed alone on the bench survey's first 1000-ping chunk (1000 range x
4000 pings x 4 frequencies, seed 3; patch 256 / overlap 20):

* ``fill_f32``: ``infer_common._fill_hwc_slab``, the zarr decode and
  scatter into the float32 HWC slab (the float32 and uint8 presets);
* ``fill_bf16_bits``: the same read through the codec's converting
  decode into bfloat16 bits (the bfloat16 preset, where the native
  decoder is present; else not measured);
* ``label_slice``: ``get_label_slice`` of the chunk;
* ``packbits_isfinite`` / ``packbits_zero``: the two write-mask planes;
* ``bf16_cast``: the float32 -> bfloat16 host cast
  (``predict.py``'s ``torch.from_numpy(slab).to(torch.bfloat16)``);
* ``u8_quantize``: ``infer_common._quantize_db_u8`` (the serving
  preset's host dB + uint8 codes);
* ``h2d_pinned``: ``predict._to_device`` of the chunk's set (pinned,
  side stream) to the end of the copy;
* ``zarr_compress``: the prediction store's chunk encode (Blosc zstd-3
  bit-shuffle, or zlib without a Blosc backend) of the store's first
  chunk of each category plane.

Every component's output is held to what the pipeline itself builds for
chunk 0 (captured off ``_to_device`` during ``predict_reader`` passes at
each transfer dtype, and the chunk file the writer wrote), bit for bit.
Which codec backend decoded is printed (``blosc_codec.backend``).

    python scripts/torch_host_slab_profile.py
    python scripts/torch_host_slab_profile.py --device cpu --pings 1000 \\
        --depth 3 --start-filts 8 --patch 64 --overlap 10

Prints the table and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import shutil
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402
from scripts.torch_roofline import seeded_state_dict  # noqa: E402

TRANSFERS = ("float32", "bfloat16", "uint8")
CPU_WINDOW_S = 0.5     # wall over which a component's CPU time is read


def best_of(fn, reps=5, device=None, cpu_window_s=None):
    """(best wall s, CPU s of this process a call, output): the wall is
    the best of ``reps`` calls (the device drained after each where
    given); the CPU time is ``time.process_time`` over enough calls to
    fill ``cpu_window_s`` of wall, since that clock can tick as coarsely
    as 10 ms."""
    import math
    cpu_window_s = CPU_WINDOW_S if cpu_window_s is None else cpu_window_s
    best_w = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if device is not None:
            tc.synchronize(device)
        best_w = min(best_w, time.perf_counter() - t0)
    n = int(min(2000, max(reps, math.ceil(cpu_window_s / max(best_w,
                                                             1e-6)))))
    c0 = time.process_time()
    for _ in range(n):
        fn()
        if device is not None:
            tc.synchronize(device)
    return best_w, (time.process_time() - c0) / n, out


def chunk_at(reader, cfg, index=0, preload=1000):
    """Chunk ``index``'s geometry and extent as ``prepare`` builds them
    (patch mode, no static grid)."""
    from crimac_unet_tpu_torch.pipeline.predict import chunk_geometry
    from crimac_unet_tpu_torch.utils.preload_split import get_data_split
    n_pings, n_range = reader.shape
    o = int(cfg["patch_overlap"])
    seabed = np.asarray(reader.get_seabed(0, n_pings)).astype(np.int64)
    known = np.asarray(reader.seabed_known(0, n_pings))
    splits = get_data_split([[0, n_pings]], preload)
    s, e = (int(v) for v in splits[index])
    g = chunk_geometry(tuple(cfg["patch_size"]), o, n_range, n_pings,
                       seabed, known, s, e, True, None)
    sw = cfg["patch_size"][1] - 2 * o
    return types.SimpleNamespace(g=g, s=s, e=e, w=e - s, o=o, sw=sw,
                                 n_range=n_range, seabed=seabed,
                                 known=known, n_chunks=len(splits))


def capture_pipeline(sd, cfg, reader, device, work, preload=1000) -> dict:
    """What the pipeline builds for chunk 0 at each transfer dtype: the
    host dict ``_to_device`` received for the chunk whose slab starts at
    survey column 0 (two prefetch threads stage chunks in either order),
    off ``predict_reader`` stopped after its first chunk; for bfloat16 a
    whole ``save_survey_predictions_zarr`` pass whose store holds chunk
    0's written planes."""
    import threading

    from crimac_unet_tpu_torch.pipeline import predict as P
    real_put, real_fill = P._to_device, P._fill_hwc_slab
    local = threading.local()
    out = {}
    for td in TRANSFERS:
        seen = {}

        def fill(reader_, freqs, slab, slab_x0, *a):
            local.x0 = slab_x0
            return real_fill(reader_, freqs, slab, slab_x0, *a)

        def put(runner, host, stream):
            seen.setdefault(local.x0, {
                k: (v.clone() if torch.is_tensor(v) else np.array(v))
                for k, v in host.items()})
            return real_put(runner, host, stream)

        runner = common.make_runner(sd, dict(cfg, transfer_dtype=td), device)
        P._to_device, P._fill_hwc_slab = put, fill
        try:
            if td == "bfloat16":
                store = Path(work) / "host_profile_pred.zarr"
                shutil.rmtree(store, ignore_errors=True)
                P.save_survey_predictions_zarr(runner, reader, str(store),
                                               preload_n_pings=preload)
                out["store"] = store
            else:
                chunks = P.predict_reader(runner, reader, preload)
                next(chunks)
                chunks.close()
        finally:
            P._to_device, P._fill_hwc_slab = real_put, real_fill
        out[td] = seen[min(seen)]
    return out


def inline_u8_formula(slab):
    """``scripts/host_scaling.py``'s inline "u8 dB quantize" (truncating
    cast, no scrub of non-finite sv)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.clip((10 * np.log10(slab + 1e-10) + 75) * (255 / 75), 0,
                       255).astype(np.uint8)


def _slab_bytes(t) -> bytes:
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
            ).numpy().tobytes()


def components(reader, cfg, c, device, store=None) -> dict:
    """name -> zero-argument function returning the component's output,
    in pipeline order (``fill_bf16_bits`` only where the native decoder
    serves the converting read)."""
    from crimac_unet_tpu_torch.data import blosc_codec
    from crimac_unet_tpu_torch.data.zarrlite import ZArray, _Codec
    from crimac_unet_tpu_torch.ops.label_ops import BIG_ROW
    from crimac_unet_tpu_torch.pipeline import predict as P
    from crimac_unet_tpu_torch.pipeline.infer_common import (
        _fill_hwc_slab, _quantize_db_u8)
    g, freqs = c.g, sorted(cfg["frequencies"])
    slab = np.zeros((g.Hs, g.Wp, len(freqs)), np.float32)

    def fill(dst):
        _fill_hwc_slab(reader, freqs, dst, g.slab_x0, g.slab_x1, g.slab_y1,
                       c.o, g.x_off)
        return dst
    fill(slab)
    lab = reader.get_label_slice(c.s, c.w, 0, g.row_cut)
    fin = np.zeros((g.nr, g.C * c.sw), bool)
    zero = np.zeros((g.nr, g.C * c.sw), bool)
    fin[:g.row_cut, :c.w] = np.isfinite(lab).T
    zero[:g.row_cut, :c.w] = (lab == 0).T
    sb_vec = np.full(g.C * c.sw, BIG_ROW, np.int64)
    sb_vec[:c.w] = np.where(c.known[c.s:c.e], c.seabed[c.s:c.e], BIG_ROW)
    host_set = dict(
        data_slab=torch.from_numpy(slab).to(torch.bfloat16),
        lab_bits=np.stack([np.packbits(fin, axis=1),
                           np.packbits(zero, axis=1)]),
        sb_row=np.append(sb_vec, np.int64(g.row_cut)))
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    runner = types.SimpleNamespace(device=dev)

    def h2d():
        staged = P._to_device(runner, host_set, stream)
        if staged.event is not None:
            staged.event.synchronize()
        return staged.tensors

    comps = {"fill_f32": lambda: fill(np.zeros_like(slab))}
    if blosc_codec.scatter_available():
        comps["fill_bf16_bits"] = lambda: fill(np.zeros(slab.shape,
                                                        np.uint16))
    comps.update(
        label_slice=lambda: reader.get_label_slice(c.s, c.w, 0, g.row_cut),
        packbits_isfinite=lambda: np.packbits(fin, axis=1),
        packbits_zero=lambda: np.packbits(zero, axis=1),
        bf16_cast=lambda: torch.from_numpy(slab).to(torch.bfloat16),
        u8_quantize=lambda: _quantize_db_u8(slab),
        h2d_pinned=h2d)
    if store is not None:
        arr = ZArray.open(Path(store) / "annotation")
        # the store's first chunk of each plane, as the writer encodes it:
        # the whole chunk, its tail past the survey's pings at the fill
        planes = np.full((arr.shape[0],) + arr.chunks[1:],
                         arr.fill_value or 0, arr.dtype)
        head = arr[:, :arr.chunks[1], :]
        planes[:, :head.shape[1], :head.shape[2]] = head

        def compress():
            return [_Codec.encode(np.ascontiguousarray(planes[k:k + 1])
                                  .tobytes(), arr.compressor,
                                  typesize=arr.dtype.itemsize)
                    for k in range(planes.shape[0])]
        comps["zarr_compress"] = compress
    return comps, dict(slab=slab, fin=fin, zero=zero, host_set=host_set)


def _label_planes_equal(lab, ref, lab_bits) -> bool:
    """The label slice, laid into the write-mask planes as ``prepare``
    lays it, packs to the pipeline's two planes."""
    fin, zero = np.zeros_like(ref["fin"]), np.zeros_like(ref["zero"])
    fin[:lab.shape[1], :lab.shape[0]] = np.isfinite(lab).T
    zero[:lab.shape[1], :lab.shape[0]] = (lab == 0).T
    return (np.array_equal(np.packbits(fin, axis=1), lab_bits[0])
            and np.array_equal(np.packbits(zero, axis=1), lab_bits[1]))


def check_outputs(outs: dict, ref: dict, pipe: dict, store=None) -> dict:
    """Each component's output against what the pipeline built for chunk
    0 (``capture_pipeline``), bit for bit."""
    f32, bf16, u8 = (pipe[td]["data_slab"] for td in TRANSFERS)
    lab_bits = pipe["float32"]["lab_bits"]
    ok = {
        "fill_f32": _slab_bytes(f32) == outs["fill_f32"].tobytes(),
        "label_slice": _label_planes_equal(outs["label_slice"], ref,
                                           lab_bits),
        "packbits_isfinite": np.array_equal(outs["packbits_isfinite"],
                                            lab_bits[0]),
        "packbits_zero": np.array_equal(outs["packbits_zero"], lab_bits[1]),
        "bf16_cast": _slab_bytes(outs["bf16_cast"]) == _slab_bytes(bf16)
        if bf16.dtype == torch.bfloat16 else False,
        "u8_quantize": outs["u8_quantize"].tobytes() == _slab_bytes(u8),
        "h2d_pinned": all(
            np.array_equal(outs["h2d_pinned"][k].cpu().view(torch.uint16)
                           .numpy() if k == "data_slab" else
                           outs["h2d_pinned"][k].cpu().numpy(),
                           (v.view(torch.uint16).numpy() if torch.is_tensor(v)
                            else v))
            for k, v in ref["host_set"].items()),
    }
    if "fill_bf16_bits" in outs:
        ok["fill_bf16_bits"] = outs["fill_bf16_bits"].tobytes() == \
            _slab_bytes(bf16)
    if "zarr_compress" in outs:
        from crimac_unet_tpu_torch.data.zarrlite import ZArray
        arr = ZArray.open(Path(store) / "annotation")
        ok["zarr_compress"] = all(
            (Path(store) / "annotation" / arr._chunk_key((k, 0, 0)))
            .read_bytes() == frame
            for k, frame in enumerate(outs["zarr_compress"]))
    return {k: bool(v) for k, v in ok.items()}


def profile(sd, cfg, reader, device, work, reps=5, preload=1000):
    """(component rows, equality per component, chunk context)."""
    from crimac_unet_tpu_torch.data import blosc_codec
    pipe = capture_pipeline(sd, cfg, reader, device, work, preload)
    c = chunk_at(reader, cfg, 0, preload)
    comps, ref = components(reader, cfg, c, device, pipe.get("store"))
    rows, outs = {}, {}
    for name, fn in comps.items():
        w, cpu, outs[name] = best_of(fn, reps, device)
        rows[name] = {"wall_ms": w * 1e3, "cpu_ms": cpu * 1e3}
    equal = check_outputs(outs, ref, pipe, pipe.get("store"))
    # scripts/host_scaling.py timed an inline formula that truncates the
    # code where the pipeline rounds half up: how far apart they are
    d = outs["u8_quantize"].astype(np.int16) - inline_u8_formula(
        ref["slab"]).astype(np.int16)
    ctx = {"codec_backend": blosc_codec.backend(),
           "scatter_available": blosc_codec.scatter_available(),
           "slab_shape": list(ref["slab"].shape),
           "slab_mb": ref["slab"].nbytes / 1e6,
           "chunk": [c.s, c.e], "n_range": c.n_range,
           "store_compressor": None,
           "u8_vs_inline_formula": {"min": int(d.min()), "max": int(d.max()),
                                    "share_differing": float((d != 0).mean())}}
    if pipe.get("store") is not None:
        from crimac_unet_tpu_torch.data.zarrlite import ZArray
        ctx["store_compressor"] = ZArray.open(
            Path(pipe["store"]) / "annotation").compressor
        shutil.rmtree(pipe["store"], ignore_errors=True)
    return rows, equal, ctx, c


def run(device="cuda", survey=None, model=None, ckpt=None, work=None,
        reps=5, preload=1000, log=print) -> dict:
    dev = common.device_of(device)
    cfg = common.model_config(model)
    sd = common.state_dict(ckpt) if ckpt is not None \
        else seeded_state_dict(cfg)
    reader = common.zarr_reader(survey or common.bench_survey())
    work = Path(work or common.WORK)
    work.mkdir(parents=True, exist_ok=True)
    rows, equal, ctx, _ = profile(sd, cfg, reader, dev, work, reps, preload)
    log(f"host components of chunk {ctx['chunk']} of {reader.name} (slab "
        f"{tuple(ctx['slab_shape'])} float32, {ctx['slab_mb']:.1f} MB; "
        f"codec backend {ctx['codec_backend']}, store compressor "
        f"{ctx['store_compressor']}), best of {reps}:")
    for name, r in rows.items():
        log(f"  {name:<18} wall {r['wall_ms']:9.3f} ms  cpu "
            f"{r['cpu_ms']:9.3f} ms  equal to the pipeline's chunk 0: "
            f"{equal.get(name)}")
    u = ctx["u8_vs_inline_formula"]
    log(f"  u8_quantize against host_scaling.py's inline formula (which "
        f"truncates): codes differ by {u['min']}..{u['max']} on "
        f"{u['share_differing']:.1%} of the slab")
    if "fill_bf16_bits" not in rows:
        log("  fill_bf16_bits: not measured (no native decoder: the "
            "pipeline fills a float32 slab and casts it)")
    return {"device": common.card_name(dev), "components": rows,
            "equal": equal, **ctx}


def main(argv=None):
    ap = common.parser(__doc__.split("\n\n")[0], ckpt_required=False,
                       bench=True)
    ap.add_argument("--reps", type=int, default=5)
    tc.add_model_flags(ap)
    args = ap.parse_args(argv)
    sv = common.bench_survey(args.work, W=args.pings)
    common.finish(run(args.device, sv, tc.model_from(args), args.ckpt,
                      args.work, args.reps), args.out)


if __name__ == "__main__":
    main()
