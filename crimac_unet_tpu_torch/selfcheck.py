"""Deployment self-check of the port: ``python -m crimac_unet_tpu_torch.selfcheck``.

The port's counterpart of ``crimac_unet_tpu/selfcheck.py``: a pass/fail
report over what the port needs at run time — Python / torch / CUDA /
numpy versions, the CUDA device, the Blosc codec backend (native chunkio
-> ctypes libblosc -> pure numpy), a zarr round trip on that codec, a
tiny end-to-end predict on synthetic data through ``GriddedRunner``
(on the card it also counts the gather_db (K1) and relu_pool_skip (K3)
launches, so a box whose kernels do not build fails here, by name) and
school detection from the store written — exiting nonzero if a required
piece is broken.

``--skip-device`` runs every check on the CPU, asked for explicitly (a
data-prep box).  Without it the checks run on ``cuda``: with no card the
device line fails and the run exits 1; it never carries on on the CPU.
"""

from __future__ import annotations

import sys
import tempfile
import time


class _Report:
    def __init__(self):
        self.failed = False

    def line(self, name: str, ok: bool, detail: str, required=True):
        mark = "ok  " if ok else ("FAIL" if required else "warn")
        if not ok and required:
            self.failed = True
        print(f"[{mark}] {name:<24} {detail}", flush=True)


def _check_versions(rep: _Report) -> None:
    import numpy as np
    import torch
    rep.line("python", sys.version_info >= (3, 10), sys.version.split()[0])
    rep.line("torch", True, torch.__version__)
    rep.line("torch cuda", True, str(torch.version.cuda))
    rep.line("numpy", True, np.__version__)


def _check_device(rep: _Report) -> None:
    import torch
    t = time.time()
    try:
        if not torch.cuda.is_available():
            rep.line("device", False, "no CUDA device (torch.cuda."
                     "is_available() is False); --skip-device checks the "
                     "host side on the CPU")
            return
        got = float(torch.arange(8.0, device="cuda").sum())
        rep.line("device", got == 28.0,
                 f"{torch.cuda.device_count()}x "
                 f"{torch.cuda.get_device_name(0)} "
                 f"(probe {time.time() - t:.1f}s)")
    except Exception as exc:  # a broken CUDA install is what this reports
        rep.line("device", False, f"CUDA unavailable: {exc!r}")


def _check_codec(rep: _Report) -> None:
    import numpy as np

    from .data import blosc_codec as bc
    # 'pure' = no binary codec (no compression, slow decode): the
    # degraded state this warn line surfaces
    rep.line("blosc backend", bc.available(), bc.backend(), required=False)
    if not bc.available():
        return
    raw = np.arange(4096, dtype=np.float32).tobytes()
    frame = bc.compress(raw, typesize=4)
    rep.line("blosc roundtrip", bc.decompress(frame) == raw,
             f"{len(raw)} -> {len(frame)} bytes")


def _check_zarr(rep: _Report) -> None:
    import numpy as np

    from .data import blosc_codec as bc
    from .data.zarrlite import ZArray, ZGroup, consolidate_metadata
    with tempfile.TemporaryDirectory() as tmp:
        g = ZGroup.create(tmp + "/t.zarr")
        comp = "blosc-zstd" if bc.available() else "zlib"
        a = g.create_array("x", (0, 64), (32, 64), np.float16,
                           fill_value=0, dims=["ping_time", "range"],
                           compressor=comp)
        data = np.random.RandomState(0).rand(50, 64).astype(np.float16)
        a.append(data, axis=0)
        consolidate_metadata(tmp + "/t.zarr")
        back = ZGroup.open_consolidated(tmp + "/t.zarr")["x"][:]
        rep.line("zarr store", np.array_equal(back, data),
                 f"append+consolidate+read, codec {comp}")
        rep.line("zarr reopen",
                 np.array_equal(ZArray.open(tmp + "/t.zarr/x")[:], data),
                 "per-array metadata path")


def _check_end_to_end(rep: _Report, device) -> None:
    """``device`` 'cpu', or None for cuda (raising without a card)."""
    import numpy as np
    import torch

    from .data.fixtures import make_zarr_survey
    from .data.zarr_reader import DataReaderZarr
    from .data.zarrlite import ZGroup
    from .models import build_model
    from .models.unet import init_random_
    from .ops import cuda_lib
    from .pipeline.predict import save_survey_predictions_zarr
    from .pipeline.runner import GriddedRunner
    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        sv = make_zarr_survey(tmp + "/z", year=2017, n_echograms=1,
                              H=64, W=96, seed=0)
        reader = DataReaderZarr(sv)
        cfg = {"patch_size": [32, 32], "patch_overlap": 4,
               "frequencies": [18, 38, 120, 200], "depth": 2,
               "start_filts": 8, "fwd_batch": 8}
        model = init_random_(build_model(cfg),
                             torch.Generator().manual_seed(0))
        runner = GriddedRunner(build_model(cfg), model.state_dict(), cfg,
                               device=device)
        out = tmp + "/pred.zarr"
        cuda_lib.reset_launches()
        save_survey_predictions_zarr(runner, reader, out,
                                     preload_n_pings=96)
        a = ZGroup.open(out)["annotation"][:]
        ok = (a.shape == (2, 96, 64) and np.isfinite(a).all()
              and 0.0 <= a.min() and a.max() <= 1.0)
        where = runner.device.type
        rep.line("end-to-end predict", ok,
                 f"96 pings -> {a.shape} f16 on {where} "
                 f"({time.time() - t:.1f}s)")
        if where == "cuda":
            k1 = cuda_lib.launches["gather_db"]
            k3 = cuda_lib.launches["relu_pool_skip"]
            rep.line("kernels (K1, K3)", k1 > 0 and k3 > 0,
                     f"gather_db {k1}, relu_pool_skip {k3} launches")

        # school detection over the store just written (host-only); its
        # own try so a failure is reported under its name
        t = time.time()
        try:
            from .pipeline.school_eval import detect_store_schools
            dets = detect_store_schools(out, reader, prob_threshold=0.2)
            n = sum(len(d) for d in dets.values())
            ok2 = (set(dets) == {0, 1}
                   and all(d["n_pixels"] >= 1
                           and d["bounding_box"][0] <= d["bounding_box"][1]
                           and d["bounding_box"][2] <= d["bounding_box"][3]
                           for ch in dets.values() for d in ch))
            rep.line("school detection (store)", ok2,
                     f"{n} components across 2 categories "
                     f"({time.time() - t:.1f}s, host-only)")
        except Exception as exc:
            rep.line("school detection (store)", False, repr(exc))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--skip-device", action="store_true",
                   help="no CUDA probe; run every check on the CPU")
    args = p.parse_args(argv)

    rep = _Report()
    _check_versions(rep)
    device = "cpu" if args.skip_device else None
    if not args.skip_device:
        _check_device(rep)
    _check_codec(rep)
    _check_zarr(rep)
    try:
        _check_end_to_end(rep, device)
    except Exception as exc:
        rep.line("end-to-end predict", False, repr(exc))
    print("SELFCHECK " + ("FAILED" if rep.failed else "PASSED"))
    return 1 if rep.failed else 0


if __name__ == "__main__":
    sys.exit(main())
