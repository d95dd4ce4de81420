"""What ``static_grid`` saves on a cold process: the port's counterpart of
``scripts/static_grid_tpu.py``.

A mixed-bathymetry memmap survey (three echograms with different range
extents, seabed depths and ping counts, seed 5, so the per-chunk grid
height R, the tail width C and the per-reader range all churn) is
predicted end to end through ``run_save_predictions`` twice, with
``static_grid: true`` and then ``false``, each arm in a fresh
subprocess, so nothing a first call sets up (cuDNN's heuristic queries
and plans, CUDA's lazily loaded modules, the allocator's pool, the
kernel library's load) carries from one arm to the other.  The static
arm runs first, so it pays every first call truly cold.  The survey's
seabed and label caches are written with the survey, before either arm
(``ensure_fixture``).  Per arm, at
full width (depth 5, start_filts 64, bf16, patch 256 / overlap 20,
fwd_batch 32, seeded weights): the cold wall and pings/s, the chunks,
the distinct ``(R, C)`` grids of ``_predict_patches`` and the distinct
``(n_range, n_pings, chunk_w)`` of ``_mask_output`` (spied as the JAX
script spies them), and the distinct (input shape, weight shape) pairs
of the U-Net's convolutions, which key cuDNN's plans: the H100's
counterpart of XLA's program count.  The U-Net calls its convolutions
functionally, so the count wraps ``F.conv2d`` / ``F.conv_transpose2d``
in the arm's process (module hooks would not fire).  The arms' outputs:
write masks identical and max |dprob| <= 4e-3 (another sub-batch size
may take another cuDNN algorithm in bf16; on the CPU they are
bit-identical).  ``--order dynamic,static`` runs the dynamic arm first,
to tell what a first process pays from what an arm costs.

    python scripts/torch_static_grid.py [--device cuda] [--work build/torch_checks] \\
        [--order static,dynamic]
    python scripts/torch_static_grid.py --arm 0|1 --fixture DIR --arm-out DIR

Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

PATCH = 256
OVERLAP = 20
PRELOAD = 1000
# (n_range, n_pings, seabed_frac): three echograms, mixed depths/extents,
# fracs chosen so the per-chunk R churns (0.35 -> shallow grid, 0.9 deep)
ECHOS = [(1100, 2600, 0.35), (900, 2600, 0.9), (1100, 1500, 0.6)]
MAX_DPROB = 4e-3
ARM_TIMEOUT_S = 900


def ensure_fixture(work=common.WORK, echos=ECHOS) -> Path:
    """The survey under ``work``, rebuilt when ``echos`` changed, with
    each echogram's seabed estimate and heave-reverted labels cached
    beside it: the reader writes both at its first use (about 3.6 s of
    host work for ``ECHOS``), which would otherwise land in the cold
    wall of whichever arm reads the survey first."""
    from crimac_unet_tpu_torch.data.fixtures import (make_synthetic_echogram,
                                                     write_memmap_echogram)
    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    root = Path(work) / "static_grid_survey"
    ok = root / ".ok"
    params = f"{echos} seed=5, seabed and labels cached"
    if ok.is_file() and ok.read_text() == params:
        return root
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i, (H, W, frac) in enumerate(echos):
        d = dt.date(2017, 4, 27) + dt.timedelta(days=i)
        name = f"2017843-D{d:%Y%m%d}-T0626{i:02d}"
        data, labels, heave, _ = make_synthetic_echogram(
            H, W, rng, n_schools=6, seabed_frac=frac)
        write_memmap_echogram(str(root), name, data, labels, heave,
                              common.FREQS)
    for reader in get_echograms(years=[2017], path_to_echograms=str(root),
                                frequencies=common.FREQS, minimum_shape=0):
        reader.get_seabed()
        reader.label_memmap()
    ok.write_text(params)
    return root


def arm_config(static, model=None) -> dict:
    """The JAX script's configuration; ``model`` overrides."""
    return dict(dict(
        frequencies=common.FREQS, patch_size=[PATCH, PATCH],
        patch_overlap=OVERLAP, preload_n_pings=PRELOAD, depth=5,
        start_filts=64, meta_channels=[], late_meta_inject=False,
        compute_dtype="bfloat16", data_mode="memm", resume_writing=False,
        save_labels=False, save_prediction_surveys=[2017],
        fwd_batch=32, mesh_devices=1), **(model or {}), static_grid=static)


def run_arm(static, fixture, out, device="cuda", model=None) -> dict:
    """One arm in this process: every survey echogram predicted into
    ``out`` with the spies on, the launch counters set to 0 just before
    and read just after."""
    import torch.nn.functional as F

    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.ops import cuda_lib
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions
    from scripts.torch_roofline import seeded_state_dict
    dev = common.device_of(device)
    cfg = arm_config(static, model)
    runner = common.make_runner(seeded_state_dict(cfg), cfg, dev)
    # minimum_shape: get_echograms' default 256 at full width
    readers = get_echograms(years=[2017], path_to_echograms=str(fixture),
                            frequencies=cfg["frequencies"],
                            minimum_shape=cfg["patch_size"][0])
    if len(readers) < 2:
        raise RuntimeError(f"{len(readers)} echograms under {fixture}")

    class Data:
        def get_survey_readers(self, survey):
            return readers

    pp_sigs, mo_sigs, convs = [], [], set()
    n_in, patch = len(cfg["frequencies"]), tuple(cfg["patch_size"])
    real_pp, real_mo = runner._predict_patches, runner._mask_output

    def spy_pp(data_slab, y0p, x0p, N, border_ext, R, C, *rest):
        pp_sigs.append((R, C, tuple(data_slab.shape)))
        return real_pp(data_slab, y0p, x0p, N, border_ext, R, C, *rest)

    def spy_mo(stitched, lab_bits, data_slab, sb_row, nr, n_pings, chunk_w,
               **kw):
        mo_sigs.append((nr, n_pings, chunk_w, tuple(stitched.shape)))
        return real_mo(stitched, lab_bits, data_slab, sb_row, nr, n_pings,
                       chunk_w, **kw)

    def conv_spy(real):
        def spy(x, weight, *args, **kw):
            convs.add((real.__name__, tuple(x.shape), tuple(weight.shape),
                       str(x.dtype)))
            return real(x, weight, *args, **kw)
        return spy

    runner._predict_patches, runner._mask_output = spy_pp, spy_mo
    reals = {n: getattr(F, n) for n in ("conv2d", "conv_transpose2d")}
    for n, real in reals.items():
        setattr(F, n, conv_spy(real))
    try:
        common.synchronize(dev)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        run_save_predictions(cfg, runner, Data(), str(out))
        common.synchronize(dev)
        cold_wall = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)
    finally:
        for n, real in reals.items():
            setattr(F, n, real)
    pings = sum(r.shape[1] for r in readers)
    return dict(static=static, cold_wall_s=cold_wall,
                pings_per_sec_cold=pings / cold_wall,
                n_chunks=len(pp_sigs), forwards=runner.forwards,
                distinct_predict_sigs=sorted({(r, c) for r, c, _ in pp_sigs}),
                distinct_mask_sigs=sorted({s[:3] for s in mo_sigs}),
                conv_shapes=len(convs),
                # forward sub-batch sizes: the first conv's batch dim
                sub_batches=sorted({x[0] for n, x, w, _ in convs
                                    if n == "conv2d" and x[1] == n_in
                                    and x[2:] == patch}),
                launches=launches,
                device=common.card_name(dev))


def compare(dir_dynamic, dir_static) -> dict:
    """Write masks and max |dprob| between the arms' stores."""
    worst, masks_equal, identical, n = 0.0, True, True, 0
    for f in sorted(Path(dir_dynamic).glob("*.npy")):
        a = np.load(f)
        b = np.load(Path(dir_static) / f.name)
        identical &= bool(np.array_equal(a, b, equal_nan=True))
        a, b = np.nan_to_num(a, nan=-1.0), np.nan_to_num(b, nan=-1.0)
        masks_equal &= bool(((a != 0) == (b != 0)).all())
        worst = max(worst, float(np.abs(a.astype(np.float64)
                                        - b.astype(np.float64)).max()))
        n += 1
    return dict(n_stores=n, write_masks_identical=masks_equal,
                max_abs_prob_diff=worst, bit_identical=identical)


ORDERS = {"static,dynamic": (1, 0), "dynamic,static": (0, 1)}


def run(device="cuda", work=common.WORK, model=None, echos=ECHOS,
        timeout=ARM_TIMEOUT_S, order="static,dynamic") -> dict:
    """Both arms, each in a fresh subprocess, in ``order`` (static first
    by default, as the JAX script runs them); raises when the write masks
    differ or |dprob| exceeds ``MAX_DPROB``."""
    dev = str(common.device_of(device))
    fixture = ensure_fixture(work, echos)
    results = {}
    for arm in ORDERS[order]:
        out = Path(work) / f"static_grid_out_{arm}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--arm",
               str(arm), "--fixture", str(fixture), "--arm-out", str(out),
               "--device", dev, "--model", json.dumps(model or {})]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"arm {arm} failed:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("ARM_JSON ")][-1]
        results[arm] = json.loads(line[len("ARM_JSON "):])
    res = dict(order=order, dynamic=results[0], static=results[1],
               **compare(Path(work) / "static_grid_out_0",
                         Path(work) / "static_grid_out_1"))
    if not res["write_masks_identical"] or \
            res["max_abs_prob_diff"] > MAX_DPROB:
        raise RuntimeError(f"output mismatch between the arms beyond "
                           f"{MAX_DPROB}: {res}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--work", default=str(common.WORK))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--order", default="static,dynamic", choices=ORDERS,
                    help="the arms' order (default static first, as JAX)")
    ap.add_argument("--arm", type=int, choices=(0, 1),
                    help="run one arm here (static 1, dynamic 0)")
    ap.add_argument("--fixture", help="the arm's survey directory")
    ap.add_argument("--arm-out", help="the arm's prediction directory")
    ap.add_argument("--model", default="{}",
                    help="JSON of configuration overrides (smaller models)")
    a = ap.parse_args(argv)
    if a.arm is not None:
        res = run_arm(bool(a.arm), a.fixture, a.arm_out, a.device,
                      json.loads(a.model))
        print("ARM_JSON " + json.dumps(res), flush=True)
        return
    common.finish(run(a.device, a.work, json.loads(a.model),
                      order=a.order), a.out)


if __name__ == "__main__":
    main()
