#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (crimac_unet_tpu_torch).

    python3 chip_smoke.py                  # every phase, on CUDA device 0
    python3 chip_smoke.py --phases 1,2     # a subset (debugging)
    python3 chip_smoke.py --phases 1,12 --recipe baseline   # + a recipe
    python3 chip_smoke.py --phases 1 --recipe meta-early
    python3 chip_smoke.py --phases 1,15    # the export from random weights
    python3 chip_smoke.py --phases 1,4,6,18   # the matrix and JAX calls
    python3 chip_smoke.py --phases 1,6,12,19  # trained weights, soak
    python3 chip_smoke.py --phases 1,6,19 --trained-ckpt best.msgpack
    python3 chip_smoke.py --phases 1,6,20     # where the time goes
    python3 chip_smoke.py --phases 1,6,12,21  # A/B benches, recipe arms
    python3 chip_smoke.py --phases 1,22       # the probes, P1-P3
    python3 chip_smoke.py --phases 1,6,23     # the production image's files

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit; imports
nothing of JAX or of the JAX package.  Phases, in order; any failure
raises and the script exits nonzero without its result line:

1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
   the build of every kernel from ``crimac_unet_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes, with NaN, +-Inf, negative-sv and edge-of-slab inputs
   (gather_db within one ulp of the output dtype; the pools and the
   closing bit-equal, NaN positions included), and its time beside the
   plain version, a single PyTorch call where one computes the same
   function, and the least time the card could take: the larger of
   bytes over 3.35 TB/s and operations over the rate of their kind
   (K1's float instructions, counted in its SASS, over 33.5 T/s; K4's
   integer operations over 16.7 T/s; the pools' flops over 67 T/s).
   Each time is the device's, the calls queued behind a device-side
   sleep so the host's enqueue pace is not what is timed.  Then K1 and
   K3 at slab mode's geometry: K1 as one (H16, W16) window over the
   first chunk's whole grid (N = 1; uint8, bfloat16 and float32 slabs,
   scaled and not, shipped short of the grid in rows and columns), K3
   at (1, H16, W16, 64); K4 also at the train step's mask shapes
   (B, 256, 256) and K2 at the validation step's (B, 256, 256, 64) for
   every training batch B the paths run (K4 4, 8, 16, 32; K2 4, 16,
   32); each kernel called as its
   ``torch.ops.crimac.*`` operator, as an exported graph calls it, held
   to its wrapper and its plain version; then the sample pools' gathers at
   the training batch (4, 256, 256): ``ZarrSamplePool`` on the phase-13
   survey bit-equal to the host zarr crops (corners and every edge), and
   ``gather_meta_crops`` on the phase-12 survey within rtol 1e-5, atol
   1e-6 of the host ``crop_meta`` for the six families;
3. small agreement runs on the CPU (plain versions) and on the card
   (kernels), depth 3 / start_filts 8, float32, TF32 off: one synthetic
   echogram through the whole predict path (BatchNorm folded and
   unfolded: identical write masks, probabilities within 2 float16 ulp)
   and through gridded evaluation (modes all, region, trace: identical
   per-class pixel counts, max-F1 and AP within 2e-3); the same checks
   on a small zarr survey (prediction with float32 and bfloat16
   transfer, the latter through the codec's converting decode where it
   is built, and evaluation in the three modes); then slab mode (memm;
   zarr with uint8 transfer), the static grid (patch and slab) and the
   metadata channels (early and late inject, patch and slab prediction,
   evaluation); then one and two float32 train steps (augmentation off)
   from the same weights and crops: labels after the train chain
   identical, loss and updates within stated tolerances, and the pooled
   step equal to the host-crop step; then one pooled step, CPU vs card,
   over a zarr pool and over metadata pools (early and late inject) with
   the same tolerances;
4. the prediction main path at full width: ``run_save_predictions`` on a
   seeded 1000 x 4000 x 4 memmap echogram with the flagship U-Net (depth
   5, start_filts 64, seeded random weights, bfloat16, patch 256 /
   overlap 20, fwd_batch 32), BatchNorm folded (the serving default) and
   then unfolded (into its own directory), each with the launch counters
   reset just before and read just after;
5. the evaluation main path at full width: ``evaluate_survey`` over the
   same survey (eval_mode all, bfloat16 transfer, BatchNorm folded): a
   warm-up, a timed run with the launch counters reset just before and
   read just after, then a region run;
6. the zarr prediction main path at full width: a seeded 1000 x 4000 x 4
   zarr survey (the port's ``make_zarr_survey`` with the JAX package's
   bench.py parameters: seed 3, 24 schools) through
   ``save_survey_predictions_zarr`` (a warm-up, a timed run, a profiled
   run) and then one ``dockerscript.main()`` run through the
   MODELWEIGHTS / SURVEY_PATH / OUTPUT_DIR / PRED_FILE overrides with no
   CONFIG_PATH (the flagship defaults); each store is read back and
   checked, and the codec backend and the compressors are printed;
7. the zarr evaluation path at full width: ``evaluate_reader`` (mode
   all) on the same zarr survey, a warm-up and a timed run;
8. the serving preset (``config_serving.yaml`` as the dict
   ``SERVING_PRESET``: slab mode, static grid, uint8 transfer and
   output) on the phase-6 zarr survey through
   ``save_survey_predictions_zarr``: a warm-up, a timed run with its
   PhaseTimer, a profiled run; one grid shape for every chunk, the store
   read back and its written set held against the phase-6 store's;
9. the static grid over a memm survey of two echograms of different
   heights (1000 and 1200 range x 2000 pings) through
   ``run_save_predictions``: one grid shape for both, each output equal
   to the per-reader grids' (float32, TF32 off);
10. the metadata channels (the six families of config_meta_train.yaml)
    on the phase-4 survey: early-inject prediction and evaluation, then
    late-inject prediction, each a warm-up and a timed run;
11. school-detection evaluation, live on the memm and zarr surveys, then
    from the stores phases 4 and 6 wrote: equal metrics;
12. training at full width through ``run_training``: the flagship U-Net
    (bfloat16, batch 4, patch 256) on the reference recipe's fixture
    (scripts/r3_tpu_session.py:51-78; 2017 3 x 700 x 1400, 2016 2 x 700
    x 1200), 400 iterations with validation every 200 (50 batches), lr
    halved every 100, a checkpoint every 200, both device pools on: the
    loss finite and falling, K4 once per train and validation step, K2
    once per validation step, K3 never, best/last msgpack checkpoints
    and sidecars written; resume from the step-200 checkpoint (step,
    momentum buffers, weights); the step time by CUDA events over 50
    steps (no host sync inside), the profiler over 20; the trained
    best.msgpack served and evaluated (BatchNorm folded) on the 2016
    survey, and scored there by school-detection evaluation (the
    school_eval CLI's defaults);
13. zarr training at full width, as phase 12 (cut to 200 steps and one
    validation, as is phase 14) on the recipe fixture in
    zarr form (one nested 2017 survey of 4200 pings with a STOX transects
    CSV, 2016 of 2400 pings): ``ZarrSamplePool`` for training and
    validation, the same checks, resume and step timing, and the trained
    model served through ``save_survey_predictions_zarr`` and evaluated
    (``evaluate_reader``) on 2016;
14. metadata training at full width, early then late inject with the six
    families of config_meta_train.yaml, as phase 12 with the metadata
    crops computed on the card from the pools' vectors; each trained
    model served and evaluated through the metadata paths of phase 10;
15. the serving export at full width (``pipeline/export.py``): phase 12's
    trained best.msgpack (or, without phase 12, seeded random weights
    written to a msgpack) exported on the card through
    ``export_checkpoint``, saved, loaded back on cuda and served — the
    patch artifact (float32 raw sv, symbolic batch, BatchNorm folded) on
    32 patches of the phase-4 survey with NaN/+-Inf seeded, against the
    eager serving forward (identical, or within 2 float16 ulp) and, on
    the windows of a zarr chunk, against
    ``GriddedRunner._predict_patches`` (atol 2e-7); the fold_bn false
    artifact (K2); the serving preset's slab artifact (uint8 in and out)
    on chunks (1, 1120, 1120) and (2, 512, 768), refusing an unaligned
    one; a late-inject metadata artifact; an artifact exported on the
    CPU and loaded on cuda, equal to the card-exported one; K1 = K3 = 1
    per artifact call; the artifact and the eager forward timed with
    ``utils.timing.burst_time`` at (32, 256, 256, 4) with their MFU
    against the H100's bf16 peak; ``python -m
    crimac_unet_tpu_torch.selfcheck`` in a subprocess (K1 and K3
    counted); one ``save_predict`` CLI run under ``CRIMAC_PROFILE_DIR``
    whose trace ``device_op_table`` reads back, naming K1 and K3;
16. data parallelism (``crimac_unet_tpu_torch/parallel``): (a) four
    full-width float32 train steps through the distributed step in an
    in-process NCCL world of one rank, bit-equal to the same steps
    without a process group; (b) on one rank in this process, then on
    two gloo ranks spawned on this one card (NCCL refuses two ranks on
    one device): 20 float32 training steps at full width on phase 12's
    fixture (batch 4, 2 rows a rank), patch prediction of phase 4's
    survey, the serving preset on phase 6's zarr survey (the ping axis
    split, with the halo ``slab_halo``) and memm evaluation of phase
    4's survey; two ranks held against one (losses within rtol 1e-3 /
    atol 1e-4, each weight tensor within 1e-3 of its max |w| + 1e-4,
    write masks identical, probabilities within
    PARALLEL_PRED_ATOL / PARALLEL_SLAB_ATOL, evaluation histograms
    bit-equal; the serving slab again at float32 compute within
    PARALLEL_SLAB_F32_ATOL, which a halo one pooling step short must
    miss), the stores written by rank 0 alone, and every rank's K1-K4
    launches checked per path (``par2_<path>_r<rank>``,
    ``par1_<path>``, ``par_nccl1_train``);
17. offline onboarding at full width: the phase-4 echogram written as an
    EK60 cruise directory (``fixtures.write_raw_trio``: 16 000 RAW0
    datagrams of int16 power, a .bot, a .snap with one rectangle per
    school box) and onboarded (``convert_survey_raw`` ->
    ``convert_survey_tree`` -> ``batch_estimate_seabed``), each step's
    wall printed; the onboarded echogram (1000, 4000), its sv within half
    an int16 power step of the source, its labels nonzero exactly inside
    the boxes; then ``ob``, ``run_save_predictions`` of it with phase 4's
    config and weights (K1 = K3 = phase 4's, the store finite in [0, 1],
    ``regrid_prediction`` of it onto its own grid bit for bit, the
    difference to phase 4's store printed and bounded), ``oe``,
    ``evaluate_survey`` (K4 = K3 = phase 5's), ``oz``,
    ``echograms_to_zarr_survey`` and ``rechunk_store`` from ping chunks
    of 1024 to 512, phase 6's config on both stores (the same write sets,
    the annotations within 2 float16 ulp, the same launches: ``oz``,
    ``oz512``), and ``example_production_serving`` (``oxp``) and
    ``example_samplers`` (``oxs``) with ``--device cuda``;
18. the configuration matrix and the JAX call surface at full width
    (needs phases 4 and 6): the eight combinations of
    tests/test_matrix.py (bfloat16 / uint8 transfer, uint8 output, slab
    mode, the static grid, the serving stack) as full-survey zarr
    predictions of phase 6's survey, then the serving stack on phase 4's
    echogram and the early and late metadata stacks, each held to its
    baseline (patch, float32 transfer, float16 output, per-chunk grid)
    under its mask law and the mean and max bounds of ``MATRIX``, with
    its pings/s and its K1 and K3 launches (``x_<name>``); then the
    restored surface on the card: ``pool.gather`` of both pools equal to
    ``gather_crops``, ``update_pr_histogram``'s scatter, sort and matmul
    bit-equal on one evaluation chunk, the JAX-style
    ``run_save_predictions(cfg, runner, data_obj, out)`` writing phase
    6's store again (``x_save_predictions``), ``run_training(cfg, ckpt,
    "phase18", None)`` for 20 full-width steps (``x_train``: K4 and K2),
    and ``get_gridded_survey_sampler`` with ``eval_mode: fish`` giving
    the trace sampler;
19. the JAX package's trained-weight and survey-scale checks (needs 6
    and 12, or ``--trained-ckpt``), through ``scripts/torch_*.py`` at
    full width with phase 12's trained best.msgpack: ``torch_u8_bound``
    (exact float32, patch uint8, slab uint8 and slab uint8 with uint8
    outputs over phase 6's survey), ``torch_eval_u8_bound`` (evaluation
    at float32, bfloat16 and uint8 transfer), ``torch_serving_geometry_ab``
    (the serving preset at overlap 20 and 16, each against its own
    float32 oracle), ``torch_school_ap_trained`` (school AP on the big
    held-out fixture: 14 echograms of 700 x 400), ``torch_soak50k``
    (patch, slab and uint8 evaluation streamed over a ``--soak-pings``
    survey, default 20 000, built by a child process while the other
    checks run, and over phase 6's 4000-ping survey as the reference of
    its host RSS delta and peak device memory; slab mode also over the
    soak survey with ``static_grid: true``, a control arm of one grid
    shape; for each run, chunk by chunk, the RSS, the count of distinct
    U-Net input shapes so far, the pinned host cache and glibc's malloc
    counters, printed and not bounded) and
    ``torch_school_eval_soak`` (the streaming detector over
    ``--soak-pings``); every reading printed beside its bound
    (``U8_DF1`` ... ``SOAK_DEVICE_RATIO``); the first K1 and K3 call of
    each path held bit for bit to its plain version (the new overlap-16,
    700-range and soak geometries); launches ``p19_<path>``;
20. where the time goes (needs 6), through the port's counterparts of
    the JAX repo's measurement scripts at full width (seeded weights):
    ``torch_roofline`` (every layer of the folded serving forward at
    batch 32 and at the train batch 4 against max(FLOPs / 989.4 TFLOP/s,
    bytes / 3.35 TB/s), K3 in the level-0 pool row and K2 beside
    ``F.max_pool2d`` in every pool row, each held bit for bit to its
    plain version first; the streaming-read probe, the whole folded
    forward, the prefix diffs), ``torch_roofline_bwd`` (forward and
    forward + backward per op, train-mode BatchNorm, the SGD update and
    the port's full step at batch 8), ``torch_decomp`` (phase 6's first
    chunk: full chunk, forward alone, K1 alone; the train step at batch 4
    and 8 as device time, host enqueue and kernels a call),
    ``torch_predict_timeline`` (the default and the serving preset's
    passes over phase 6's survey as timelines with device-busy
    intervals), ``torch_host_slab_profile`` and ``torch_host_scaling``
    (the host components of a chunk, per preset, the decoder's threads
    and concurrent chunk assemblies); every check beside its bound
    (``ROW_TIME_MIN`` ... ``THREAD_BUSY_MAX``); launches ``p20_<path>``;
21. the JAX repo's A/B benches and recipe studies (needs 6 and 12, or
    ``--trained-ckpt``) through ``scripts/torch_*.py`` at full width with
    phase 12's trained best.msgpack: ``torch_eval_quant_bench``
    (evaluation of phase 6's survey at float32, bfloat16 and uint8
    transfer: pings/s, the counts equal, |dF1| within ``EVAL_DF1``),
    ``torch_school_serving_bench`` (live school detection, patch + bf16
    and the serving arm, each equal to the detections read back from a
    store the same runner wrote), ``torch_school_postproc_sweep`` (the big
    held-out fixture predicted once, the 64-point threshold x min_area x
    merge_gap grid from its stores on the host, the baseline and chosen
    rows equal to live ``school_eval_survey`` runs at their settings),
    ``torch_pooled_meta_bench`` (host, pooled and staged metadata steps
    at batch 8), ``torch_static_grid`` (the static and dynamic arms, each
    in a fresh subprocess: cold walls, grid and conv-shape counts, the
    outputs within ``STATIC_MAX_DPROB``; K1 and K3 then held to their
    plain versions at every sub-batch size the arms ran), and the recipe
    arms of
    ``torch_fast_recipe`` (b16, b16_sqrt, b32), ``torch_meta_recipe``
    (early, late) and ``torch_r3_session`` (ab_float32, ab_bfloat16), each
    its exact configuration cut by ``RECIPE_CUT`` to one validation
    (iterations 20, log_step 20, test_iter 10): losses finite, the pooled
    (metadata) path on, K4 once per train and validation step, K2 once per
    validation step; the first call of every kernel on each path held
    bit for bit to its plain version, and the kernels held equal to those
    the path launched; launches ``p21_<path>``;
22. the JAX repo's last probes through ``scripts/torch_*.py`` at full
    width: ``torch_pool_probe`` (P1-P3, the CUDA kernels of
    ``csrc/pool_probe.cu`` that replace ``scripts/pallas_pool_probe.py``'s
    Pallas kernels, held bit for bit with NaN and +-Inf seeded to
    ``F.max_pool2d`` and their plain versions at (32, 256, 256, 64) and
    (8, 256, 256, 64), then timed beside ``F.max_pool2d`` and K2 against
    the byte bound), ``torch_pool_v2`` (K2 alone; the folded serving
    forward at batch 32 with K3 ON and with relu + ``F.max_pool2d`` OFF:
    ms, MFU, the logits within ``POOL_ONOFF_DLOGIT``), ``torch_l0_probe``
    (level-0 pool, conv and transposed-conv formulations at batch 32 and
    8, each held to production first), ``torch_dldw_probe`` (cuDNN's
    weight gradient against nine tap GEMMs at batch 8), ``torch_int8_probe``
    (bf16 conv against im2col + ``torch._int_mm``, exact against an int64
    reference) and ``torch_h2d_probe`` (the port's ``_to_device`` against
    pageable and pre-pinned copies, and during a matmul chain); launches
    ``p22_<path>``;
23. the production image's file set without docker (needs 6):
    ``crimac_unet_tpu_torch/`` copied alone into a temporary ``/app``,
    ``Dockerfile.torch``'s kernel build step run there (and its codec
    step where the host has libblosc), then its command, ``python -m
    crimac_unet_tpu_torch.pipeline.dockerscript``, in a subprocess with
    that directory alone on ``PYTHONPATH``, over phase 6's survey and
    weights through MODELWEIGHTS / SURVEY_PATH / CONFIG_PATH / OUTPUT_DIR
    / PRED_FILE: exit 0, the prebuilt library loaded and not rebuilt,
    the launches it prints equal to phase 6's docker run (K1 = K3 =
    forwards), its store bit-equal to phase 6's docker store; launches
    ``image``;

and then one JSON line naming every kernel with its phase-2 numbers
(slab geometry included) and P1-P3 with their phase-22 numbers, its
launches on the main path that runs it (K1-K3 phase 4, K4 phase 5, P1-P3
the pool probe's timing run) and its launches on every path
(``launches_by_path``; ``tr``, ``tz``, ``tme`` and ``tml`` are the
training runs of phases 12-14, ``ex``, ``exu``, ``es`` and ``em`` the
patch, unfolded, slab and metadata artifacts of phase 15, ``ob``, ``oe``,
``oz``, ``oz512``, ``oxp`` and ``oxs`` the onboarded paths of phase 17,
``x_*`` the paths of phase 18, ``p19_*`` ... ``p22_*`` those of phases
19-22, ``image`` phase 23's; P1-P3 list the ``p22_*`` paths),
then the last
line ``{"ok": true,
"device": {...}}``.  ``--recipe baseline|fast|meta-early|meta-late|zarr``
trains a full recipe after the selected phases (``run_recipe``) and
prints its best F1 and wall.

Every path is driven with the launch counters set to 0 just before it
and read just after.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the recipe's fixture and settings and the scalars logger, shared with
# the port's scripts (scripts/ sits beside this file)
from scripts.torch_check_common import (Scalars, recipe_config,  # noqa: E402
                                        train_fixture)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
F32_INSTR_PER_S = F32_FLOP_PER_S / 2   # an FFMA is 2 flops, 1 instruction
INT32_OPS_PER_S = 132 * 64 * 1.98e9    # H100 SXM: 64 INT32 lanes per SM
MAX_CLOCK_HZ = 2.0e9          # above the H100's 1.98 GHz boost: cycles of
                              # torch.cuda._sleep last at least this long
SEED = 20260

KERNELS = {
    "gather_db": dict(source="crimac_unet_tpu_torch/csrc/gather_db.cu",
                      replaces="crimac_unet_tpu/ops/pallas_gather.py:98"),
    "maxpool2x2": dict(source="crimac_unet_tpu_torch/csrc/pool.cu",
                       replaces="crimac_unet_tpu/ops/pallas_pool.py:114"),
    "relu_pool_skip": dict(source="crimac_unet_tpu_torch/csrc/pool.cu",
                           replaces="crimac_unet_tpu/ops/pallas_pool.py:187"),
    "binary_closing": dict(
        source="crimac_unet_tpu_torch/csrc/closing.cu",
        replaces="crimac_unet_tpu/ops/pallas_morphology.py:60"),
}
EVAL_CHUNK_COLS = 8           # evaluate_reader's column group
TRAIN_ITERATIONS = 400        # phase 12: steps of the memm training path
TRAIN_ITERATIONS_13_14 = 200  # phases 13-14 (one validation): the time
                              # phase 15 needs comes from here


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def memm_partition(cfg, root):
    """The data partition of ``cfg`` over the memmap echograms in ``root``,
    as the save_predict CLI builds it for ``run_save_predictions``."""
    from crimac_unet_tpu_torch.data.partition import make_partition
    return make_partition(dict(cfg, path_to_echograms=str(root)))


def host_ms(fn, iters=50):
    """Mean host time of one call of ``fn`` (its enqueue; no sync)."""
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e3


def cuda_ms(torch, fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events after a warm-up.  The timed calls are queued behind a
    device-side sleep that outlasts their enqueue, so the events see the
    device run them back to back: a kernel shorter than its wrapper's
    host time is not timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    enqueue_s = host_ms(fn) * 1e-3 * iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * enqueue_s + 1e-3, 2.0) * MAX_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved, ops, ops_per_s=F32_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sass_float_ops_per_element(cuda_lib):
    """Float instructions per element of K1's main-path instance
    (gather_db_kernel<bf16, bf16, unscaled>; an older build without the
    scaled template argument has one bf16 instance), read from its SASS
    in the built library: the function's float-pipe instructions (F*,
    I2F*, MUFU) over its inlined per-element paths, each of which adds
    the transform's 1e-10 exactly once."""
    import re
    tool = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cuda_lib.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if re.match(r"\S*gather_db_kernelI13__nv_bfloat16S\d*_(?:Lb0)?E",
                         f)]
    check(len(funcs) == 1, f"{len(funcs)} SASS functions match K1's "
                           f"main-path instance")
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)"
                     r"([^;]*)", funcs[0])
    fp = sum(op.startswith("F") or op in ("I2F", "I2FP", "MUFU")
             for op, _ in ops)
    paths = sum(op == "FADD" and "1.00000001335143196e-10" in rest
                for op, rest in ops)
    check(paths > 0, "no per-element path found in K1's SASS")
    return fp / paths, fp, paths


def max_ulp_err(torch, got, want):
    """(max |got - want| in float32, True if every element is within one
    ulp of want's binade in want's dtype); NaN positions must agree."""
    check(got.dtype == want.dtype, f"dtype {got.dtype} != {want.dtype}")
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          "NaN positions differ")
    m = ~torch.isnan(want)
    g, w = got[m].float(), want[m].float()
    bits = {torch.float32: 24, torch.bfloat16: 8}[want.dtype]
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - bits)
    err = (g - w).abs()
    return float(err.max()) if err.numel() else 0.0, \
        bool(torch.all(err <= ulp))


def equal_nan(torch, got, want):
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got.float(), nan=0.0),
                            torch.nan_to_num(want.float(), nan=0.0)))


# --------------------------------------------------------------- phase 1
def phase_card(torch, cuda_lib):
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({cuda_lib.library_path().name})")
    print(cuda_lib.build_log.strip() or "(library was already built)")
    return card


# --------------------------------------------------------------- phase 2
def first_chunk_inputs(torch, reader, cfg):
    """K1's inputs on the main path's first chunk — its HWC slab filled
    from the survey, with NaN, +-Inf and negative sv written in, the
    first forward sub-batch of patch starts and the data rectangle — and
    that sub-batch's size, built with the port's own grid law."""
    import numpy as np
    from crimac_unet_tpu_torch.ops.patches import make_grid_starts
    from crimac_unet_tpu_torch.pipeline.infer_common import _fill_hwc_slab
    from crimac_unet_tpu_torch.pipeline.predict import chunk_geometry
    from crimac_unet_tpu_torch.pipeline.runner import sub_batch_shape
    from crimac_unet_tpu_torch.utils.preload_split import get_data_split

    o = cfg["patch_overlap"]
    sh, sw = (p - 2 * o for p in cfg["patch_size"])
    n_range, n_pings = reader.shape
    s, e = get_data_split([[0, n_pings]], cfg["preload_n_pings"])[0]
    g = chunk_geometry(cfg["patch_size"], o, n_range, n_pings,
                       reader.get_seabed(0, n_pings),
                       reader.seabed_known(0, n_pings), int(s), int(e))
    slab = np.zeros((g.Hs, g.Wp, len(cfg["frequencies"])), np.float32)
    _fill_hwc_slab(reader, sorted(cfg["frequencies"]), slab, g.slab_x0,
                   g.slab_x1, g.slab_y1, o, g.x_off)
    H, W = g.Hs, g.Wp
    slab[H // 20:H // 10, W // 10:W // 4, 0] = np.nan
    slab[H // 2:H // 2 + 2, :, 2] = np.inf
    slab[2 * H // 3:2 * H // 3 + 3, 10:W - 10, 1] = -np.inf
    slab[3 * H // 4, W // 20:W // 2, 3] = -1e-3   # negative sv: NaN dB
    y0s, x0s = make_grid_starts(g.R, g.C, sh, sw, o, o, o)
    B, Np, _ = sub_batch_shape(len(y0s), cfg["fwd_batch"])
    pad = np.zeros(Np - len(y0s), np.int32)
    y0s, x0s = (np.concatenate([a, pad])[:B] for a in (y0s, x0s))
    return torch.from_numpy(slab), y0s, x0s, g.border, B, g


def phase_kernels(torch, cuda_lib, card, reader, cfg):
    import numpy as np
    from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                     gather_db_reference)
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2,
                                                maxpool2x2_reference,
                                                relu_pool_skip,
                                                relu_pool_skip_reference)
    from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8
    import torch.nn.functional as F

    dev = torch.device("cuda")
    results = {}
    win = tuple(cfg["patch_size"])
    raw, y0s, x0s, border, B, geom = first_chunk_inputs(torch, reader, cfg)
    Hs, Wp, Cf = raw.shape
    y0 = torch.from_numpy(y0s).to(dev)
    x0 = torch.from_numpy(x0s).to(dev)
    slabs = {torch.float32: raw, torch.bfloat16: raw.to(torch.bfloat16),
             torch.uint8: torch.from_numpy(_quantize_db_u8(raw.numpy()))}
    worst = 0.0
    n_cases = 0
    for sdtype, slab in slabs.items():
        for hs in (Hs, Hs - 200):   # cut: the rows below read as zeros
            s = slab[:hs].contiguous().to(dev)
            for bd in (None, border):
                for scaled in (False, True):
                    for odt in (torch.bfloat16, torch.float32):
                        args = (s, y0, x0, win, bd, scaled, odt)
                        err, ok = max_ulp_err(torch, gather_db(*args),
                                              gather_db_reference(*args))
                        torch.cuda.synchronize()
                        check(ok, f"gather_db off by more than one ulp: "
                                  f"slab {sdtype} rows {hs} border {bd} "
                                  f"scaled {scaled} out {odt}: {err}")
                        worst = max(worst, err)
                        n_cases += 1
    # the narrow-load and element-wise paths: fewer channels, odd start
    # columns (row starts off 16 bytes) and rows of ww * Cf elements that
    # are no multiple of the kernel's 8-element runs
    for cf, shift, ww in ((4, 1, win[1]), (2, 1, win[1]),
                          (1, 1, win[1] - 1), (3, 0, win[1] - 1)):
        for sdtype, slab in slabs.items():
            s = slab[:, :, :cf].contiguous().to(dev)
            for odt in (torch.bfloat16, torch.float32):
                args = (s, y0, x0 + shift, (win[0], ww), border, False, odt)
                err, ok = max_ulp_err(torch, gather_db(*args),
                                      gather_db_reference(*args))
                torch.cuda.synchronize()
                check(ok, f"gather_db off by more than one ulp: Cf {cf} "
                          f"start +{shift} width {ww} slab {sdtype} out "
                          f"{odt}: {err}")
                worst = max(worst, err)
                n_cases += 1
    s = slabs[torch.bfloat16].to(dev)
    main_args = (s, y0, x0, win, border, False, torch.bfloat16)
    out_bytes = B * win[0] * win[1] * Cf * 2
    # operations: the float instructions of the per-element path (read
    # from the kernel's SASS) for every element inside the data
    # rectangle; those outside it are stored as 0.0 with no arithmetic
    per_elem, fp, paths = sass_float_ops_per_element(cuda_lib)
    by0, by1, bx0, bx1 = border
    rows = np.clip(np.minimum(y0s + win[0], by1) - np.maximum(y0s, by0), 0,
                   None)
    cols = np.clip(np.minimum(x0s + win[1], bx1) - np.maximum(x0s, bx0), 0,
                   None)
    computed = int((rows * cols).sum()) * Cf
    b, by = bound_ms(s.numel() * 2 + 2 * B * 4 + out_bytes,
                     computed * per_elem, F32_INSTR_PER_S)
    print(f"gather_db SASS (bf16 -> bf16, unscaled): {fp} float "
          f"instructions over {paths} per-element paths = {per_elem:.2f} "
          f"per element; {computed} of {B * win[0] * win[1] * Cf} elements "
          f"inside the data rectangle")
    results["gather_db"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(torch, lambda: gather_db(*main_args)),
        plain_ms=cuda_ms(torch, lambda: gather_db_reference(*main_args)),
        bound_ms=b, bound_by=by, library_ms=None)
    print(f"gather_db: {n_cases} cases within 1 ulp (max abs err {worst}); "
          f"first-chunk slab {tuple(s.shape)} bf16 -> "
          f"({B}, {win[0]}, {win[1]}, {Cf}) bf16: kernel "
          f"{results['gather_db']['ms']:.4f} ms (wrapper's host time "
          f"{host_ms(lambda: gather_db(*main_args)):.4f} ms a call), plain "
          f"{results['gather_db']['plain_ms']:.4f} ms, bound {b:.4f} ms "
          f"({by}) [{card}]")

    # K2 / K3 at the level-0 activation of the main path
    shape = (B, win[0], win[1], cfg["start_filts"])
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(
            SEED)).mul_(2.0)
        idx = torch.randperm(x.numel(), generator=torch.Generator(
            ).manual_seed(SEED + 1))[:64]
        x.view(-1)[idx[:32]] = float("nan")
        x.view(-1)[idx[32:48]] = float("inf")
        x.view(-1)[idx[48:]] = float("-inf")
        x = x.to(dev, dtype)
        check(equal_nan(torch, maxpool2x2(x), maxpool2x2_reference(x)),
              f"maxpool2x2 != plain ({dtype})")
        for g, w in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
            check(equal_nan(torch, g, w), f"relu_pool_skip != plain "
                                          f"({dtype})")
        torch.cuda.synchronize()
    for odd in ((3, 6, 10, 5), (1, 2, 2, 8)):
        x = torch.randn(odd, device=dev).to(torch.bfloat16)
        check(equal_nan(torch, maxpool2x2(x), maxpool2x2_reference(x)),
              f"maxpool2x2 != plain at {odd}")
        for g, w in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
            check(equal_nan(torch, g, w), f"relu_pool_skip != plain {odd}")
    x = torch.randn(shape, device=dev).to(torch.bfloat16)
    n = x.numel()
    b2, by2 = bound_ms(n * 2 + n // 4 * 2, n)
    b3, by3 = bound_ms(n * 2 * 2 + n // 4 * 2, 2 * n)
    nchw = x.permute(0, 3, 1, 2)     # channels_last view of the same data
    results["maxpool2x2"] = dict(
        max_abs_err=0.0, ms=cuda_ms(torch, lambda: maxpool2x2(x)),
        plain_ms=cuda_ms(torch, lambda: maxpool2x2_reference(x)),
        bound_ms=b2, bound_by=by2,
        library_ms=cuda_ms(torch, lambda: F.max_pool2d(nchw, 2, 2)))
    results["relu_pool_skip"] = dict(
        max_abs_err=0.0, ms=cuda_ms(torch, lambda: relu_pool_skip(x)),
        plain_ms=cuda_ms(torch, lambda: relu_pool_skip_reference(x)),
        bound_ms=b3, bound_by=by3, library_ms=None)
    for name in ("maxpool2x2", "relu_pool_skip"):
        r = results[name]
        lib = "" if r["library_ms"] is None \
            else f", F.max_pool2d {r['library_ms']:.4f} ms"
        print(f"{name}: bit-equal to plain (bf16 + f32, NaN/Inf, odd B/C); "
              f"{shape} bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]")
    # K2 at the training paths' validation shapes: batch 4 (the reference
    # recipe), 16 (the fast preset and the metadata recipe) and 32 (the
    # fast recipe's b32 arm), patch 256
    for tb in (4, 16, 32):
        tshape = (tb, 256, 256, cfg["start_filts"])
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(tshape, generator=torch.Generator().manual_seed(
                SEED + tb)).mul_(2.0)
            idx = torch.randperm(x.numel(), generator=torch.Generator(
                ).manual_seed(SEED + tb + 1))[:64]
            x.view(-1)[idx[:32]] = float("nan")
            x.view(-1)[idx[32:48]] = float("inf")
            x.view(-1)[idx[48:]] = float("-inf")
            x = x.to(dev, dtype)
            check(equal_nan(torch, maxpool2x2(x), maxpool2x2_reference(x)),
                  f"maxpool2x2 != plain at {tshape} ({dtype})")
            torch.cuda.synchronize()
        # x is the float32 case; the training paths run it in bf16
        x = x.to(torch.bfloat16)
        n = x.numel()
        bt, byt = bound_ms(n * 2 + n // 4 * 2, n)
        nchw = x.permute(0, 3, 1, 2)
        rt = dict(shape=list(tshape), max_abs_err=0.0,
                  ms=cuda_ms(torch, lambda: maxpool2x2(x)),
                  plain_ms=cuda_ms(torch, lambda: maxpool2x2_reference(x)),
                  bound_ms=bt, bound_by=byt,
                  library_ms=cuda_ms(torch,
                                     lambda: F.max_pool2d(nchw, 2, 2)))
        results["maxpool2x2"][f"train_batch_{tb}"] = rt
        print(f"maxpool2x2 train shape {tshape}: bit-equal to plain (bf16 + "
              f"f32, NaN/Inf); bf16 kernel {rt['ms']:.4f} ms, plain "
              f"{rt['plain_ms']:.4f} ms, F.max_pool2d "
              f"{rt['library_ms']:.4f} ms, bound {bt:.4f} ms ({byt}) "
              f"[{card}]")
    ops_namespace_check(torch, main_args, x, card)
    results["binary_closing"] = phase_closing(torch, card, reader, cfg)
    phase_kernels_slab(torch, card, cfg, slabs, geom, border, per_elem,
                       results)
    return results


def ops_namespace_check(torch, k1_args, x, card):
    """Each kernel called as its ``crimac::`` operator, as an exported
    graph calls it: equal to its wrapper's result (the same launch) and
    held to its plain version (K1 within one ulp, the others bit-equal)
    at the main path's shapes."""
    from crimac_unet_tpu_torch.ops.closing import (binary_closing,
                                                   binary_closing_reference)
    from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                     gather_db_reference)
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2_reference,
                                                relu_pool_skip_reference)
    ops = torch.ops.crimac
    s, y0, x0, win, border, scaled, odt = k1_args
    got = ops.gather_db(s, y0, x0, win[0], win[1], [int(v) for v in border],
                        scaled, odt)
    check(equal_nan(torch, got, gather_db(*k1_args)),
          "crimac::gather_db != the gather_db wrapper")
    err, ok = max_ulp_err(torch, got, gather_db_reference(*k1_args))
    check(ok, f"crimac::gather_db off its plain version by {err}")
    check(equal_nan(torch, ops.maxpool2x2(x), maxpool2x2_reference(x)),
          "crimac::maxpool2x2 != plain")
    for g, w in zip(ops.relu_pool_skip(x), relu_pool_skip_reference(x)):
        check(equal_nan(torch, g, w), "crimac::relu_pool_skip != plain")
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    mask = torch.rand((24, 256, 256), device=x.device, generator=gen) < 0.3
    clip = torch.zeros_like(mask)
    clip[:, 20:230, 30:240] = True
    closed = ops.binary_closing(mask, clip)
    check(torch.equal(closed, binary_closing(mask, clip))
          and torch.equal(closed, binary_closing_reference(mask, clip)),
          "crimac::binary_closing != plain")
    torch.cuda.synchronize()
    print(f"torch.ops.crimac.*: gather_db {tuple(got.shape)} within one ulp "
          f"(max abs err {err}), maxpool2x2 / relu_pool_skip "
          f"{tuple(x.shape)} {x.dtype} and binary_closing (24, 256, 256) "
          f"bit-equal to their plain versions [{card}]")


def phase_kernels_slab(torch, card, cfg, slabs, geom, border, per_elem,
                       results):
    """K1 and K3 at slab mode's geometry (``infer_mode: slab``): K1 as one
    window over the first chunk's whole grid padded to the pooling
    alignment (N = 1, start (0, 0), H16 x W16), its rows from Hs on read
    as zeros, shipped narrower than W16 too, with the memmap data
    rectangle and the zarr one (the grid); K3 at (1, H16, W16, 64).
    Checks as at the patch geometry, then times and bounds."""
    from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                     gather_db_reference)
    from crimac_unet_tpu_torch.ops.pool import (relu_pool_skip,
                                                relu_pool_skip_reference)
    dev = torch.device("cuda")
    o = cfg["patch_overlap"]
    sh, sw = (p - 2 * o for p in cfg["patch_size"])
    Hp, Wp = geom.R * sh + 2 * o, geom.C * sw + 2 * o
    div = 2 ** (cfg["depth"] - 1)
    H16, W16 = -(-Hp // div) * div, -(-Wp // div) * div
    origin = torch.zeros(1, dtype=torch.int32, device=dev)
    win = (H16, W16)
    worst, n_cases = 0.0, 0
    for sdtype, slab in slabs.items():
        for cut in (0, 40):     # shipped 40 columns short of the grid
            s = slab[:, :Wp - cut].contiguous().to(dev)
            for bd in (border, (0, Hp, 0, Wp - cut)):
                for scaled in (False, True):
                    for odt in (torch.bfloat16, torch.float32):
                        args = (s, origin, origin, win, bd, scaled, odt)
                        got = gather_db(*args)
                        err, ok = max_ulp_err(torch, got,
                                              gather_db_reference(*args))
                        torch.cuda.synchronize()
                        # outside the rectangle (the grid pad included)
                        check(ok and not got[0, min(bd[1], Hp):].any()
                              and not got[0, :, min(bd[3], Wp):].any(),
                              f"gather_db slab window off by more than one "
                              f"ulp or pad not 0.0: slab {sdtype} cut {cut} "
                              f"border {bd} scaled {scaled} out {odt}: {err}")
                        worst = max(worst, err)
                        n_cases += 1
    Hs, _, Cf = slabs[torch.bfloat16].shape
    for name, sdtype, bd in (("bf16 memm", torch.bfloat16, border),
                             ("uint8 zarr", torch.uint8, (0, Hp, 0, Wp))):
        s = slabs[sdtype].to(dev)
        args = (s, origin, origin, win, bd, False, torch.bfloat16)
        # operations: the float path's per-element instructions for every
        # element inside the rectangle; uint8 codes are one table read
        by0, by1, bx0, bx1 = bd
        computed = (min(by1, H16) - max(by0, 0)) * (min(bx1, W16)
                                                    - max(bx0, 0)) * Cf
        ops = computed * per_elem if sdtype != torch.uint8 else 0
        b, by = bound_ms(s.numel() * s.element_size() + 8
                         + H16 * W16 * Cf * 2, ops, F32_INSTR_PER_S)
        r = dict(shape=[1, H16, W16, Cf], slab=list(s.shape),
                 slab_dtype=str(sdtype).replace("torch.", ""),
                 max_abs_err=worst,
                 ms=cuda_ms(torch, lambda: gather_db(*args)),
                 plain_ms=cuda_ms(torch, lambda: gather_db_reference(*args)),
                 bound_ms=b, bound_by=by, library_ms=None)
        results["gather_db"]["slab_window_" + name.split()[0]] = r
        print(f"gather_db slab window ({name}): {n_cases} cases within 1 "
              f"ulp (max abs err {worst}); slab {tuple(s.shape)} "
              f"{sdtype} -> (1, {H16}, {W16}, {Cf}) bf16: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{b:.4f} ms ({by}) [{card}]")
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn((1, H16, W16, cfg["start_filts"]), generator=g) * 2.0
    x.view(-1)[:7] = torch.tensor([float("nan")] * 3 + [float("inf")] * 2
                                  + [float("-inf"), -0.0])
    x = x.to(dev, torch.bfloat16)
    for got, want in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
        check(equal_nan(torch, got, want),
              f"relu_pool_skip != plain at {tuple(x.shape)}")
    torch.cuda.synchronize()
    n = x.numel()
    b3, by3 = bound_ms(n * 2 * 2 + n // 4 * 2, 2 * n)
    r = dict(shape=list(x.shape), max_abs_err=0.0,
             ms=cuda_ms(torch, lambda: relu_pool_skip(x)),
             plain_ms=cuda_ms(torch, lambda: relu_pool_skip_reference(x)),
             bound_ms=b3, bound_by=by3, library_ms=None)
    results["relu_pool_skip"]["slab_window"] = r
    print(f"relu_pool_skip slab geometry: bit-equal to plain; "
          f"{tuple(x.shape)} bf16: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {b3:.4f} ms ({by3}) [{card}]")


def first_eval_masks(torch, reader, cfg):
    """K4's inputs on the eval main path's first sub-batch: the
    ``(labels > 0) & threshold`` masks and the non-boundary crop boxes of
    the first column group's first sub-batch of patches, built with the
    port's own grid law, host label conversion and bbox op."""
    import numpy as np
    from crimac_unet_tpu_torch.ops.label_ops import (REFINE_THRESHOLD_HI,
                                                     REFINE_THRESHOLD_LO,
                                                     _valid_bbox_mask)
    from crimac_unet_tpu_torch.ops.patches import grid_dims, make_grid_starts
    from crimac_unet_tpu_torch.pipeline.infer_common import (
        _convert_labels_host, _grid_extent_rows)
    from crimac_unet_tpu_torch.pipeline.runner import sub_batch_shape

    wh, ww = cfg["patch_size"]
    o = cfg["patch_overlap"]
    sh, sw = wh - 2 * o, ww - 2 * o
    n_range, n_pings = reader.shape
    R = _grid_extent_rows(n_range, reader.get_seabed(0, n_pings),
                          reader.seabed_known(0, n_pings), wh, o)
    Cc = min(EVAL_CHUNK_COLS, grid_dims(0, n_pings, ww, o))
    Hp, Wp = R * sh + 2 * o, Cc * sw + 2 * o
    y1, x1 = min(n_range, R * sh + o), min(n_pings, (Cc - 1) * sw - o + ww)
    lab = np.full((Hp, Wp), -100.0, np.float32)
    lab[o:o + y1, o:o + x1] = reader.label_memmap()[:y1, :x1]
    sv = np.zeros((Hp, Wp), np.float32)
    sv[o:o + y1, o:o + x1] = reader.data_memmaps(
        [max(cfg["frequencies"])])[0][:y1, :x1]
    y0s, x0s = make_grid_starts(R, Cc, sh, sw, o, o, o)
    B, _, _ = sub_batch_shape(len(y0s), cfg["fwd_batch"])
    pad = np.zeros(max(B - len(y0s), 0), np.int32)
    y0s, x0s = (np.concatenate([a, pad])[:B] for a in (y0s, x0s))
    rows = (y0s[:, None] + np.arange(wh))[:, :, None]
    cols = (x0s[:, None] + np.arange(ww))[:, None, :]
    conv = _convert_labels_host(lab[rows, cols])
    thr = sv[rows, cols]
    mask = (conv > 0) & (thr > REFINE_THRESHOLD_LO) & \
        (thr < REFINE_THRESHOLD_HI)
    clip = _valid_bbox_mask(torch.from_numpy(conv != -100))
    return torch.from_numpy(mask), clip.contiguous()


def _box_clips(torch, B, H, W):
    """Clip boxes: full, inner, touching each edge in turn, and empty."""
    boxes = [(0, H, 0, W), (H // 8, H - H // 8, W // 8, W - W // 8),
             (0, H // 2, W // 4, W - W // 4), (H // 3, H, 1, W - 1),
             (2, H - 2, 0, W // 2), (1, H - 1, W // 3, W), (0, 0, 0, 0)]
    clip = torch.zeros((B, H, W), dtype=torch.bool)
    for b in range(B):
        y0, y1, x0, x1 = boxes[b % len(boxes)]
        clip[b, y0:y1, x0:x1] = True
    return clip


def _word_edge_closings(torch, g):
    """Where the kernel's 32-pixel words and 32-row bands end: widths and
    heights around them (below the disc's size too), one set pixel and
    one hole at each of columns 29-35, clip boxes ending on a word edge
    +-1."""
    cases = []
    for W in (31, 32, 33, 63, 64, 65, 255, 256, 257):
        for H in (1, 6, 7, 33):
            m = torch.stack([torch.rand((H, W), generator=g) < d
                             for d in (0.3, 0.6, 0.9)])
            c = torch.ones_like(m)
            c[1, :, :W - W % 32] = False
            c[2, H // 3:, 1:W - 1] = False
            cases.append((m, c))
    for x in range(29, 36):
        m = torch.zeros((2, 12, 64), dtype=torch.bool)
        m[0, 6, x] = True
        m[1] = True
        m[1, 6, x] = False
        cases.append((m, torch.ones_like(m)))
    for edge in (31, 32, 33, 63, 64, 65):
        m = torch.rand((2, 40, 96), generator=g) < 0.6
        c = torch.zeros_like(m)
        c[0, 3:37, 2:edge] = True
        c[1, :, edge:] = True
        cases.append((m, c))
    return cases


def _edge_centers(shape, rng, n=12):
    """Crop centres (range row, ping column) in a (n_range, n_pings)
    survey: its corners, crops straddling each edge, and random ones."""
    n_range, n_pings = shape
    fixed = [(0, 0), (-100, 50), (n_range - 1, n_pings - 1),
             (n_range + 50, n_pings + 50), (n_range // 2, -30),
             (10, n_pings - 5), (n_range - 20, n_pings // 2),
             (n_range // 2, n_pings // 2)]
    return fixed + [(int(rng.randint(-128, n_range + 128)),
                     int(rng.randint(-128, n_pings + 128)))
                    for _ in range(n)]


def phase_pool_gathers(torch, tmp, card):
    """The sample pools' gathers on the card against the host crops, at
    the training batch (4, 256, 256) on the phase-13 and phase-12
    surveys: ZarrSamplePool's data and labels bit-equal to
    ``crop_data`` / ``crop_labels``, crops across every survey edge
    included; ``gather_meta_crops`` within rtol 1e-5, atol 1e-6 of the
    host ``crop_meta`` for the six families, Inf and NaN in the same
    places."""
    import numpy as np
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data.device_pool import (DeviceSamplePool,
                                                        ZarrSamplePool,
                                                        gather_crops,
                                                        gather_meta_crops)
    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.data.meta_channels import crop_meta
    from crimac_unet_tpu_torch.data.zarr_reader import get_zarr_readers

    freqs, win = [18, 38, 120, 200], (256, 256)
    rng = np.random.RandomState(SEED + 7)
    zreaders = get_zarr_readers([2017], path_to_zarr_files=str(
        zarr_train_fixture(tmp)), minimum_shape=256)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pool = ZarrSamplePool(zreaders, freqs, win, device="cuda")
    torch.cuda.synchronize()
    upload = time.perf_counter() - t
    (z,) = zreaders
    samples = [(z, c) for c in _edge_centers(z.shape[::-1], rng)]
    for k in range(0, len(samples), 4):
        part = samples[k:k + 4]
        idx, starts = (torch.from_numpy(a).cuda()
                       for a in pool.prepare_batch(part))
        d, lab = gather_crops(pool.data, pool.labels, idx, starts, win)
        torch.cuda.synchronize()
        for b, (r, c) in enumerate(part):
            check(torch.equal(d[b].cpu(), torch.from_numpy(
                r.crop_data(c, win, freqs))) and torch.equal(
                lab[b].cpu(), torch.from_numpy(r.crop_labels(
                    c, win).astype(np.int32))),
                f"ZarrSamplePool gather != host crop at centre {c}")
    zms = cuda_ms(torch, lambda: gather_crops(pool.data, pool.labels, idx,
                                              starts, win))
    print(f"ZarrSamplePool: canvas {tuple(pool.data.shape)} float32 + "
          f"labels int32 = {(pool.data.numel() * 4 + pool.labels.numel() * 4)
                            / 1e6:.1f} MB uploaded in {upload:.2f} s; "
          f"gather of {len(samples)} crops (4, 256, 256) bit-equal to the "
          f"host crops (corners and every edge); gather {zms:.4f} ms a "
          f"batch [{card}]")
    del pool

    readers = [r for r in get_echograms(
        frequencies=freqs, minimum_shape=256,
        path_to_echograms=str(train_fixture(tmp))) if r.year == 2017]
    pool = DeviceSamplePool(readers, freqs, win, device="cuda",
                            meta_channels=META_CHANNELS_ALL)
    samples = [(r, c) for r in readers
               for c in _edge_centers(r.shape, rng, n=4)]
    worst = 0.0
    for k in range(0, len(samples), 4):
        part = samples[k:k + 4]
        idx, starts = (torch.from_numpy(a).cuda()
                       for a in pool.prepare_batch(part))
        got = gather_meta_crops(*pool.meta_vectors, idx, starts, win,
                                pool.meta_flags).cpu().numpy()
        for b, (r, c) in enumerate(part):
            want = crop_meta(r, c, win, META_CHANNELS_ALL)
            check(np.array_equal(np.isnan(got[b]), np.isnan(want))
                  and np.array_equal(np.isinf(got[b]), np.isinf(want))
                  and np.allclose(got[b], want, rtol=1e-5, atol=1e-6),
                  f"gather_meta_crops != host crop_meta at centre {c}")
            fin = np.isfinite(want)
            worst = max(worst, float(np.abs(got[b][fin] - want[fin]).max()))
    mms = cuda_ms(torch, lambda: gather_meta_crops(
        *pool.meta_vectors, idx, starts, win, pool.meta_flags))
    print(f"gather_meta_crops: {len(samples)} crops (7, 256, 256) within "
          f"rtol 1e-5, atol 1e-6 of the host crop_meta (max abs err "
          f"{worst:.3g}), Inf/NaN in the same places; {mms:.4f} ms a "
          f"batch of 4 [{card}]")


def phase_closing(torch, card, reader, cfg):
    """K4 bit-equal to its plain version on the eval path's first
    sub-batch shape: random masks of density 0 / 0.3 / 0.75 / 1 under
    the seven clip boxes, the survey's real masks and crop boxes, odd
    shapes and the word-edge cases; then its time beside the plain
    version and its bound."""
    from crimac_unet_tpu_torch.ops.closing import (binary_closing,
                                                   binary_closing_reference)
    dev = torch.device("cuda")
    real_mask, real_clip = first_eval_masks(torch, reader, cfg)
    B, H, W = real_mask.shape
    g = torch.Generator().manual_seed(SEED + 2)
    cases = [(real_mask, real_clip)]
    for density in (0.0, 0.3, 0.75, 1.0):
        m = torch.rand((B, H, W), generator=g) < density
        cases += [(m, _box_clips(torch, B, H, W)),
                  (m, torch.ones((B, H, W), dtype=torch.bool))]
    for odd in ((3, 37, 45), (2, 5, 6), (1, 1, 1)):
        cases.append((torch.rand(odd, generator=g) < 0.5,
                      _box_clips(torch, *odd)))
    cases += _word_edge_closings(torch, g)
    for m, c in cases:
        m, c = m.to(dev), c.to(dev)
        got, want = binary_closing(m, c), binary_closing_reference(m, c)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"binary_closing != plain at "
                                      f"{tuple(m.shape)}")
    m, c = real_mask.to(dev), real_clip.to(dev)
    n = m.numel()
    # operations: per 32-pixel output word, the disc's rows of half-width
    # 1, 2, 3, 3, 3, 2, 1 are 2 x 15 funnel shifts and as many ORs, 6 ORs
    # across rows, the same with AND for the erosion, one AND with the
    # clip: 133 integer operations
    words = B * H * ((W + 31) // 32)
    b, by = bound_ms(3 * n, 133 * words, INT32_OPS_PER_S)
    r = dict(max_abs_err=0.0,
             ms=cuda_ms(torch, lambda: binary_closing(m, c)),
             plain_ms=cuda_ms(torch, lambda: binary_closing_reference(m, c)),
             bound_ms=b, bound_by=by, library_ms=None)
    print(f"binary_closing: bit-equal to plain over {len(cases)} cases "
          f"(densities 0/0.3/0.75/1, 7 clip boxes, the survey's masks "
          f"({int(real_mask.sum())} px set), odd shapes, word edges); "
          f"({B}, {H}, {W}) "
          f"bool: kernel {r['ms']:.4f} ms (wrapper's host time "
          f"{host_ms(lambda: binary_closing(m, c)):.4f} ms a call), plain "
          f"{r['plain_ms']:.4f} ms, "
          f"bound {b:.4f} ms ({by}) [{card}]")
    # the train step's mask shapes: batch 4 (the reference recipe), 8 (the
    # pooled metadata bench), 16 (the fast preset and the metadata recipe)
    # and 32 (the fast recipe's b32 arm), patch 256
    for tb in (4, 8, 16, 32):
        m = (torch.rand((tb, 256, 256), generator=g) < 0.4).to(dev)
        c = _box_clips(torch, tb, 256, 256).to(dev)
        check(torch.equal(binary_closing(m, c),
                          binary_closing_reference(m, c)),
              f"binary_closing != plain at ({tb}, 256, 256)")
        torch.cuda.synchronize()
        bt, byt = bound_ms(3 * m.numel(), 133 * tb * 256 * 8,
                           INT32_OPS_PER_S)
        rt = dict(shape=[tb, 256, 256], max_abs_err=0.0,
                  ms=cuda_ms(torch, lambda: binary_closing(m, c)),
                  plain_ms=cuda_ms(torch,
                                   lambda: binary_closing_reference(m, c)),
                  bound_ms=bt, bound_by=byt, library_ms=None)
        r[f"train_batch_{tb}"] = rt
        print(f"binary_closing train shape ({tb}, 256, 256): bit-equal to "
              f"plain; kernel {rt['ms']:.4f} ms, plain {rt['plain_ms']:.4f} "
              f"ms, bound {bt:.4f} ms ({byt}) [{card}]")
    return r


# --------------------------------------------------------------- phase 3
def _predict_one(cfg, state_dict, reader, device):
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.pipeline.predict import predict_reader
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    import numpy as np
    runner = GriddedRunner(build_unet(cfg), state_dict, cfg, device=device)
    n_range, n_pings = reader.shape[::-1] if reader.data_format == "zarr" \
        else reader.shape
    out = np.zeros((2, n_range, n_pings), np.float16)
    for s, e, chunk, _ in predict_reader(runner, reader,
                                         cfg["preload_n_pings"]):
        out[:, :, s:e] = chunk
    return out


def phase_agreement(torch, tmp):
    import numpy as np
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_

    d = make_survey_dir(tmp / "small", year=2017, n_echograms=1, H=200,
                        W=600, seed=SEED)[0]
    reader = Echogram(d)
    cfg = {"patch_size": [64, 64], "patch_overlap": 8, "depth": 3,
           "start_filts": 8, "frequencies": [18, 38, 120, 200],
           "compute_dtype": "float32", "transfer_dtype": "float32",
           "output_dtype": "float16", "fwd_batch": 8,
           "preload_n_pings": 300}
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for fold in (True, False):
            predict_agreement(dict(cfg, fold_bn=fold), sd, reader,
                              f"fold_bn {fold}")
        eval_agreement(torch, dict(cfg, fold_bn=True), sd, reader)
        # the zarr survey: its reader, slab extents, seabed band law and
        # (eval) no border zeroing; bfloat16 transfer takes the codec's
        # converting decode where the native library is built
        from crimac_unet_tpu_torch.data import blosc_codec
        from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
        from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
        zreader = DataReaderZarr(make_zarr_survey(
            tmp / "small_zarr", year=2017, n_echograms=1, H=200, W=600,
            seed=SEED))
        print(f"small zarr survey: codec backend {blosc_codec.backend()}, "
              f"sv compressor {zreader.sv.compressor}")
        for transfer in ("float32", "bfloat16"):
            predict_agreement(dict(cfg, transfer_dtype=transfer), sd,
                              zreader, f"zarr, {transfer} transfer")
        eval_agreement(torch, dict(cfg, fold_bn=True), sd, zreader)
        new_paths_agreement(torch, cfg, sd, reader, zreader)
        train_agreement(torch, reader)
        pooled_step_agreement(torch, reader, zreader)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


_BIAS_BEFORE_BN = (".main.0.bias", ".main.3.bias", ".conv1.bias",
                   ".conv2.bias")


def _check_step_agreement(torch, runs, label):
    """Hold the card's train steps to the CPU's: ``runs[dev]`` = (labels
    after the train chain per step, losses, parameters before the first
    step and after each).  Labels identical, loss within 1e-4 relative,
    each update within 5e-2 relative in max-norm plus one ulp of its
    parameter (a conv bias ahead of a BatchNorm has zero gradient and is
    skipped).  Returns the worst relative update difference."""
    worst = 0.0
    (c0s, l0s, p0), (c1s, l1s, p1) = runs["cpu"], runs["cuda"]
    for k, (c0, c1, l0, l1) in enumerate(zip(c0s, c1s, l0s, l1s)):
        check(torch.equal(c0, c1),
              f"{label} {k + 1}: labels after the train chain differ "
              f"between CPU and card")
        check(abs(l1 - l0) <= 1e-4 * abs(l0),
              f"{label} {k + 1}: loss {l1} on the card, {l0} on CPU")
        for name in p0[0]:
            if name.endswith(_BIAS_BEFORE_BN):
                continue
            up = p1[k + 1][name] - p1[k][name]
            ref = p0[k + 1][name] - p0[k][name]
            ulp = float(p0[k][name].abs().max()) * 2 ** -23
            err = float((up - ref).abs().max())
            scale = float(ref.abs().max())
            check(err <= 5e-2 * scale + ulp,
                  f"{label} {k + 1}: {name} update off by {err} "
                  f"(max-norm {scale})")
            worst = max(worst, err / max(scale, 1e-30))
    return worst


def train_agreement(torch, reader):
    """One and two float32 train steps on the CPU and on the card (depth
    3, start_filts 8, patch 64, TF32 off, augmentation off) from the same
    weights and crops of the phase-3 echogram: the labels after the train
    chain identical (K4 against the plain closing), the loss within 1e-4
    relative, each update within 5e-2 relative in max-norm plus one ulp of
    its parameter (cuDNN and the CPU sum in other orders; a conv bias
    ahead of a BatchNorm has zero gradient and is skipped).  On the card
    the pooled crops equal the host crops, and with deterministic cuDNN
    the pooled step equals the host-crop step bit for bit."""
    import numpy as np
    from crimac_unet_tpu_torch.data.device_pool import (DeviceSamplePool,
                                                        gather_crops)
    from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
    from crimac_unet_tpu_torch.ops import augment
    from crimac_unet_tpu_torch.pipeline import engine

    cfg = {"patch_size": [64, 64], "depth": 3, "start_filts": 8,
           "frequencies": [18, 38, 120, 200], "lr": 0.005,
           "lr_reduction": 0.5, "lr_step": 1000, "momentum": 0.95,
           "compute_dtype": "float32"}
    win, freqs = (64, 64), cfg["frequencies"]
    rng = np.random.RandomState(SEED)
    H, W = reader.shape
    batches = []
    for _ in range(2):
        centers = []
        for j in range(4):     # two centers on schools, two anywhere
            if j < 2 and reader.objects:
                o = reader.objects[rng.randint(len(reader.objects))]
                centers.append(tuple(int(v) for v in
                                     o["indexes"][rng.randint(
                                         o["n_pixels"])]))
            else:
                centers.append((int(rng.randint(H)), int(rng.randint(W))))
        d = np.stack([reader.crop_data(c, win, freqs) for c in centers])
        lab = np.stack([reader.crop_labels(c, win) for c in centers])
        batches.append((centers, torch.from_numpy(d),
                        torch.from_numpy(lab.astype(np.int32))))

    def fresh(dev):
        net = init_train_(build_unet(cfg), torch.Generator().manual_seed(
            SEED)).to(dev)
        return net, engine.init_train_state(net, cfg)

    def params(net):
        return {n: q.detach().cpu().clone() for n, q in
                net.named_parameters()}

    real_augment = augment.augment_train
    augment.augment_train = lambda gen, d, lab: (d, lab)
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            net, state = fresh(dev)
            step = engine.make_train_step(cfg)
            chains, losses, ps = [], [], [params(net)]
            for _, d, lab in batches:
                chains.append(engine._train_labels(d.to(dev), lab.to(dev),
                                                   -1).cpu())
                losses.append(float(step(state, d.to(dev), lab.to(dev),
                                         None)))
                ps.append(params(net))
            runs[dev] = (chains, losses, ps)
        worst = _check_step_agreement(torch, runs, "train step")
        print(f"train steps 1-2, CPU vs card (float32, TF32 off): labels "
              f"identical, losses {runs['cpu'][1]} vs {runs['cuda'][1]}, "
              f"worst relative update difference {worst:.2e}")

        pool = DeviceSamplePool([reader], freqs, win, device="cuda")
        centers, d, lab = batches[0]
        idx, starts = (torch.from_numpy(a).cuda() for a in
                       pool.prepare_batch([(reader, c) for c in centers]))
        gd, gl = gather_crops(pool.data, pool.labels, idx, starts, win)
        check(torch.equal(gd.cpu(), d) and torch.equal(gl.cpu(), lab),
              "pooled crops differ from the host crops")
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            (n1, s1), (n2, s2) = fresh("cuda"), fresh("cuda")
            la = engine.make_train_step(cfg)(s1, d.cuda(), lab.cuda(), None)
            lb = engine.make_train_step_pooled(cfg)(
                s2, pool.data, pool.labels, idx, starts, None)
            check(torch.equal(la, lb) and all(
                torch.equal(a, b) for a, b in zip(n1.parameters(),
                                                  n2.parameters())),
                  "the pooled train step differs from the host-crop step")
        finally:
            torch.backends.cudnn.deterministic = det
        print("pooled train step on the card: crops and step equal to the "
              "host-crop step's")
    finally:
        augment.augment_train = real_augment


def pooled_step_agreement(torch, reader, zreader):
    """One pooled float32 train step on the CPU and on the card (depth 3,
    start_filts 8, patch 64, TF32 off, augmentation off) from the same
    weights and pool coordinates, for a zarr pool (``ZarrSamplePool`` on
    the phase-3 zarr survey) and for metadata early and late inject
    (``DeviceSamplePool`` with the six families, the metadata crops
    computed on each device): held as ``_check_step_agreement`` holds
    the host-crop steps."""
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data.device_pool import (DeviceSamplePool,
                                                        ZarrSamplePool,
                                                        gather_crops)
    from crimac_unet_tpu_torch.models.unet import build_unet, init_train_
    from crimac_unet_tpu_torch.ops import augment
    from crimac_unet_tpu_torch.pipeline import engine

    base = {"patch_size": [64, 64], "depth": 3, "start_filts": 8,
            "frequencies": [18, 38, 120, 200], "lr": 0.005,
            "lr_reduction": 0.5, "lr_step": 1000, "momentum": 0.95,
            "compute_dtype": "float32"}
    win, freqs = (64, 64), base["frequencies"]
    cases = [("zarr", base, ZarrSamplePool, zreader)] + [
        (f"meta {'late' if late else 'early'}",
         dict(base, meta_channels=META_CHANNELS_ALL, late_meta_inject=late),
         DeviceSamplePool, reader) for late in (False, True)]
    real = augment.augment_train, augment.augment_train_meta
    augment.augment_train = lambda gen, d, lab: (d, lab)
    augment.augment_train_meta = lambda gen, d, m, lab: (d, m, lab)
    try:
        for label, cfg, cls, rdr in cases:
            # two crops on schools, one across the survey's first ping,
            # one in the middle
            boxes = [o["bounding_box"] for o in rdr.objects[:2]]
            centers = [((y0 + y1) // 2, (x0 + x1) // 2)
                       for y0, y1, x0, x1 in boxes] + [(40, 5), (100, 300)]
            runs = {}
            for dev in ("cpu", "cuda"):
                meta = cfg.get("meta_channels")
                pool = cls([rdr], freqs, win, meta_channels=meta, device=dev)
                idx, starts = (torch.from_numpy(a).to(dev) for a in
                               pool.prepare_batch([(rdr, c)
                                                   for c in centers]))
                d, lab = gather_crops(pool.data, pool.labels, idx, starts,
                                      win)
                chain = engine._train_labels(d, lab, -1).cpu()
                net = init_train_(build_unet(cfg), torch.Generator(
                    ).manual_seed(SEED)).to(dev)
                state = engine.init_train_state(net, cfg)
                p0 = {n: q.detach().cpu().clone() for n, q in
                      net.named_parameters()}
                loss = engine.make_train_step_pooled(cfg)(
                    state, pool.data, pool.labels, idx, starts, None,
                    meta_vectors=pool.meta_vectors, flags=pool.meta_flags)
                runs[dev] = ([chain], [float(loss)], [p0, {
                    n: q.detach().cpu().clone() for n, q in
                    net.named_parameters()}])
            worst = _check_step_agreement(torch, runs,
                                          f"pooled {label} step")
            print(f"pooled {label} train step, CPU vs card (float32, TF32 "
                  f"off): labels identical, loss {runs['cpu'][1][0]} vs "
                  f"{runs['cuda'][1][0]}, worst relative update difference "
                  f"{worst:.2e}")
    finally:
        augment.augment_train, augment.augment_train_meta = real


def new_paths_agreement(torch, cfg, sd, reader, zreader):
    """The serving preset's modes and the metadata channels, CPU vs card:
    slab mode (memm; zarr with uint8 transfer), the static grid (patch and
    slab), metadata early and late inject (patch and slab prediction,
    evaluation)."""
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    predict_agreement(dict(cfg, infer_mode="slab"), sd, reader, "memm slab")
    predict_agreement(dict(cfg, infer_mode="slab", transfer_dtype="uint8"),
                      sd, zreader, "zarr slab, uint8 transfer")
    predict_agreement(dict(cfg, static_grid=True), sd, reader,
                      "memm static grid, patch")
    predict_agreement(dict(cfg, static_grid=True, infer_mode="slab"), sd,
                      zreader, "zarr static grid, slab")
    for late in (False, True):
        mcfg = dict(cfg, meta_channels=META_CHANNELS_ALL,
                    late_meta_inject=late)
        msd = init_random_(build_unet(mcfg), torch.Generator().manual_seed(
            SEED + 5)).state_dict()
        inject = "late" if late else "early"
        for mode in ("patch", "slab"):
            predict_agreement(dict(mcfg, infer_mode=mode), msd, reader,
                              f"meta {inject} inject, {mode}")
        eval_agreement(torch, mcfg, msd, reader, modes=("all",))


def predict_agreement(cfg, sd, reader, label):
    """The predict path on the CPU (plain versions) and on the card
    (kernels): identical write masks, probabilities within 2 float16
    ulp."""
    import numpy as np
    cpu = _predict_one(cfg, sd, reader, "cpu")
    gpu = _predict_one(cfg, sd, reader, "cuda")
    check(np.array_equal(cpu == 0, gpu == 0),
          f"write masks differ CPU vs card ({label})")
    check((cpu != 0).any(), f"nothing written ({label})")
    a, b = cpu.astype(np.float32), gpu.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(cpu), np.abs(gpu))).astype(np.float32)
    diff = np.abs(a - b)
    check(np.all(diff <= 2 * ulp),
          f"probabilities differ by more than 2 f16 ulp ({label}): "
          f"{int((diff > 2 * ulp).sum())} px, max {diff.max()}")
    print(f"agreement ({label}): masks identical, max |dprob| "
          f"{diff.max()} over {int((cpu != 0).sum())} written px")


def _curve_scores(hist):
    """(max-F1, average precision) of a PR histogram."""
    import numpy as np
    from crimac_unet_tpu_torch.ops import metrics
    curve = metrics.pr_curve_from_histogram(hist)
    ap = -np.sum(np.diff(curve["recall"]) * curve["precision"][:-1])
    return metrics.max_f1(curve)[0], float(ap)


def eval_agreement(torch, cfg, sd, reader, modes=("all", "region",
                                                    "trace")):
    """Gridded evaluation on the CPU (plain versions) and on the card
    (kernels): identical per-class pixel counts (integer label algebra),
    max-F1 and AP within 2e-3 (float32 sums in another order move a score
    by a float16 ulp, which shifts its bin; tests/test_eval_parity.py)."""
    import numpy as np
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    meta = "meta " if cfg.get("meta_channels") else ""
    for mode in modes:
        hists = [evaluate_reader(GriddedRunner(build_unet(cfg), sd, cfg,
                                               device=device), reader,
                                 metrics.new_histogram(), eval_mode=mode)
                 for device in ("cpu", "cuda")]
        cpu, gpu = hists
        check(np.array_equal(cpu.sum(axis=1), gpu.sum(axis=1)),
              f"eval {mode}: per-class counts differ CPU vs card: "
              f"{cpu.sum(axis=1)} vs {gpu.sum(axis=1)}")
        check(cpu[0].sum() > 0 and cpu[1].sum() > 0,
              f"eval {mode}: a class has no scored pixel")
        (f_c, ap_c), (f_g, ap_g) = _curve_scores(cpu), _curve_scores(gpu)
        check(abs(f_c - f_g) < 2e-3 and abs(ap_c - ap_g) < 2e-3,
              f"eval {mode}: F1 {f_c} vs {f_g}, AP {ap_c} vs {ap_g}")
        print(f"eval agreement ({meta}{reader.data_format}, {mode}): "
              f"per-class "
              f"counts identical "
              f"{cpu.sum(axis=1).tolist()}, |dF1| {abs(f_c - f_g):.3g}, "
              f"|dAP| {abs(ap_c - ap_g):.3g}")


# --------------------------------------------------------------- phase 4
def main_setup(torch, tmp):
    """The main path's survey (one seeded 1000 x 4000 x 4 memm echogram)
    and config (``main_config``)."""
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram

    t0 = time.perf_counter()
    ech_dir = tmp / "survey"
    reader = Echogram(make_survey_dir(ech_dir, year=2017, n_echograms=1,
                                      H=1000, W=4000, seed=SEED)[0])
    reader.get_seabed()          # estimated once, cached to seabed.npy
    reader.label_memmap()        # heave-reverted labels, written once
    print(f"survey {reader.shape} x 4 written, seabed estimated in "
          f"{time.perf_counter() - t0:.1f} s")
    return ech_dir, reader, main_config()


def main_config():
    """The main path's config (the baseline keys of
    crimac_unet_tpu_torch/configs/config_baseline.yaml, bf16 transfer)."""
    from crimac_unet_tpu_torch.config import parse_config_options
    return parse_config_options({
        "random_seed": 10, "frequencies": [18, 38, 120, 200],
        "data_mode": "memm", "patch_size": [256, 256], "patch_overlap": 20,
        "preload_n_pings": 1000, "save_prediction_surveys": [2017],
        "resume_writing": False, "compute_dtype": "bfloat16",
        "fwd_batch": 32, "fold_bn": True, "pipeline_depth": 3,
        "static_grid": False, "infer_mode": "patch",
        "transfer_dtype": "bfloat16", "output_dtype": "float16",
        "depth": 5, "start_filts": 64, "device": "cuda"})


def _device_us(event):
    """Self device time of a device-side profiler event (kernel, memcpy,
    memset) in us; 0 for host ops, whose launched kernels carry it."""
    if not str(getattr(event, "device_type", "")).endswith("CUDA"):
        return 0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0


def profile_run(torch, run, card):
    """One more run of the main path under torch.profiler: device time by
    kernel and its sum against the wall (reported, never a failure)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    rows = sorted(((_device_us(e), e.count, e.key)
                   for e in prof.key_averages() if _device_us(e) > 0),
                  reverse=True)
    if not rows:
        print("profiler: no device time recorded (device share not "
              "measured)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profiled run [{card}]: device activity {busy_ms:.3f} ms in "
          f"{wall_s * 1e3:.3f} ms wall ({100 * busy_ms / (wall_s * 1e3):.1f}"
          f" % summed over streams); top device time:")
    for us, n, key in rows[:15]:
        print(f"  {us / 1e3:9.3f} ms  n={n:<5d} {key[:100]}")


def phase_main(torch, cuda_lib, ech_dir, reader, cfg, card):
    import numpy as np
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    model = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED))
    n_params = sum(p.numel() for p in model.parameters())
    sd = model.state_dict()
    out_dir = ech_dir.parent / "preds"
    out_dir.mkdir()
    n_range, n_pings = reader.shape
    launches = {}

    def run(runner, label, out=out_dir):
        cuda_lib.reset_launches()
        f0 = runner.forwards
        t = time.perf_counter()
        run_save_predictions(
            cfg, runner, memm_partition(cfg, ech_dir), str(out))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = dict(cuda_lib.launches)
        fwd = runner.forwards - f0
        pred = np.load(out / f"{reader.name}_pred.npy")
        check(pred.shape == (2, n_range, n_pings)
              and pred.dtype == np.float16,
              f"{label}: prediction {pred.shape} {pred.dtype}")
        check(np.isfinite(pred).all() and pred.min() >= 0
              and pred.max() <= 1, f"{label}: prediction not in [0, 1]")
        check((pred != 0).any(), f"{label}: nothing written")
        print(f"{label}: {fwd} forwards, launches {counts}, "
              f"{dt:.3f} s = {n_pings / dt:.1f} pings/s, written px "
              f"{int((pred[0] != 0).sum())} [{card}]")
        return counts, fwd, dt

    # folded BatchNorm, the serving default: gather_db + relu_pool_skip
    runner = GriddedRunner(build_unet(cfg), sd, cfg)
    run(runner, "warm-up (cuDNN plans, allocator)")
    runner.timer.reset()
    p0 = runner.patches_processed
    torch.cuda.reset_peak_memory_stats()
    counts, fwd, dt = run(runner, "main path, BatchNorm folded")
    check(fwd > 0 and counts["gather_db"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["maxpool2x2"] == 0,
          f"folded run: launches {counts} for {fwd} forwards")
    launches["gather_db"] = counts["gather_db"]
    launches["relu_pool_skip"] = counts["relu_pool_skip"]
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, U-Net {n_params} parameters, "
          f"{runner.patches_processed - p0} patches in {fwd} forwards")
    print(f"PhaseTimer, main path, BatchNorm folded [{card}]:")
    print(runner.timer.report())
    profile_run(torch, lambda: run(runner, "profiled run")[2], card)

    by_path = {"memm_predict": counts}

    # unfolded BatchNorm (fold_bn: false): gather_db + maxpool2x2; its own
    # directory, so the folded store stays for phase 11
    runner = GriddedRunner(build_unet(cfg), sd, dict(cfg, fold_bn=False))
    (out_dir.parent / "preds_unfolded").mkdir()
    counts, fwd, _ = run(runner, "main path, BatchNorm unfolded",
                         out_dir.parent / "preds_unfolded")
    check(fwd > 0 and counts["gather_db"] == fwd
          and counts["maxpool2x2"] == fwd and counts["relu_pool_skip"] == 0,
          f"unfolded run: launches {counts} for {fwd} forwards")
    launches["maxpool2x2"] = counts["maxpool2x2"]
    by_path["memm_predict_unfolded"] = counts
    return launches, n_pings / dt, by_path, out_dir


# --------------------------------------------------------------- phase 5
def phase_eval(torch, cuda_lib, ech_dir, reader, cfg, card):
    """The evaluation main path at full width through ``evaluate_survey``
    on the memm partition of the phase-4 survey."""
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    cfg = dict(cfg, eval_mode="all", partition_predict="selected surveys",
               evaluation_surveys=[2017], transfer_dtype="bfloat16")
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    part = make_partition(cfg, path_to_echograms=str(ech_dir))
    readers = part.get_survey_readers(part.get_evaluation_surveys()[0])
    check(len(readers) == 1, f"partition found {len(readers)} readers")
    n_pings = reader.shape[1]
    runner = GriddedRunner(build_unet(cfg), sd, cfg)

    def run(mode, label):
        cuda_lib.reset_launches()
        f0 = runner.forwards
        t = time.perf_counter()
        curve = evaluate_survey(runner, readers, mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
        f1 = float(curve["F1"].max())
        # the lowest threshold scores every counted pixel: a non-empty
        # curve has a total > 0, and precision > 0 there means positives
        check(len(curve["thresholds"]) > 0 and curve["precision"][0] > 0,
              f"{label}: no scored pixels or no positives")
        check(0.0 <= f1 <= 1.0, f"{label}: F1 {f1}")
        print(f"{label}: {fwd} sub-batches, launches {counts}, {dt:.3f} s "
              f"= {n_pings / dt:.1f} pings/s, max F1 {f1:.6f}, "
              f"{len(curve['thresholds'])} thresholds, positive share at "
              f"the lowest threshold {curve['precision'][0]:.6f} [{card}]")
        return counts, fwd, dt

    run("all", "eval warm-up (cuDNN plans, allocator)")
    runner.timer.reset()
    torch.cuda.reset_peak_memory_stats()
    counts, fwd, dt = run("all", "eval main path, mode all")
    check(fwd > 0 and counts["binary_closing"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["gather_db"] == 0
          and counts["maxpool2x2"] == 0,
          f"eval run: launches {counts} for {fwd} sub-batches")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    print(f"PhaseTimer, eval main path [{card}]:")
    print(runner.timer.report())
    profile_run(torch, lambda: run("all", "eval profiled run")[2], card)
    r_counts, r_fwd, _ = run("region", "eval, mode region")
    check(r_fwd > 0 and r_counts["binary_closing"] == r_fwd,
          f"region run: launches {r_counts} for {r_fwd} sub-batches")
    return counts, n_pings / dt


# --------------------------------------------------------------- phase 6
def zarr_setup(torch, tmp):
    """The zarr paths' survey: the JAX package's bench.py survey (1000
    range x 4000 pings x 4 frequencies, seed 3, 24 schools) written by the
    port's fixture, and the codec that serves it."""
    from crimac_unet_tpu_torch.data import blosc_codec
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr

    t0 = time.perf_counter()
    sv = make_zarr_survey(tmp / "zarr", year=2017, n_echograms=1, H=1000,
                          W=4000, seed=3, n_schools=24)
    reader = DataReaderZarr(sv)
    reader.get_seabed(0, None)       # the bottom-store scan, once
    native = blosc_codec.scatter_available()
    print(f"zarr survey {reader.shape} (pings, range) x "
          f"{len(reader.frequencies)} written in "
          f"{time.perf_counter() - t0:.1f} s; codec backend "
          f"{blosc_codec.backend()}"
          + ("" if native else f" (native chunkio not built: "
                               f"{str(blosc_codec.build_error).strip()[-300:]})"))
    print(f"sv store compressor: {reader.sv.compressor}")
    return sv, reader


def _check_store(path, n_pings, n_range, label):
    import numpy as np
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    g = ZGroup.open(path)
    ann = g["annotation"]
    check(ann.shape == (2, n_pings, n_range) and ann.dtype == np.float16,
          f"{label}: annotation {ann.shape} {ann.dtype}")
    check(list(g["category"][:]) == [27, 1],
          f"{label}: category {g['category'][:]}")
    check(g["ping_time"].shape == (n_pings,), f"{label}: ping_time "
                                              f"{g['ping_time'].shape}")
    pred = ann[:]
    check(np.isfinite(pred).all() and pred.min() >= 0 and pred.max() <= 1,
          f"{label}: prediction not in [0, 1]")
    check((pred != 0).any(), f"{label}: nothing written")
    return pred, ann.compressor


def phase_zarr_main(torch, cuda_lib, tmp, sv, reader, cfg, card):
    """The zarr prediction main path at full width through
    ``save_survey_predictions_zarr``, then the docker entry."""
    import os
    import numpy as np
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline import dockerscript
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    cfg = dict(cfg, data_mode="zarr")
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    n_pings, n_range = reader.shape
    target = str(tmp / "zarr_out" / f"{reader.name}_pred.zarr")
    runner = GriddedRunner(build_unet(cfg), sd, cfg)

    def run(label):
        cuda_lib.reset_launches()
        f0 = runner.forwards
        t = time.perf_counter()
        save_survey_predictions_zarr(runner, reader, target,
                                     preload_n_pings=cfg["preload_n_pings"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
        pred, comp = _check_store(target, n_pings, n_range, label)
        print(f"{label}: {fwd} forwards, launches {counts}, {dt:.3f} s = "
              f"{n_pings / dt:.1f} pings/s, written px "
              f"{int((pred[0] != 0).sum())}, store compressor {comp} "
              f"[{card}]")
        return counts, fwd, dt, pred

    run("zarr warm-up (cuDNN plans, allocator)")
    runner.timer.reset()
    counts, fwd, dt, pred = run("zarr main path, BatchNorm folded")
    check(fwd > 0 and counts["gather_db"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["maxpool2x2"] == 0,
          f"zarr run: launches {counts} for {fwd} forwards")
    print(f"PhaseTimer, zarr main path [{card}]:")
    print(runner.timer.report())
    profile_run(torch, lambda: run("zarr profiled run")[2], card)

    # the docker entry: no config file (the flagship defaults), the same
    # seeded weights as a reference .pt
    ckpt = tmp / "zarr_model.pt"
    torch.save(sd, ckpt)
    env = {"MODELWEIGHTS": str(ckpt), "SURVEY_PATH": sv,
           "OUTPUT_DIR": str(tmp / "docker_out"), "PRED_FILE": "pred.zarr"}
    saved = {k: os.environ.get(k) for k in list(env) + ["CONFIG_PATH"]}
    os.environ.update(env)
    os.environ.pop("CONFIG_PATH", None)
    try:
        cuda_lib.reset_launches()
        t = time.perf_counter()
        docker_runner = dockerscript.main()
        torch.cuda.synchronize()
        ddt = time.perf_counter() - t
        d_counts = dict(cuda_lib.launches)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    d_fwd = docker_runner.forwards
    check(d_fwd > 0 and d_counts["gather_db"] == d_fwd
          and d_counts["relu_pool_skip"] == d_fwd,
          f"docker run: launches {d_counts} for {d_fwd} forwards")
    d_pred, _ = _check_store(tmp / "docker_out" / "pred.zarr", n_pings,
                             n_range, "docker entry")
    # the same weights and geometry: the same write mask, probabilities
    # within 2 float16 ulp (bit-equal unless cuDNN picks another algorithm)
    check(np.array_equal(d_pred == 0, pred == 0),
          "docker entry's write mask differs from the main path's")
    diff = np.abs(d_pred.astype(np.float32) - pred.astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(d_pred), np.abs(pred))).astype(
        np.float32)
    check(np.all(diff <= 2 * ulp), f"docker entry's probabilities differ "
                                   f"from the main path's: max {diff.max()}")
    print(f"docker entry (no CONFIG_PATH, flagship defaults): {d_fwd} "
          f"forwards, launches {d_counts}, {ddt:.3f} s = "
          f"{n_pings / ddt:.1f} pings/s including its model build; write "
          f"mask equal to the main path's, max |dprob| {diff.max()} "
          f"[{card}]")
    return counts, d_counts, n_pings / dt, pred, Path(target).parent


# --------------------------------------------------------------- phase 7
def phase_zarr_eval(torch, cuda_lib, reader, cfg, card):
    """Zarr evaluation at full width: ``evaluate_reader`` (mode all)."""
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    cfg = dict(cfg, data_mode="zarr", transfer_dtype="bfloat16")
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    runner = GriddedRunner(build_unet(cfg), sd, cfg)
    n_pings = reader.shape[0]

    def run(label):
        cuda_lib.reset_launches()
        f0 = runner.forwards
        t = time.perf_counter()
        hist = evaluate_reader(runner, reader, metrics.new_histogram(
            runner.device), eval_mode="all", chunk_cols=EVAL_CHUNK_COLS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
        f1, ap = _curve_scores(hist)
        check(hist[0].sum() > 0 and hist[1].sum() > 0 and 0 <= f1 <= 1,
              f"{label}: counts {hist.sum(axis=1)}, F1 {f1}")
        print(f"{label}: {fwd} sub-batches, launches {counts}, {dt:.3f} s "
              f"= {n_pings / dt:.1f} pings/s, per-class counts "
              f"{hist.sum(axis=1).tolist()}, max F1 {f1:.6f} [{card}]")
        return counts, fwd, dt

    run("zarr eval warm-up (cuDNN plans, allocator)")
    runner.timer.reset()
    counts, fwd, dt = run("zarr eval, mode all")
    check(fwd > 0 and counts["binary_closing"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["gather_db"] == 0
          and counts["maxpool2x2"] == 0,
          f"zarr eval run: launches {counts} for {fwd} sub-batches")
    print(f"PhaseTimer, zarr eval [{card}]:")
    print(runner.timer.report())
    return counts, n_pings / dt

# --------------------------------------------------------------- phase 8
def _spy_grid(runner, name):
    """Record the (R, C) grid of every chunk the runner's ``name``
    program (``_predict_patches`` or ``_predict_slab``) runs."""
    seen = []
    real = getattr(runner, name)
    at = (5, 6) if name == "_predict_patches" else (2, 3)

    def spy(*args, **kwargs):
        seen.append((args[at[0]], args[at[1]]))
        return real(*args, **kwargs)
    setattr(runner, name, spy)
    return seen


def phase_serving(torch, cuda_lib, tmp, reader, patch_pred, card):
    """The JAX package's production preset (config_serving.yaml: zarr,
    ``infer_mode: slab``, ``static_grid``, uint8 transfer and output) at
    full width on the phase-6 zarr survey through
    ``save_survey_predictions_zarr``: a warm-up, a timed run, a profiled
    run; the store is read back and its written set held against the
    phase-6 patch-mode store's."""
    from crimac_unet_tpu_torch.config import (SERVING_PRESET,
                                              parse_config_options)
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    cfg = parse_config_options(dict(SERVING_PRESET, device="cuda"))
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    runner = GriddedRunner(build_unet(cfg), sd, cfg)
    check(runner.infer_mode == "slab" and runner.static_grid
          and runner.transfer_dtype == runner.output_dtype == "uint8",
          "the serving preset did not set slab / static grid / uint8")
    grids = _spy_grid(runner, "_predict_slab")
    n_pings, n_range = reader.shape
    target = str(tmp / "serving_out" / f"{reader.name}_pred.zarr")

    def run(label):
        cuda_lib.reset_launches()
        f0 = runner.forwards
        t = time.perf_counter()
        save_survey_predictions_zarr(runner, reader, target,
                                     preload_n_pings=cfg["preload_n_pings"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
        pred, _ = _check_store(target, n_pings, n_range, label)
        print(f"{label}: {fwd} slab forwards, launches {counts}, {dt:.3f} s "
              f"= {n_pings / dt:.1f} pings/s, written px "
              f"{int((pred[0] != 0).sum())} [{card}]")
        return counts, fwd, dt, pred

    run("serving preset warm-up (cuDNN plans, allocator)")
    runner.timer.reset()
    grids.clear()
    counts, fwd, dt, pred = run("serving preset (zarr, slab, static grid, "
                                "uint8 in/out)")
    check(fwd > 0 and counts["gather_db"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["maxpool2x2"] == 0
          and counts["binary_closing"] == 0,
          f"serving run: launches {counts} for {fwd} forwards")
    check(len(set(grids)) == 1, f"static grid ran {sorted(set(grids))}")
    print(f"serving preset: one grid {grids[0]} for {len(grids)} chunks")
    print(f"PhaseTimer, serving preset [{card}]:")
    print(runner.timer.report())
    profile_run(torch, lambda: run("serving profiled run")[2], card)
    if patch_pred is not None:
        # the write mask is label and seabed algebra, the same in slab and
        # patch mode; uint8 codes store p < 1/510 as 0, so the written set
        # can only shrink
        check(not ((pred != 0) & (patch_pred == 0)).any(),
              "serving store writes pixels the patch-mode store does not")
        print(f"serving store: written set within the phase-6 patch store's "
              f"({int((pred != 0).sum())} of {int((patch_pred != 0).sum())} "
              f"px)")
    return counts, n_pings / dt


# --------------------------------------------------------------- phase 9
def phase_static_grid(torch, cuda_lib, tmp, cfg, card):
    """``static_grid`` over a memm survey of two echograms of different
    heights and seabed depths through ``run_save_predictions``: one grid
    shape serves both, and each output equals the per-reader grids' (write
    masks identical, probabilities within 2 float16 ulp; float32 compute
    with TF32 off, since another sub-batch size may take another cuDNN
    algorithm, whose float32 sums differ in the last bits)."""
    import numpy as np
    from crimac_unet_tpu_torch.data.fixtures import (make_synthetic_echogram,
                                                     write_memmap_echogram)
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    root = tmp / "static_memm"
    rng = np.random.RandomState(SEED)
    n_pings = 0
    for i, (h, frac, row) in enumerate(((1000, 0.4, 380), (1200, 0.85, 990))):
        data, labels, heave, _ = make_synthetic_echogram(
            h, 2000, rng, n_schools=12, seabed_frac=frac)
        d = write_memmap_echogram(root, f"2019843-D2019042{7 + i}-T06261{i}",
                                  data, labels, heave)
        np.save(Path(d) / "seabed.npy", np.full(2000, row, np.int64))
        n_pings += 2000
    cfg = dict(cfg, compute_dtype="float32", save_prediction_surveys=[2019])
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, grids = {}, {}
    try:
        for static in (False, True):
            scfg = dict(cfg, static_grid=static)
            runner = GriddedRunner(build_unet(scfg), sd, scfg)
            grids[static] = _spy_grid(runner, "_predict_patches")
            out = tmp / f"static_out_{static}"
            out.mkdir()
            cuda_lib.reset_launches()
            t = time.perf_counter()
            run_save_predictions(
                scfg, runner, memm_partition(scfg, root), str(out))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts, fwd = dict(cuda_lib.launches), runner.forwards
            check(fwd > 0 and counts["gather_db"] == fwd
                  and counts["relu_pool_skip"] == fwd,
                  f"static_grid {static}: launches {counts} for {fwd} "
                  f"forwards")
            outs[static] = {p.name: np.load(p) for p in out.iterdir()}
            print(f"memm survey of 2 echograms (1000 and 1200 range x 2000 "
                  f"pings), static_grid {static}, float32: grids "
                  f"{sorted(set(grids[static]))}, {fwd} forwards, launches "
                  f"{counts}, {dt:.3f} s = {n_pings / dt:.1f} pings/s "
                  f"[{card}]")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    check(len(set(grids[False])) > 1 and len(set(grids[True])) == 1,
          f"grids: per-reader {sorted(set(grids[False]))}, static "
          f"{sorted(set(grids[True]))}")
    check(sorted(outs[True]) == sorted(outs[False]) and len(outs[True]) == 2,
          f"outputs {sorted(outs[True])} vs {sorted(outs[False])}")
    worst = 0.0
    for name, a in outs[True].items():
        b = outs[False][name]
        check(a.shape == b.shape and np.array_equal(a == 0, b == 0)
              and (a != 0).any(), f"{name}: write masks differ")
        diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
        check(np.all(diff <= 2 * ulp), f"{name}: static grid off the "
                                       f"per-reader grid by {diff.max()}")
        worst = max(worst, float(diff.max()))
    print(f"static grid: one grid for both echograms, outputs equal to the "
          f"per-reader grids' (masks identical, max |dprob| {worst})")
    return counts


# -------------------------------------------------------------- phase 10
def phase_meta(torch, cuda_lib, ech_dir, reader, cfg, card):
    """Metadata channels at full width on the phase-4 survey, the six
    families of config_meta_train.yaml: early-inject prediction
    (``run_save_predictions``) and evaluation (``evaluate_survey``), then
    late-inject prediction; each a warm-up and a timed run."""
    import numpy as np
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    n_range, n_pings = reader.shape
    paths, rates = {}, {}
    for late in (False, True):
        inject = "late" if late else "early"
        mcfg = dict(cfg, meta_channels=META_CHANNELS_ALL,
                    late_meta_inject=late, eval_mode="all",
                    partition_predict="selected surveys",
                    evaluation_surveys=[2017])
        sd = init_random_(build_unet(mcfg), torch.Generator().manual_seed(
            SEED + 5)).state_dict()
        runner = GriddedRunner(build_unet(mcfg), sd, mcfg)
        check(runner.use_meta, "metadata channels not on")
        out = ech_dir.parent / f"meta_{inject}"
        out.mkdir()

        def run(label):
            cuda_lib.reset_launches()
            f0 = runner.forwards
            t = time.perf_counter()
            run_save_predictions(
                mcfg, runner, memm_partition(mcfg, ech_dir), str(out))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
            pred = np.load(out / f"{reader.name}_pred.npy")
            check(pred.shape == (2, n_range, n_pings)
                  and np.isfinite(pred).all() and (pred != 0).any()
                  and pred.max() <= 1, f"{label}: prediction")
            print(f"{label}: {fwd} forwards, launches {counts}, {dt:.3f} s "
                  f"= {n_pings / dt:.1f} pings/s [{card}]")
            return counts, fwd, dt

        run(f"meta {inject} inject warm-up")
        runner.timer.reset()
        counts, fwd, dt = run(f"meta {inject} inject prediction (7 bands, "
                              f"K1 scaled)")
        check(fwd > 0 and counts["gather_db"] == fwd
              and counts["relu_pool_skip"] == fwd
              and counts["maxpool2x2"] == 0,
              f"meta {inject}: launches {counts} for {fwd} forwards")
        print(f"PhaseTimer, meta {inject} inject prediction [{card}]:")
        print(runner.timer.report())
        paths[f"memm_meta_{inject}"] = counts
        rates[f"meta {inject} prediction"] = n_pings / dt
        if late:
            continue
        part = make_partition(mcfg, path_to_echograms=str(ech_dir))
        readers = part.get_survey_readers(2017)

        def run_eval(label):
            cuda_lib.reset_launches()
            f0 = runner.forwards
            t = time.perf_counter()
            curve = evaluate_survey(runner, readers, "all")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
            check(len(curve["thresholds"]) > 0
                  and 0 <= float(curve["F1"].max()) <= 1,
                  f"{label}: curve")
            print(f"{label}: {fwd} sub-batches, launches {counts}, "
                  f"{dt:.3f} s = {n_pings / dt:.1f} pings/s, max F1 "
                  f"{float(curve['F1'].max()):.6f} [{card}]")
            return counts, fwd, dt

        run_eval("meta eval warm-up")
        runner.timer.reset()
        counts, fwd, dt = run_eval("meta early inject evaluation, mode all")
        check(fwd > 0 and counts["binary_closing"] == fwd
              and counts["relu_pool_skip"] == fwd
              and counts["gather_db"] == 0,
              f"meta eval: launches {counts} for {fwd} sub-batches")
        print(f"PhaseTimer, meta evaluation [{card}]:")
        print(runner.timer.report())
        paths["memm_meta_eval"] = counts
        rates["meta evaluation"] = n_pings / dt
    return paths, rates


# -------------------------------------------------------------- phase 11
def phase_school(torch, cuda_lib, tmp, cfg, cases, card):
    """School-detection evaluation (``school_eval_survey``) live on the
    memm and zarr surveys, then from the stores phases 4 and 6 wrote with
    the same weights and settings: the same detections, so the same AP.
    ``cases``: (label, config, readers, store directory).  Random weights
    score no real schools, so the probability threshold is the store's
    99th percentile of written sandeel probabilities, fixed before the
    live run, and the inventory is the plain component one (min_area 1,
    no gap merge): its detections are many and sensitive to every pixel."""
    import numpy as np
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline import school_eval
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    paths, rates = {}, {}
    for label, scfg, readers, store_dir in cases:
        store = next(store_dir.glob("*_pred.*"))
        if store.suffix == ".npy":
            sand = np.load(store)[0]
        else:
            from crimac_unet_tpu_torch.data.zarrlite import ZGroup
            sand = ZGroup.open(str(store))["annotation"][:][0]
        thr = float(np.quantile(sand[sand != 0].astype(np.float32), 0.99))
        sd = init_random_(build_unet(scfg), torch.Generator().manual_seed(
            SEED)).state_dict()
        runner = GriddedRunner(build_unet(scfg), sd, scfg)
        kw = dict(preload_n_pings=scfg["preload_n_pings"], prob_threshold=thr,
                  min_area=1, merge_gap=0)
        cuda_lib.reset_launches()
        t = time.perf_counter()
        live = school_eval.school_eval_survey(
            runner, readers, save_path_metrics=str(tmp / f"{label}_se.csv"),
            save_path_detections=str(tmp / f"{label}_schools.csv"), **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts, fwd = dict(cuda_lib.launches), runner.forwards
        check(fwd > 0 and counts["gather_db"] == fwd
              and counts["relu_pool_skip"] == fwd,
              f"school eval {label}: launches {counts} for {fwd} forwards")
        t = time.perf_counter()
        stored = school_eval.school_eval_survey(
            None, readers, from_predictions=str(store_dir), **kw)
        sdt = time.perf_counter() - t
        check(repr(live) == repr(stored),
              f"school eval {label}: live {live} != from stores {stored}")
        check(live["categories"]["sandeel"]["n_detections"] > 0,
              f"school eval {label}: no detections")
        n_pings = sum(r.shape[0] if r.data_format == "zarr" else r.shape[1]
                      for r in readers)
        cats = ", ".join(f"{k} AP {m['ap']} ({m['n_detections']} det / "
                         f"{m['n_gt']} gt)"
                         for k, m in live["categories"].items())
        print(f"school eval {label} (threshold {thr:.6f}): live {fwd} "
              f"forwards, launches {counts}, {dt:.3f} s = {n_pings / dt:.1f} "
              f"pings/s; from the stores {sdt:.3f} s, equal; {cats}, mAP "
              f"{live['mean_ap']} [{card}]")
        paths[f"{label}_school_eval"] = counts
        rates[f"{label} school eval"] = n_pings / dt
    return paths, rates


# -------------------------------------------------------------- phase 12
def _spy(obj, name, before=None, after=None):
    """Wrap ``obj.name``; returns a restore callable."""
    real = getattr(obj, name)

    def spy(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        out = real(*args, **kwargs)
        if after is not None:
            after(out, *args, **kwargs)
        return out
    setattr(obj, name, spy)
    return lambda: setattr(obj, name, real)


def _pooled_batches(torch, cfg, pool, n):
    """``n`` pooled train batches (device tensors) drawn as the training
    loop draws them."""
    from crimac_unet_tpu_torch.data.dataset import RandomPatchDataset
    from crimac_unet_tpu_torch.data.partition import make_partition
    samplers, _, probs = make_partition(cfg).get_samplers_train(
        pool.readers, pool.readers)
    ds = RandomPatchDataset(samplers, cfg["patch_size"],
                            sorted(cfg["frequencies"]), probs,
                            seed=cfg["random_seed"]).use_pool(pool)
    return [{k: torch.from_numpy(v).cuda() for k, v in
             ds.batch(cfg["batch_size"]).items()} for _ in range(n)]


def _timed_spy(torch, obj, name, times):
    """Wrap ``obj.name`` so each call's wall, between two device
    synchronizations, is appended to ``times``; returns a restore
    callable."""
    def start(*args, **kwargs):
        torch.cuda.synchronize()
        times.append(-time.perf_counter())

    def end(out, *args, **kwargs):
        torch.cuda.synchronize()
        times[-1] += time.perf_counter()
    return _spy(obj, name, before=start, after=end)


def train_path(torch, cuda_lib, tmp, card, cfg, tag, pool_type):
    """``run_training`` at full width with the launch counters set to 0
    just before and read just after, both device pools of ``pool_type``
    on: the loss finite and falling, K4 once per train and validation
    step, K2 once per validation step, K1 and K3 never, best/last
    checkpoints and sidecars written.  Then resume from the step-200
    checkpoint (step, momentum buffers, weights), the step alone by CUDA
    events over 50 pooled steps with no host sync inside, and the
    profiler's device time over 20 more.  Returns (segpipe, launches,
    checkpoint dir, numbers)."""
    import shutil
    import warnings

    import numpy as np
    from crimac_unet_tpu_torch.pipeline import engine
    from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
    from crimac_unet_tpu_torch.pipeline.train import run_training

    ck = tmp / f"train_ck_{tag}"
    step200 = tmp / f"last_step200_{tag}.msgpack"
    snap, val_s, upload_s = {}, [], []

    def snapshot(out, path, state, extras=None):
        if Path(path).name == "last.msgpack" and state.step == 200:
            shutil.copy(path, step200)
            shutil.copy(str(path) + ".json", str(step200) + ".json")
            snap["momentum"] = {k: v.detach().cpu().clone() for k, v in
                                engine.momentum_buffers(state).items()}
            snap["weights"] = {k: v.detach().cpu().clone() for k, v in
                               state.model.state_dict().items()}

    restores = [_spy(engine, "save_checkpoint", after=snapshot),
                _timed_spy(torch, SegPipeUNet, "validate_model_training",
                           val_s),
                _timed_spy(torch, pool_type, "__init__", upload_s)]
    log = Scalars()
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sp = run_training(cfg, ck, logger=log, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
    finally:
        for r in restores:
            r()
    n_iter = int(cfg["iterations"])
    n_train = sp.state.step
    n_val = n_iter // int(cfg["log_step"]) * int(cfg["test_iter"])
    losses = np.asarray(log.values("train/loss"))
    check(n_train == n_iter and len(losses) == n_iter,
          f"{tag}: trained {n_train} steps, {len(losses)} losses logged")
    check(np.isfinite(losses).all(), f"{tag}: a training loss is not finite")
    q = n_iter // 4
    first, last = losses[:q].mean(), losses[-q:].mean()
    check(last < first, f"{tag}: the loss did not fall: first {q} steps "
                        f"{first}, last {q} {last}")
    check(type(sp.pool) is pool_type and type(sp.pool_val) is pool_type,
          f"{tag}: pools {type(sp.pool).__name__}, "
          f"{type(sp.pool_val).__name__}, not both {pool_type.__name__}")
    check(len(upload_s) == 2, f"{tag}: {len(upload_s)} pool uploads")
    check(counts["binary_closing"] == n_train + n_val
          and counts["maxpool2x2"] == n_val
          and counts["relu_pool_skip"] == 0 and counts["gather_db"] == 0,
          f"{tag}: training launches {counts} for {n_train} train and "
          f"{n_val} validation steps")
    for name in ("best.msgpack", "last.msgpack"):
        check((ck / name).is_file() and (ck / (name + ".json")).is_file(),
              f"{tag}: {name} or its sidecar was not written")
    f1s = log.values("test/F1_score")
    print(f"{tag}: training, {n_iter} steps at full width: launches "
          f"{counts}, wall {wall:.1f} s ({cfg['batch_size'] * n_iter / wall:.1f}"
          f" crops/s with validation), pool uploads (train, validation) "
          f"{upload_s} s, loss {first:.4f} (first {q} steps) -> {last:.4f} "
          f"(last {q}), validation F1 {f1s}, validation passes {val_s} s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    check("momentum" in snap, f"{tag}: no step-200 checkpoint was written")
    rs = SegPipeUNet(cfg)
    rs.resume_from(step200)
    got = engine.momentum_buffers(rs.state)
    check(rs.state.step == 200 and all(
        torch.equal(got[k].cpu(), v) for k, v in snap["momentum"].items())
        and all(torch.equal(rs.model.state_dict()[k].cpu(), v)
                for k, v in snap["weights"].items()),
        f"{tag}: resume from the step-200 checkpoint did not restore the "
        "step, the momentum buffers and the weights")
    print(f"{tag}: resumed from the step-200 last.msgpack: step "
          f"{rs.state.step}, {len(got)} momentum buffers and the weights "
          f"equal, best F1 {rs.best_F1_val}")
    del rs

    batches = _pooled_batches(torch, cfg, sp.pool, 75)
    for b in batches[:5]:
        sp.train_step(b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            start.record()
            for b in batches[5:55]:
                sp.train_step(b)
            end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    step_ms = start.elapsed_time(end) / 50
    crops = cfg["batch_size"] * 1000 / step_ms
    check(len(syncs) == 0, f"{tag}: {len(syncs)} host syncs inside the "
                           f"step: {[str(w.message) for w in syncs[:3]]}")
    print(f"{tag}: train step (pooled, {cfg['train_dtype']}, batch "
          f"{cfg['batch_size']}): {step_ms:.3f} ms a step by CUDA events "
          f"over 50 steps = {crops:.1f} crops/s; host syncs inside: 0 "
          f"[{card}]")

    def twenty():
        t = time.perf_counter()
        for b in batches[55:75]:
            sp.train_step(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    print(f"{tag}: 20 pooled steps under the profiler:")
    profile_run(torch, twenty, card)
    return sp, counts, ck, {"step_ms": step_ms, "crops/s": crops,
                            "upload_s": upload_s, "wall_s": wall}


def serve_trained(torch, cuda_lib, card, tag, scfg, ck, predict, evaluate):
    """The trained best.msgpack served (``predict(runner)``, K1 and K3
    once per forward) and evaluated (``evaluate(runner)`` -> histogram or
    curve, K4 and K3 once per sub-batch), BatchNorm folded, each with the
    launch counters set to 0 just before and read just after."""
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.models.weights import load_checkpoint
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    runner = GriddedRunner(build_unet(scfg),
                           load_checkpoint(ck / "best.msgpack"), scfg)
    cuda_lib.reset_launches()
    f0 = runner.forwards
    t = time.perf_counter()
    predict(runner)
    torch.cuda.synchronize()
    pdt = time.perf_counter() - t
    pc, fwd = dict(cuda_lib.launches), runner.forwards - f0
    check(fwd > 0 and pc["gather_db"] == fwd and pc["relu_pool_skip"] == fwd,
          f"{tag}: serving the trained model: launches {pc} for {fwd} "
          f"forwards")
    cuda_lib.reset_launches()
    f0 = runner.forwards
    out = evaluate(runner)
    torch.cuda.synchronize()
    ec, efwd = dict(cuda_lib.launches), runner.forwards - f0
    if isinstance(out, dict):
        f1 = float(out["F1"].max())
    else:
        f1 = _curve_scores(out)[0]
    check(efwd > 0 and ec["binary_closing"] == efwd
          and ec["relu_pool_skip"] == efwd and 0.0 <= f1 <= 1.0,
          f"{tag}: evaluating the trained model: launches {ec} for {efwd} "
          f"sub-batches, F1 {f1}")
    print(f"{tag}: trained best.msgpack served on the 2016 survey: {fwd} "
          f"forwards in {pdt:.3f} s, launches {pc}; evaluation mode all: "
          f"max F1 {f1:.4f}, launches {ec} [{card}]")
    return runner, f1


def _serving_config(cfg, **kw):
    return dict(cfg, save_prediction_surveys=[2016],
                compute_dtype="bfloat16", fwd_batch=32, fold_bn=True,
                infer_mode="patch", transfer_dtype="bfloat16",
                output_dtype="float16", preload_n_pings=1000,
                partition_predict="selected surveys",
                evaluation_surveys=[2016], static_grid=False,
                pipeline_depth=3, **kw)


def _check_memm_preds(out, n):
    import numpy as np
    preds = sorted(out.glob("*_pred.npy"))
    check(len(preds) == n, f"{len(preds)} outputs in {out}, not {n}")
    for pth in preds:
        pred = np.load(pth)
        check(np.isfinite(pred).all() and pred.min() >= 0
              and pred.max() <= 1, f"{pth.name}: not in [0, 1]")


def phase_train(torch, cuda_lib, tmp, card, iterations=400):
    """Training at full width through ``run_training`` (``train_path``) on
    the memm recipe fixture, and the trained best.msgpack served and
    evaluated (BatchNorm folded) on the 2016 survey, then scored by
    school-detection evaluation with the school_eval CLI's defaults."""
    from crimac_unet_tpu_torch.data import device_pool as dp
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.pipeline import school_eval
    from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    root = train_fixture(tmp)
    cfg = recipe_config(root, **phase_train_settings(iterations))
    sp, counts, ck, nums = train_path(torch, cuda_lib, tmp, card, cfg, "tr",
                                      dp.DeviceSamplePool)

    scfg = _serving_config(cfg)
    out = tmp / "train_preds"
    out.mkdir()
    readers = make_partition(scfg).get_survey_readers(2016)
    runner, _ = serve_trained(
        torch, cuda_lib, card, "tr", scfg, ck,
        lambda r: run_save_predictions(
            scfg, r, memm_partition(scfg, root), str(out)),
        lambda r: evaluate_survey(r, readers, "all"))
    _check_memm_preds(out, 2)

    # school-detection evaluation at trained weights, the CLI's defaults
    cuda_lib.reset_launches()
    f0 = runner.forwards
    t = time.perf_counter()
    se = school_eval.school_eval_survey(
        runner, readers, preload_n_pings=scfg["preload_n_pings"],
        prob_threshold=0.5, min_area={"sandeel": 9, "other": 64},
        merge_gap={"sandeel": 8, "other": 0},
        save_path_metrics=str(tmp / "tr_school_eval.csv"),
        save_path_detections=str(tmp / "tr_schools.csv"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    sc, fwd = dict(cuda_lib.launches), runner.forwards - f0
    check(fwd > 0 and sc["gather_db"] == fwd and sc["relu_pool_skip"] == fwd
          and 0.0 <= se["mean_ap"] <= 1.0,
          f"school eval at trained weights: launches {sc} for {fwd} "
          f"forwards, mAP {se['mean_ap']}")
    n_pings = sum(r.shape[1] for r in readers)
    cats = ", ".join(f"{k} AP {m['ap']} mean {m['mean_ap']:.4f} "
                     f"({m['n_detections']} det / {m['n_gt']} gt)"
                     for k, m in se["categories"].items())
    print(f"tr: school eval (memm, trained best.msgpack, threshold 0.5, "
          f"min_area 9/64, merge_gap 8/0) on 2016: {fwd} forwards, "
          f"launches {sc}, {dt:.3f} s = {n_pings / dt:.1f} pings/s; {cats}; "
          f"mAP {se['mean_ap']:.4f} [{card}]")
    return counts, {"train crops/s (pooled step)": nums["crops/s"],
                    "school eval, trained (memm)": n_pings / dt}


def phase_train_settings(iterations):
    """Phases 12-14: the recipe cut to ``iterations`` steps, validation
    every 200 over 50 batches (once at 200 steps), lr halved every 100,
    a checkpoint every 200."""
    return dict(iterations=iterations, log_step=200, test_iter=50,
                lr_step=100, checkpoint_every=200)


# -------------------------------------------------------------- phase 13
def zarr_train_fixture(tmp):
    """The recipe fixture in zarr form (the port's make_zarr_survey,
    nested layout): 2017 three 700 x 1400 echograms (seed 41, 6 schools)
    as one survey of 4200 pings with a STOX transects CSV of two
    transects, 2016 two 700 x 1200 (seed 42)."""
    import csv
    import os

    import numpy as np
    from crimac_unet_tpu_torch.data.fixtures import make_zarr_survey
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    root = tmp / "train_zarr"
    if root.is_dir():
        return root
    t0 = time.perf_counter()
    sv = make_zarr_survey(root, year=2017, n_echograms=3, H=700, W=1400,
                          seed=41, n_schools=6, layout="nested")
    make_zarr_survey(root, year=2016, n_echograms=2, H=700, W=1200, seed=42,
                     n_schools=6, layout="nested")
    times = DataReaderZarr(sv).time_vector
    stox = Path(sv).parents[2] / "STOX"
    stox.mkdir()
    name = os.path.basename(sv).replace("_sv.zarr", "").replace("S", "")
    with open(stox / f"{name}_transects.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["StartDateTime", "StopDateTime"])
        for a, b in ((100, 1300), (1500, 4100)):
            w.writerow([str((times[i] + np.timedelta64(500, "ms")).astype(
                "M8[s]")) for i in (a, b)])
    print(f"zarr train fixture written in {time.perf_counter() - t0:.1f} s")
    return root


def phase_zarr_train(torch, cuda_lib, tmp, card, iterations=400):
    """Zarr training at full width: ``train_path`` on the zarr recipe
    fixture (``ZarrSamplePool`` for training and validation,
    ``BackgroundZarr`` drawing inside the STOX transects), then the
    trained best.msgpack served through save_survey_predictions_zarr and
    evaluated (evaluate_reader, mode all) on the 2016 survey."""
    from crimac_unet_tpu_torch.data import device_pool as dp
    from crimac_unet_tpu_torch.data.zarr_reader import get_zarr_readers
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr

    root = zarr_train_fixture(tmp)
    cfg = recipe_config(root, data_mode="zarr",
                        path_to_zarr_files=str(root),
                        **phase_train_settings(iterations))
    sp, counts, ck, nums = train_path(torch, cuda_lib, tmp, card, cfg, "tz",
                                      dp.ZarrSamplePool)
    valid = [r.get_valid_pings().tolist() for r in sp.pool.readers]
    check(valid == [[[100, 1300], [1500, 4100]]],
          f"tz: STOX valid pings {valid}")
    scfg = _serving_config(cfg)
    (reader,) = get_zarr_readers([2016], path_to_zarr_files=str(root),
                                 minimum_shape=256)
    target = tmp / "tz_preds" / f"{reader.name}_pred.zarr"
    serve_trained(
        torch, cuda_lib, card, "tz", scfg, ck,
        lambda r: save_survey_predictions_zarr(
            r, reader, str(target), preload_n_pings=scfg["preload_n_pings"]),
        lambda r: evaluate_reader(r, reader, metrics.new_histogram(r.device),
                                  eval_mode="all",
                                  chunk_cols=EVAL_CHUNK_COLS))
    _check_store(str(target), *reader.shape, "tz: the trained model's store")
    return counts, {"tz train crops/s (pooled step)": nums["crops/s"]}


# -------------------------------------------------------------- phase 14
def phase_meta_train(torch, cuda_lib, tmp, card, iterations=400):
    """Metadata training at full width, early then late inject, the six
    families: ``train_path`` on the memm recipe fixture with the metadata
    crops computed on the card from the pools' vectors, then each trained
    best.msgpack served (run_save_predictions) and evaluated
    (evaluate_survey) through the metadata paths of phase 10."""
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data import device_pool as dp
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    root = train_fixture(tmp)
    paths, rates = {}, {}
    for late in (False, True):
        tag = "tml" if late else "tme"
        cfg = recipe_config(root, meta_channels=META_CHANNELS_ALL,
                            late_meta_inject=late,
                            **phase_train_settings(iterations))
        sp, counts, ck, nums = train_path(torch, cuda_lib, tmp, card, cfg,
                                          tag, dp.DeviceSamplePool)
        check(sp.pool.meta_flags == dp.META_ORDER
              and sp.pool_val.meta_flags == dp.META_ORDER,
              f"{tag}: pools carry meta flags {sp.pool.meta_flags}")
        scfg = _serving_config(cfg)
        out = tmp / f"{tag}_preds"
        out.mkdir()
        readers = make_partition(scfg).get_survey_readers(2016)
        serve_trained(
            torch, cuda_lib, card, tag, scfg, ck,
            lambda r: run_save_predictions(
                scfg, r, memm_partition(scfg, root), str(out)),
            lambda r: evaluate_survey(r, readers, "all"))
        _check_memm_preds(out, 2)
        paths[tag] = counts
        rates[f"{tag} train crops/s (pooled step)"] = nums["crops/s"]
    return paths, rates


# -------------------------------------------------------------- phase 15
def _export_patches(reader, n, rng):
    """``n`` raw (256, 256, 4) float32 windows of the phase-4 survey at
    seeded positions, with NaN and +-Inf written in."""
    import numpy as np
    maps = reader.data_memmaps()
    H, W = reader.shape
    ys = rng.randint(0, H - 256 + 1, n)
    xs = rng.randint(0, W - 256 + 1, n)
    x = np.stack([np.stack([m[y:y + 256, c:c + 256] for m in maps], -1)
                  for y, c in zip(ys, xs)]).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 96, replace=False)
    flat[idx[:32]] = np.nan
    flat[idx[32:64]] = np.inf
    flat[idx[64:]] = -np.inf
    return x


def _same_or_ulp16(torch, got, want, n=2):
    """('identical' | 'within n float16 ulp' | None): probabilities of two
    forwards of the same graph; cuDNN may pick other algorithms for the
    same convolution, which changes the last bits."""
    if torch.equal(got, want):
        return "identical"
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 11)
    if bool(torch.all((got - want).abs() <= n * ulp)):
        return f"within {n} float16 ulp"
    return None


def phase_export(torch, cuda_lib, tmp, ech_dir, reader, zreader, cfg, card):
    """The serving export at full width: artifacts of the flagship U-Net
    (phase 12's trained best.msgpack, or seeded random weights written
    to a msgpack) exported on the card through ``export_checkpoint``,
    saved, loaded back and served — patch (float32 raw sv, symbolic
    batch, BatchNorm folded and not), the serving preset's slab (uint8
    in and out) and late-inject metadata — each held to the eager
    serving forward, launch-counted per call, the patch artifact also to
    ``GriddedRunner._predict_patches`` and to a CPU-exported artifact
    loaded on the card; then the artifact and the eager forward timed
    with ``burst_time`` (MFU against the card's peak), the selfcheck CLI,
    and one ``save_predict`` CLI run under ``CRIMAC_PROFILE_DIR`` read
    back with ``device_op_table``."""
    import json
    import os

    import numpy as np
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL, SERVING_PRESET
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.models.weights import (
        load_checkpoint, torch_to_flax_variables)
    from crimac_unet_tpu_torch.ops.patches import make_grid_starts
    from crimac_unet_tpu_torch.ops.stitch import stitch_patches
    from crimac_unet_tpu_torch.pipeline import export as E
    from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.utils import flax_msgpack
    from crimac_unet_tpu_torch.utils.flops import (device_peak_flops, mfu,
                                                   unet_forward_flops)
    from crimac_unet_tpu_torch.utils.profiling import device_op_table
    from crimac_unet_tpu_torch.utils.timing import burst_time

    dev = torch.device("cuda")
    art = tmp / "export"
    art.mkdir()
    ck = tmp / "train_ck_tr" / "best.msgpack"
    if ck.is_file():
        source = "phase 12's trained best.msgpack"
    else:
        ck = art / "random.msgpack"
        sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
            SEED)).state_dict()
        ck.write_bytes(flax_msgpack.packb(torch_to_flax_variables(sd)))
        source = "seeded random weights written to a msgpack"
    sd = load_checkpoint(ck)
    ecfg = dict(cfg, data_mode="zarr", transfer_dtype="float32",
                output_dtype="float16")
    by_path = {}

    def counted(fn, *args):
        cuda_lib.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, dict(cuda_lib.launches)

    def expect(counts, label, **want):
        full = dict.fromkeys(cuda_lib.launches, 0)
        full.update(want)
        check(counts == full, f"{label}: launches {counts}, not {full}")

    def export(name, c, mode="patch", device="cuda"):
        t = time.perf_counter()
        E.export_checkpoint(ck, c, art / name, device=device, mode=mode)
        wall = time.perf_counter() - t
        t = time.perf_counter()
        predict = E.load_predictor(art / name)
        return predict, wall, time.perf_counter() - t, \
            (art / name).stat().st_size

    # the patch artifact: float32 raw sv, symbolic batch, BN folded
    predict, wall, load_s, size = export("patch.pt2", ecfg)
    print(f"export (patch, {source}): exported on the card in {wall:.2f} s, "
          f"{size} bytes ({size / 1e6:.1f} MB), loaded on cuda in "
          f"{load_s:.2f} s [{card}]")
    live = E.make_serving_forward(build_unet(ecfg), sd, ecfg)
    x = torch.from_numpy(_export_patches(
        reader, 32, np.random.RandomState(SEED))).to(dev)
    got, counts = counted(predict, x)
    expect(counts, "patch artifact", gather_db=1, relu_pool_skip=1)
    by_path["ex"] = counts
    with torch.no_grad():
        want = live(x)
    check(got.shape == (32, 256, 256, 3) and bool(torch.isfinite(got).all()),
          f"patch artifact: {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}")
    same = _same_or_ulp16(torch, got, want)
    check(same is not None, f"patch artifact vs eager serving forward: max "
                            f"abs diff {float((got - want).abs().max())}")
    print(f"export: patch artifact on 32 patches of the phase-4 survey "
          f"(NaN/+-Inf seeded): {same} to the eager serving forward; "
          f"launches a call {counts} [{card}]")

    # the same windows of a zarr chunk through the live runner
    runner = GriddedRunner(build_unet(ecfg), sd, ecfg)
    sh, sw = runner.stride
    o = runner.overlap
    R = C = 5
    Hp, Wp = R * sh + 2 * o, C * sw + 2 * o
    data = zreader.get_data_slice(0, Wp, 0, Hp).transpose(2, 1, 0)
    slab = np.zeros((Hp, Wp, data.shape[2]), np.float32)
    slab[:data.shape[0], :data.shape[1]] = data
    y0s, x0s = make_grid_starts(R, C, sh, sw, o, o, o)
    y0p, x0p = runner.grid_starts(y0s, x0s)
    N = len(y0s)
    want = runner._predict_patches(torch.from_numpy(slab).to(dev), y0p, x0p,
                                   N, None, R, C)
    B, _, nb = runner._sub_batch_shape(N)
    wins = torch.from_numpy(np.stack(
        [slab[y:y + 256, c:c + 256] for y, c in
         zip(y0p.cpu().numpy(), x0p.cpu().numpy())])).to(dev)
    probs = torch.cat([predict(wins[k * B:(k + 1) * B]) for k in range(nb)])
    got_r = stitch_patches(probs[:N, ..., 1:3], R, C, o)
    err = float((got_r - want).abs().max())
    check(err <= 2e-7, f"patch artifact vs GriddedRunner._predict_patches: "
                       f"max abs diff {err} > 2e-7")
    print(f"export: patch artifact on the {N} windows of the first "
          f"{Wp}-ping zarr chunk in {nb} call(s) of {B}, stitched: max abs "
          f"diff {err} to GriddedRunner._predict_patches (atol 2e-7) "
          f"[{card}]")

    # BatchNorm unfolded: K2 in place of K3
    ucfg = dict(ecfg, fold_bn=False)
    upredict, uwall, _, _ = export("unfolded.pt2", ucfg)
    got_u, counts = counted(upredict, x)
    expect(counts, "unfolded artifact", gather_db=1, maxpool2x2=1)
    by_path["exu"] = counts
    with torch.no_grad():
        same_u = _same_or_ulp16(
            torch, got_u, E.make_serving_forward(build_unet(ucfg), sd,
                                                 ucfg)(x))
    check(same_u is not None, "unfolded artifact vs eager serving forward")
    print(f"export: fold_bn false artifact (exported in {uwall:.2f} s): "
          f"{same_u} to its eager forward; launches a call {counts} "
          f"[{card}]")

    # the serving preset's slab artifact: uint8 codes in and out
    scfg = dict(SERVING_PRESET, device="cuda")
    spredict, swall, _, ssize = export("slab.pt2", scfg, mode="slab")
    slive = E.make_serving_forward(build_unet(scfg), sd, scfg)
    chunks = [slab[None], np.stack([slab[:512, :768], slab[512:1024,
                                                           300:1068]])]
    codes = [torch.from_numpy(_quantize_db_u8(raw)).to(dev)
             for raw in chunks]
    outs, counts = counted(lambda: [spredict(c) for c in codes])
    expect(counts, "slab artifact, two chunks", gather_db=2, relu_pool_skip=2)
    by_path["es"] = counts
    notes = []
    for c, out in zip(codes, outs):
        check(out.dtype == torch.uint8 and out.shape == c.shape[:3] + (3,),
              f"slab artifact: {out.dtype} {tuple(out.shape)}")
        with torch.no_grad():
            ref = slive(c)
        d = int((out.int() - ref.int()).abs().max())
        check(d <= 1, f"slab artifact vs eager: codes {d} apart")
        notes.append(f"{tuple(c.shape)}: {int((out != ref).sum())} codes "
                     f"differ (max {d})")
    try:
        spredict(torch.zeros((1, 1000, 1120, 4), dtype=torch.uint8,
                             device=dev))
        refused = None
    except Exception as exc:    # the artifact's shape guard
        refused = f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
    check(refused is not None, "slab artifact served an unaligned chunk")
    print(f"export: serving-preset slab artifact (uint8 in and out) exported "
          f"in {swall:.2f} s, {ssize} bytes; {'; '.join(notes)} against the "
          f"eager forward; launches for the two chunks {counts}; "
          f"(1, 1000, 1120, 4) refused ({refused}) [{card}]")

    # a metadata artifact: late inject, the six families
    mcfg = dict(ecfg, meta_channels=META_CHANNELS_ALL, late_meta_inject=True)
    msd = init_random_(build_unet(mcfg), torch.Generator().manual_seed(
        SEED + 1)).state_dict()
    t = time.perf_counter()
    E.save_exported(E.export_predictor(build_unet(mcfg), msd, mcfg),
                    art / "meta.pt2")
    mwall = time.perf_counter() - t
    mpredict = E.load_predictor(art / "meta.pt2")
    meta = torch.randn((32, 256, 256, 7), generator=torch.Generator(
        ).manual_seed(SEED)).to(dev)
    got_m, counts = counted(mpredict, x, meta)
    expect(counts, "metadata artifact", gather_db=1, relu_pool_skip=1)
    by_path["em"] = counts
    with torch.no_grad():
        same_m = _same_or_ulp16(torch, got_m, E.make_serving_forward(
            build_unet(mcfg), msd, mcfg)(x, meta))
    check(same_m is not None and bool(torch.isfinite(got_m).all()),
          "metadata artifact vs eager serving forward")
    print(f"export: late-inject metadata artifact (six families, exported "
          f"and saved in {mwall:.2f} s): {same_m} to its eager forward; "
          f"launches a call {counts} [{card}]")

    # exported on the CPU, loaded on the card
    cpredict, cwall, _, _ = export("cpu.pt2", ecfg, device="cpu")
    got_c, counts = counted(cpredict, x)
    expect(counts, "CPU-exported artifact on cuda", gather_db=1,
           relu_pool_skip=1)
    check(torch.equal(got_c, got), "CPU-exported artifact on the card != "
                                   "the card-exported artifact")
    print(f"export: patch artifact exported on the CPU ({cwall:.2f} s) and "
          f"loaded on cuda: equal to the card-exported one; launches "
          f"{counts} [{card}]")

    # time: the artifact against the eager serving forward
    flops = 32 * unet_forward_flops(256, 256, depth=cfg["depth"],
                                    start_filts=cfg["start_filts"])
    t_art = burst_time(predict, x, reps=5, burst=10, warmup=3)
    with torch.no_grad():
        t_eager = burst_time(live, x, reps=5, burst=10, warmup=3)
    peak = device_peak_flops()
    rates = {}
    for name, sec in (("artifact", t_art), ("eager", t_eager)):
        m = mfu(flops, sec)
        rates[f"export {name} ms a call of 32"] = sec * 1e3
        print(f"export: {name} forward, (32, 256, 256, 4) float32: "
              f"{sec * 1e3:.3f} ms a call (burst_time, best of 5 bursts of "
              f"10), {flops / 1e12:.3f} TFLOP a call "
              f"({flops / 32 / 1e9:.1f} GFLOP a patch), "
              f"{flops / sec / 1e12:.1f} TFLOP/s, MFU "
              + (f"{100 * m:.2f} % of {peak / 1e12:.1f} TFLOP/s bf16"
                 if m is not None else "not measured (no peak for this card)")
              + f" [{card}]")

    # the selfcheck CLI on this box
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "crimac_unet_tpu_torch.selfcheck"], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and "SELFCHECK PASSED" in proc.stdout
          and any(ln.startswith("[ok  ] kernels (K1, K3)") for ln in lines),
          f"selfcheck: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    print(f"selfcheck CLI: exit 0 in {time.perf_counter() - t:.1f} s:")
    for ln in lines:
        print("  " + ln)

    # save_predict under CRIMAC_PROFILE_DIR, its trace read back
    prof = art / "profile"
    out = art / "preds"
    yml = art / "save_predict.yaml"
    yml.write_text(json.dumps(dict(cfg, path_to_echograms=str(ech_dir))))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "crimac_unet_tpu_torch.pipeline.save_predict",
         "--yaml_path", str(yml), "--checkpoint_path", str(ck),
         "--save_predictions_path", str(out)], cwd=str(ROOT),
        env=dict(env, CRIMAC_PROFILE_DIR=str(prof)), capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0 and "profiler trace written" in proc.stdout,
          f"save_predict under CRIMAC_PROFILE_DIR: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    _check_memm_preds(out, 1)
    rows = device_op_table(prof, top=0)
    names = [r["name"] for r in rows]
    k1 = [r for r in rows if "gather_db_kernel" in r["name"]]
    k3 = [r for r in rows if "pool_kernel" in r["name"]
          and "true>" in r["name"]]
    check(k1 and k3, f"device_op_table names no K1 / K3 kernel: "
                     f"{names[:20]}")
    print(f"save_predict CLI under CRIMAC_PROFILE_DIR: exit 0 in "
          f"{time.perf_counter() - t:.1f} s; device_op_table of its trace "
          f"({len(rows)} kernels), top rows [{card}]:")
    for r in rows[:8] + [r for r in k1 + k3 if r not in rows[:8]]:
        print(f"  {r['total_ms']:9.3f} ms x{r['count']:<5} {r['name'][:110]}")
    return by_path, rates


# -------------------------------------------------------------- phase 16
PARALLEL_STEPS = 20           # phase 16: full-width steps on two ranks
NCCL_STEPS = 4                # phase 16: steps in the one-rank NCCL world
PARALLEL_TIMEOUT_S = 400      # phase 16: each spawned rank
# phase 16, two ranks against one: bfloat16 convolutions at batch 16
# against 32, or over other slab widths, round otherwise; measured
# 2.686e-3 (stored float16) and 2.432e-3 (slab probabilities) in each of
# three runs on an NVIDIA H100 80GB HBM3 at 700 W.  A halo fault shows in
# the float32 slab check below, not in these
PARALLEL_PRED_ATOL = 1e-2
PARALLEL_SLAB_ATOL = 1e-2
# phase 16, the serving preset's slab at float32 compute (TF32 off): the
# JAX package's slab bound, which a halo one pooling step short must miss
PARALLEL_SLAB_F32_ATOL = 2e-5


def parallel_train_config(tmp, mesh_devices):
    """Phase 12's recipe cut to PARALLEL_STEPS float32 steps of batch 4
    and one validation of 4 batches at the end, both device pools on."""
    return recipe_config(train_fixture(tmp), iterations=PARALLEL_STEPS,
                         log_step=PARALLEL_STEPS, test_iter=4, lr_step=100,
                         checkpoint_every=0, train_dtype="float32",
                         use_device_pool=True, mesh_devices=mesh_devices)


def _memm_reader(ech_dir):
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    return Echogram(str(sorted(d for d in ech_dir.iterdir()
                               if d.is_dir())[0]))


def parallel_paths(torch, cuda_lib, tmp, mesh_devices, rank):
    """Phase 16's paths with ``mesh_devices`` ranks (1: this process
    alone), each with the launch counters set to 0 just before and read
    just after: PARALLEL_STEPS float32 training steps at full width on
    phase 12's fixture, patch prediction of phase 4's survey, the serving
    preset (slab mode) on phase 6's zarr survey and memm evaluation of
    phase 4's survey (seeded random weights, as phases 4-6).  Rank 0
    keeps the outputs under ``tmp/par<mesh_devices>``; returns per path
    the launches, forwards, seconds and what the ranks must agree on."""
    import numpy as np
    from crimac_unet_tpu_torch.config import (SERVING_PRESET,
                                              parse_config_options)
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.predict import (
        predict_reader, save_survey_predictions_zarr)
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions
    from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
    from crimac_unet_tpu_torch.pipeline.train import run_training

    keep = tmp / f"par{mesh_devices}"
    keep.mkdir(exist_ok=True)
    res = {}

    def counted(name, fn, runner=None):
        cuda_lib.reset_launches()
        f0 = runner.forwards if runner else 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[name] = {"seconds": time.perf_counter() - t,
                     "launches": dict(cuda_lib.launches),
                     "forwards": runner.forwards - f0 if runner else 0}
        return out

    def recorded(runner, name, store):
        """Keep what ``runner.name`` returns (element ``at``) on the
        host."""
        at = 1 if name == "_mask_output" else None
        return _spy(runner, name, after=lambda out, *a, **k: store.append(
            (out if at is None else out[at]).cpu()))

    # training: every rank steps on its 2 rows of each batch of 4, cuDNN
    # deterministic (one rank's run then repeats itself bit for bit, so
    # what differs is the distribution's)
    step_s = []
    restore = _timed_spy(torch, SegPipeUNet, "train_step", step_s)
    log = Scalars()
    torch.backends.cudnn.deterministic = True
    try:
        sp = counted("train", lambda: run_training(
            parallel_train_config(tmp, mesh_devices),
            tmp / f"par_ck{mesh_devices}_r{rank}", logger=log,
            progress=False))
    finally:
        restore()
        torch.backends.cudnn.deterministic = False
    params = {k: v.detach().cpu() for k, v in sp.model.named_parameters()}
    res["train"].update(
        losses=log.values("train/loss"), steps=sp.state.step,
        step_ms=1e3 * float(np.median(step_s)),
        steps_ms=[round(1e3 * t, 3) for t in step_s],
        checksum=sum(float(v.double().abs().sum()) for v in params.values()))
    if rank == 0:
        torch.save(params, keep / "params.pt")
    del sp

    # patch prediction of phase 4's survey
    cfg = dict(main_config(), mesh_devices=mesh_devices)
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    ech_dir = tmp / "survey"
    out_dir = tmp / f"par_pred{mesh_devices}_r{rank}"
    out_dir.mkdir(exist_ok=True)
    runner = GriddedRunner(build_unet(cfg), sd, cfg)

    def predict():
        run_save_predictions(
            cfg, runner, memm_partition(cfg, ech_dir), str(out_dir))
    predict()                                        # warm-up
    keeps = []
    restore = recorded(runner, "_mask_output", keeps)
    try:
        counted("predict", predict, runner)
    finally:
        restore()
    res["predict"]["written"] = sorted(p.name for p in out_dir.iterdir())
    if rank == 0:
        torch.save(keeps, keep / "predict_keeps.pt")

    # the serving preset (zarr, slab, static grid, uint8 in and out)
    zreader = DataReaderZarr(str(tmp / "zarr" / "S2017843_sv.zarr"))
    scfg = parse_config_options(dict(SERVING_PRESET, device="cuda",
                                     resume_writing=False,
                                     mesh_devices=mesh_devices))
    srunner = GriddedRunner(build_unet(scfg), sd, scfg)
    target = tmp / f"par_serving{mesh_devices}_r{rank}_pred.zarr"

    def serve():
        save_survey_predictions_zarr(srunner, zreader, str(target),
                                     preload_n_pings=1000)
    serve()                                          # warm-up
    skeeps, slabs = [], []
    restores = [recorded(srunner, "_mask_output", skeeps),
                recorded(srunner, "_predict_slab", slabs)]
    try:
        counted("serving", serve, srunner)
    finally:
        for r in restores:
            r()
    res["serving"].update(
        written=target.is_dir(),
        checksum=sum(float(x.double().sum()) for x in slabs))
    if rank == 0:
        torch.save({"keeps": skeeps, "slabs": slabs},
                   keep / "serving_outputs.pt")

    # the same slab path at float32 compute, with the conv kernels
    # doubled as tests/test_torch_multirank.py doubles them (at the
    # seeded scale the deepest paths fade below float32, so a short
    # halo would go unseen); on two ranks also with the halo one pooling
    # step short, which the comparison must catch
    sd2 = {k: v * 2 if v.ndim == 4 else v for k, v in sd.items()}
    for name, short in (("f32", 0), ("f32_short", 1)):
        if short and mesh_devices == 1:
            continue
        fcfg = parse_config_options(dict(
            SERVING_PRESET, device="cuda", compute_dtype="float32",
            mesh_devices=mesh_devices))
        frunner = GriddedRunner(build_unet(fcfg), sd2, fcfg)
        frunner.slab_halo -= short * 2 ** (frunner.model.depth - 1)
        fslabs = []
        restore = recorded(frunner, "_predict_slab", fslabs)
        try:
            for _ in predict_reader(frunner, zreader, 1000):
                pass
        finally:
            restore()
        res["serving"][f"{name}_checksum"] = sum(
            float(x.double().sum()) for x in fslabs)
        res["serving"][f"{name}_halo"] = frunner.slab_halo
        if rank == 0:
            torch.save(fslabs, keep / f"slab_{name}.pt")

    # memm evaluation of phase 4's survey, mode all
    reader = _memm_reader(ech_dir)
    erunner = GriddedRunner(build_unet(cfg), sd, cfg)

    def evaluate():
        return evaluate_reader(erunner, reader,
                               metrics.new_histogram(erunner.device),
                               eval_mode="all", chunk_cols=EVAL_CHUNK_COLS)
    evaluate()                                       # warm-up
    hist = counted("eval", evaluate, erunner)
    res["eval"]["hist_sum"] = int(hist.sum())
    if rank == 0:
        np.save(keep / "eval_hist.npy", hist)
    for name, n in (("predict", reader.shape[1]),
                    ("serving", zreader.shape[0]),
                    ("eval", reader.shape[1])):
        res[name]["pings/s"] = n / res[name]["seconds"]
    return res


def parallel_worker(rank, port, tmp):
    """One rank of phase 16(b): joins the 2-rank group and runs
    ``parallel_paths``; prints its result as a RESULT line."""
    import torch
    sys.path.insert(0, str(ROOT))
    from crimac_unet_tpu_torch.ops import cuda_lib
    from crimac_unet_tpu_torch.parallel import mesh as pmesh
    cuda_lib.lib()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # NCCL refuses two ranks on one device, so the two ranks sharing this
    # card talk over gloo, which takes CUDA tensors for all_reduce,
    # broadcast, all_gather and barrier (the only collectives the port
    # uses); on a node of N cards the same code runs NCCL, one card a rank
    pmesh.init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, device="cuda:0",
                           backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
    try:
        res = parallel_paths(torch, cuda_lib, Path(tmp), 2, rank)
    finally:
        pmesh.shutdown_distributed()
    print("RESULT" + json.dumps(res), flush=True)


def nccl_one_rank(torch, cuda_lib, tmp, card):
    """(a): NCCL_STEPS full-width float32 train steps through the
    distributed step in an in-process NCCL world of one rank (every
    all-reduce launches) against the same steps without a process group,
    from the same seed, pool and batches: losses and weights bit-equal
    (cuDNN deterministic, TF32 off)."""
    import torch.distributed as dist
    from crimac_unet_tpu_torch.data import device_pool as dp
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.parallel import mesh as pmesh
    from crimac_unet_tpu_torch.parallel.multihost_check import free_port
    from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet

    cfg = parallel_train_config(tmp, 0)
    readers, _ = make_partition(cfg).partition_data_train()
    pool = dp.DeviceSamplePool(readers, sorted(cfg["frequencies"]),
                               tuple(cfg["patch_size"]), device="cuda")
    batches = _pooled_batches(torch, cfg, pool, NCCL_STEPS)

    def steps(label):
        sp = SegPipeUNet(cfg)
        sp.init_model()
        sp.attach_pool(pool)
        sp.generator = torch.Generator(device="cuda").manual_seed(10)
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = [sp.train_step(b) for b in batches]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / len(batches)
        counts = dict(cuda_lib.launches)
        check(counts["binary_closing"] == len(batches)
              and counts["maxpool2x2"] == counts["gather_db"]
              == counts["relu_pool_skip"] == 0,
              f"{label}: launches {counts} for {len(batches)} train steps")
        return (torch.stack(losses).cpu(),
                [p.detach().clone() for p in sp.model.parameters()],
                sp.mesh, counts, ms)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps("warm-up (cuDNN plans, allocator)")
        want = steps("no process group")
        check(want[2] is None, "a mesh without a process group")
        pmesh.init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                               world_size=1, rank=0, device="cuda:0")
        calls = []
        restore = _spy(dist, "all_reduce",
                       before=lambda *a, **k: calls.append(1))
        try:
            check(dist.get_backend() == "nccl",
                  f"a CUDA rank chose {dist.get_backend()}")
            got = steps("NCCL world of one")
        finally:
            restore()
            pmesh.shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = det
    check(got[2] is not None and got[2].size == 1 and calls,
          f"the NCCL step ran no collective (mesh {got[2]}, "
          f"{len(calls)} all-reduces)")
    loss_err = float((got[0] - want[0]).abs().max())
    w_err = max(float((g - w).abs().max()) for g, w in zip(got[1], want[1]))
    check(loss_err == 0 and w_err == 0,
          f"NCCL world of one vs no group: loss {loss_err}, weights {w_err}")
    print(f"parallel (a): {NCCL_STEPS} float32 full-width steps, NCCL world "
          f"of one rank ({len(calls)} all-reduces) vs no process group: "
          f"losses {got[0].tolist()} bit-equal, weights bit-equal; "
          f"{got[4]:.3f} vs {want[4]:.3f} ms a step (host-timed, cuDNN "
          f"deterministic); launches {got[3]} [{card}]")
    return got[3], {"nccl1 train ms a step": got[4]}


def phase_parallel(torch, cuda_lib, tmp, card):
    """(a) ``nccl_one_rank``; (b) the phase's paths on one rank in this
    process, then on two gloo ranks spawned as processes on this card,
    held against one rank: training losses within rtol 1e-3 / atol 1e-4
    and weights per tensor within 1e-3 x max |w| + 1e-4, prediction and
    serving write masks identical, the
    serving slab probabilities and the stored prediction within the
    stated tolerances, evaluation histograms bit-equal; each rank's K1-K4
    launches checked per path."""
    import numpy as np
    from crimac_unet_tpu_torch.parallel.multihost_check import (free_port,
                                                                result_line)
    by_path, rates = {}, {}
    by_path["par_nccl1_train"], r = nccl_one_rank(torch, cuda_lib, tmp, card)
    rates.update(r)

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = time.perf_counter()
        ref = parallel_paths(torch, cuda_lib, tmp, 1, 0)
        ref_s = time.perf_counter() - t
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    port = free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-worker",
         str(r), str(port), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=PARALLEL_TIMEOUT_S)
            outs.append(out)
            check(p.returncode == 0, f"rank {r} exited with {p.returncode}:"
                                     f"\n{out[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    two_s = time.perf_counter() - t
    got = [result_line(o) for o in outs]
    print(f"parallel (b): one rank in {ref_s:.1f} s, two gloo ranks on one "
          f"card in {two_s:.1f} s (processes included) [{card}]")

    # launches: every rank runs its share of every path through K1-K4
    n_val = 4
    for r, g in enumerate(got):
        tr, pr, sv, ev = (g[k]["launches"] for k in
                          ("train", "predict", "serving", "eval"))
        check(tr["binary_closing"] == PARALLEL_STEPS + n_val
              and tr["maxpool2x2"] == n_val and tr["gather_db"] == 0
              and tr["relu_pool_skip"] == 0,
              f"rank {r} training launches {tr}")
        for name, c in (("predict", pr), ("serving", sv)):
            fwd = g[name]["forwards"]
            check(fwd > 0 and c["gather_db"] == c["relu_pool_skip"] == fwd
                  and c["binary_closing"] == c["maxpool2x2"] == 0,
                  f"rank {r} {name} launches {c} for {fwd} forwards")
        fwd = g["eval"]["forwards"]
        check(fwd > 0 and ev["binary_closing"] == ev["relu_pool_skip"]
              == fwd and ev["gather_db"] == ev["maxpool2x2"] == 0,
              f"rank {r} eval launches {ev} for {fwd} sub-batches")
        for name in ("train", "predict", "serving", "eval"):
            by_path[f"par2_{name}_r{r}"] = g[name]["launches"]
    for name in ("train", "predict", "serving", "eval"):
        by_path[f"par1_{name}"] = ref[name]["launches"]
    # prediction splits every sub-batch, evaluation deals them out whole
    check(all(g[k]["forwards"] == ref[k]["forwards"] for g in got
              for k in ("predict", "serving"))
          and sum(g["eval"]["forwards"] for g in got)
          == ref["eval"]["forwards"],
          "the ranks ran another number of forwards than one rank alone")

    # the ranks agree with each other
    check(got[0]["train"]["checksum"] == got[1]["train"]["checksum"]
          and got[0]["serving"]["checksum"] == got[1]["serving"]["checksum"]
          and got[0]["eval"]["hist_sum"] == got[1]["eval"]["hist_sum"],
          "the two ranks ended with different weights or outputs")
    check(got[0]["predict"]["written"] and not got[1]["predict"]["written"]
          and got[0]["serving"]["written"]
          and not got[1]["serving"]["written"],
          "a store was not written by rank 0 alone")

    # training against one rank
    l1, l2 = np.asarray(ref["train"]["losses"]), np.asarray(
        got[0]["train"]["losses"])
    p1 = torch.load(tmp / "par1" / "params.pt")
    p2 = torch.load(tmp / "par2" / "params.pt")
    w_err = max(float((p2[k] - v).abs().max()) for k, v in p1.items())
    loss_err = float(np.abs(l2 - l1).max()) if len(l1) == len(l2) else -1
    # float32 sums of two half batches round otherwise than one sum of
    # the whole (the first loss differs by ~1e-7) and 20 SGD steps amplify
    # that as they amplify any other summation order: one rank on cuDNN's
    # autotuned algorithms drifts from itself as far
    # (scripts/torch_parallel_spread.py).  A few of the 31 M weights then
    # land outside the elementwise rtol 1e-3 / atol 1e-4 on some seeds, so
    # the weights are held per tensor in max-norm, |d| <= 1e-3 x max |w| +
    # 1e-4; the elements outside the elementwise bound are counted and
    # reported
    outside = sum(int((~torch.isclose(p2[k], v, rtol=1e-3, atol=1e-4))
                      .sum()) for k, v in p1.items())
    n_w = sum(v.numel() for v in p1.values())
    worst = max(p1, key=lambda k: float((p2[k] - p1[k]).abs().max())
                / (1e-4 + 1e-3 * float(p1[k].abs().max())))
    by_step = np.abs(l2 - l1).tolist() if len(l1) == len(l2) else None
    print(f"parallel (b) training, two ranks vs one: losses max |d| "
          f"{loss_err:.3e} (by step: {by_step}), weights max |d| "
          f"{w_err:.3e}, {outside} of {n_w} weights outside rtol 1e-3 / "
          f"atol 1e-4 elementwise; nearest its max-norm bound: {worst}, "
          f"|d| {float((p2[worst] - p1[worst]).abs().max()):.3e}, max |w| "
          f"{float(p1[worst].abs().max()):.3e}")
    check(len(l1) == len(l2) == PARALLEL_STEPS
          and np.allclose(l2, l1, rtol=1e-3, atol=1e-4),
          f"training losses, two ranks {l2.tolist()} vs one {l1.tolist()}")
    check(all(float((p2[k] - v).abs().max())
              <= 1e-3 * float(v.abs().max()) + 1e-4
              for k, v in p1.items()),
          f"weights after {PARALLEL_STEPS} steps: {worst} |d| over its "
          "max-norm bound")

    # prediction: write masks identical, the stored f16 within a bound
    k1 = torch.load(tmp / "par1" / "predict_keeps.pt")
    k2 = torch.load(tmp / "par2" / "predict_keeps.pt")
    check(len(k1) == len(k2) and all(torch.equal(a, b)
                                     for a, b in zip(k1, k2)),
          "prediction write masks differ between two ranks and one")
    name = got[0]["predict"]["written"][0]
    s1 = np.load(tmp / "par_pred1_r0" / name).astype(np.float32)
    s2 = np.load(tmp / "par_pred2_r0" / name).astype(np.float32)
    pred_err = float(np.abs(s2 - s1).max())
    print(f"parallel (b) prediction, two ranks vs one: stored max |d| "
          f"{pred_err:.3e}, {int((s2 != s1).sum())} of {s1.size} values "
          f"differ")
    check(pred_err <= PARALLEL_PRED_ATOL,
          f"stored prediction: max |2 ranks - 1| {pred_err}")

    # serving preset: write masks identical, slab probabilities bounded
    o1 = torch.load(tmp / "par1" / "serving_outputs.pt")
    o2 = torch.load(tmp / "par2" / "serving_outputs.pt")
    check(len(o1["keeps"]) == len(o2["keeps"]) and all(
        torch.equal(a, b) for a, b in zip(o1["keeps"], o2["keeps"])),
        "serving write masks differ between two ranks and one")
    slab_err = max(float((b - a).abs().max())
                   for a, b in zip(o1["slabs"], o2["slabs"]))
    print(f"parallel (b) serving, two ranks vs one: slab probabilities max "
          f"|d| {slab_err:.3e}")
    check(slab_err <= PARALLEL_SLAB_ATOL,
          f"serving slab probabilities: max |2 ranks - 1| {slab_err}")
    f1 = torch.load(tmp / "par1" / "slab_f32.pt")
    f2 = torch.load(tmp / "par2" / "slab_f32.pt")
    fs = torch.load(tmp / "par2" / "slab_f32_short.pt")
    check(len(f1) == len(f2) == len(fs) > 0
          and all(a.shape == b.shape == c.shape
                  for a, b, c in zip(f1, f2, fs)),
          "float32 slab outputs differ in number or shape")
    f32_err = max(float((b - a).abs().max()) for a, b in zip(f1, f2))
    short_err = max(float((c - a).abs().max()) for a, c in zip(f1, fs))
    print(f"parallel (b) serving slab at float32, two ranks vs one: max "
          f"|d| {f32_err:.3e} with the halo of "
          f"{got[0]['serving']['f32_halo']} px, {short_err:.3e} with "
          f"{got[0]['serving']['f32_short_halo']} px (bound "
          f"{PARALLEL_SLAB_F32_ATOL:g})")
    check(got[0]["serving"]["f32_checksum"]
          == got[1]["serving"]["f32_checksum"],
          "the two ranks ended with different float32 slabs")
    check(f32_err <= PARALLEL_SLAB_F32_ATOL,
          f"float32 slab probabilities: max |2 ranks - 1| {f32_err}")
    check(short_err > PARALLEL_SLAB_F32_ATOL,
          f"a halo one pooling step short stays within the bound "
          f"({short_err}): the comparison cannot see the halo")

    # evaluation: every rank evaluates whole sub-batches, so the summed
    # histogram is one rank's bit for bit
    h1 = np.load(tmp / "par1" / "eval_hist.npy")
    h2 = np.load(tmp / "par2" / "eval_hist.npy")
    moved = int(np.abs(h2 - h1).sum()) // 2
    check(np.array_equal(h1, h2),
          f"eval histograms: per-class totals {h1.sum(axis=1)} vs "
          f"{h2.sum(axis=1)}, {moved} scores in another bin")

    for name in ("predict", "serving", "eval"):
        rates[f"par2 {name}"] = got[0][name]["pings/s"]
        rates[f"par1 {name}"] = ref[name]["pings/s"]
    rates["par2 train ms a step"] = got[0]["train"]["step_ms"]
    rates["par1 train ms a step"] = ref["train"]["step_ms"]
    print(f"parallel (b) step walls (ms, between two syncs), one rank "
          f"{ref['train']['steps_ms']}, two ranks (rank 0) "
          f"{got[0]['train']['steps_ms']}")
    print(f"parallel (b), two gloo ranks on one card vs one rank: training "
          f"{PARALLEL_STEPS} float32 steps at full width, losses max |d| "
          f"{loss_err:.3e}, weights max |d| {w_err:.3e}, "
          f"{got[0]['train']['step_ms']:.1f} vs "
          f"{ref['train']['step_ms']:.1f} ms a step; prediction write "
          f"masks identical, stored max |d| {pred_err:.3e}, "
          f"{got[0]['predict']['pings/s']:.1f} vs "
          f"{ref['predict']['pings/s']:.1f} pings/s; serving preset write "
          f"masks identical, slab max |d| {slab_err:.3e}, "
          f"{got[0]['serving']['pings/s']:.1f} vs "
          f"{ref['serving']['pings/s']:.1f} pings/s; eval histograms "
          f"bit-equal ({int(h1.sum())} scores), "
          f"{got[0]['eval']['pings/s']:.1f} vs "
          f"{ref['eval']['pings/s']:.1f} pings/s [{card}]")
    for r, g in enumerate(got):
        print(f"parallel (b) rank {r} launches: " + ", ".join(
            f"{k} {g[k]['launches']} ({g[k]['forwards']} forwards)"
            for k in ("train", "predict", "serving", "eval")) + f" [{card}]")
    return by_path, rates


# -------------------------------------------------------------- phase 17
# the onboarded survey against phase 4's store, over the pixels both
# wrote: every stored probability within ONBOARD_PRED_ATOL and at most
# ONBOARD_ARGMAX_SHARE of them with another argmax.  The onboarded sv lies
# within half an int16 power step (0.0059 dB) of the source, under half a
# bfloat16 step of the sv (0.017 dB), so a transferred value moves by one
# bfloat16 step at most; both runs use the same kernels and cuDNN
# algorithms, so what reaches the output is that input step, and the
# network's bfloat16 probabilities move in whole bfloat16 steps (2^-8 in
# [0.5, 1)).  Two card runs read exactly one such step (0.00390625) and
# 45 of 3 225 320 argmax changes (PERF.md §6); the bounds are four output
# steps, 2^-6, and 1e-4 of the pixels, 7x the reading
ONBOARD_PRED_ATOL = 2.0 ** -6
ONBOARD_ARGMAX_SHARE = 1e-4


def phase_onboarding(torch, cuda_lib, tmp, reader, cfg, card, by_path,
                     memm_store):
    """The offline onboarding chain at full width, then the onboarded
    survey through the prediction, evaluation and zarr paths, then the
    serving and samplers examples on the card."""
    import numpy as np
    import scipy.io
    from crimac_unet_tpu_torch.data import ek60, fixtures
    from crimac_unet_tpu_torch.data.mat_to_memmap import convert_survey_tree
    from crimac_unet_tpu_torch.data.memmap_reader import Echogram
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.data.preprocess import (
        batch_estimate_seabed, echograms_to_zarr_survey)
    from crimac_unet_tpu_torch.data.rechunk import rechunk_store
    from crimac_unet_tpu_torch.data.regrid import regrid_prediction
    from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    from crimac_unet_tpu_torch.examples import (example_production_serving,
                                                example_samplers)
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.pipeline.evaluate import evaluate_survey
    from crimac_unet_tpu_torch.pipeline.predict import \
        save_survey_predictions_zarr
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions

    root = tmp / "onboard"
    walls = {}

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[label] = time.perf_counter() - t
        print(f"onboarding: {label} {walls[label]:.3f} s [{card}]")
        return out

    # 1. the phase-4 echogram as the EK60 files of one cruise directory
    raw = timed("raw/bot/snap write", fixtures.write_raw_trio, reader,
                root / "cruise")
    n_raw0 = reader.shape[1] * len(reader.frequencies)
    print(f"onboarding: {Path(raw).name} {Path(raw).stat().st_size} bytes, "
          f"{n_raw0} RAW0 datagrams, {reader.n_objects} snapped schools")

    # 2. raw -> .mat -> memmap echogram dir -> cached seabed.  The
    #    converter's two steps are first timed on their own: the raw parse
    #    with the grid assembly, then the .mat write of what it returns
    raw_dir = Path(raw).parent
    snap = root / "cruise" / "ACOUSTIC" / "LSSS" / "INTERPRETATION" / (
        reader.name + ".snap")
    arrays = timed("raw parse + grid assembly", ek60.raw_to_arrays, raw,
                   bot_path=str(raw_dir / (reader.name + ".bot")),
                   snap_path=str(snap))
    timed(".mat write", scipy.io.savemat, str(tmp / "onboard_split.mat"),
          arrays, do_compression=True)
    del arrays
    (tmp / "onboard_split.mat").unlink()
    res = timed("convert_survey_raw", ek60.convert_survey_raw,
                str(root / "cruise"), str(root / "mat"))
    check(res == {reader.name: "ok"}, f"convert_survey_raw: {res}")
    converted = timed("convert_survey_tree (memmap conversion)",
                      convert_survey_tree, str(root / "mat"))
    check(converted == [reader.name], f"convert_survey_tree: {converted}")
    ech_root = root / "mat" / "memmap"
    onb = Echogram(str(ech_root / reader.name))
    timed("batch_estimate_seabed", batch_estimate_seabed, [onb])
    onb = Echogram(str(ech_root / reader.name))

    # 3. the onboarded survey against its source
    check(onb.shape == reader.shape == (1000, 4000) and onb.year == 2017,
          f"onboarded shape {onb.shape}, year {onb.year}")
    got = onb.data_numpy().astype(np.float64)
    want = reader.data_numpy().astype(np.float64)
    db_err = float(np.abs(10 * np.log10(got) - 10 * np.log10(want)).max())
    step = 10 * np.log10(2) / 512
    # half the int16 power step, plus float32 rounding of the stored sv
    # (2.6e-7 dB) and of the RAW0 fields (sample interval, pulse length,
    # absorption, beam angle: < 1e-6 dB)
    check(db_err <= step + 2e-6,
          f"onboarded sv off by {db_err} dB (half power step {step})")
    boxes = np.zeros(reader.shape, bool)
    for obj in reader.objects:
        y0, y1, x0, x1 = obj["bounding_box"]
        boxes[y0:y1 + 1, x0:x1 + 1] = True
    lab = np.asarray(onb.label_memmap(heave=False))
    check(np.array_equal(lab != 0, boxes),
          f"onboarded labels: {int((lab != 0).sum())} nonzero px, "
          f"{int(boxes.sum())} inside the boxes")
    sb_same = int((onb.get_seabed() == reader.get_seabed()).sum())
    print(f"onboarded survey {onb.shape}: sv max |d| {db_err:.6g} dB "
          f"(half power step {step:.6g}), labels nonzero exactly in the "
          f"{reader.n_objects} boxes ({int(boxes.sum())} px), seabed equal "
          f"on {sb_same} of {onb.shape[1]} pings")

    # 4. ob: the prediction main path on the onboarded survey
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()
    runner = GriddedRunner(build_unet(cfg), sd, cfg)
    out = root / "preds"
    out.mkdir()
    cuda_lib.reset_launches()
    t = time.perf_counter()
    run_save_predictions(
        cfg, runner, memm_partition(cfg, ech_root), str(out))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    ob, fwd = dict(cuda_lib.launches), runner.forwards
    mp = by_path["memm_predict"]
    check(fwd > 0 and ob["gather_db"] == ob["relu_pool_skip"] == fwd
          and ob["gather_db"] == mp["gather_db"]
          and ob["relu_pool_skip"] == mp["relu_pool_skip"],
          f"ob: launches {ob} for {fwd} forwards, phase 4's {mp}")
    pred = np.load(out / f"{onb.name}_pred.npy")
    check(pred.shape == (2,) + onb.shape and pred.dtype == np.float16
          and np.isfinite(pred).all() and pred.min() >= 0
          and pred.max() <= 1 and (pred != 0).any(),
          f"ob: prediction {pred.shape} {pred.dtype}")
    for k in range(2):
        back = regrid_prediction(pred[k], onb)
        check(np.array_equal(back.astype(np.float16), pred[k])
              and np.array_equal(back, pred[k].astype(back.dtype)),
              "regrid_prediction of the stored map moved it")
    # against phase 4's store: the onboarded sv and seabed differ a little
    # from the source's, so the write masks differ where the seabed does
    ref = np.load(memm_store / f"{reader.name}_pred.npy")
    w_on, w_ref = pred[0] != 0, ref[0] != 0
    both = w_on & w_ref
    d = np.abs(pred.astype(np.float32) - ref.astype(np.float32))[:, both]
    cls = lambda p: np.argmax(np.concatenate(
        [1 - p.astype(np.float32).sum(0, keepdims=True),
         p.astype(np.float32)]), axis=0)[both]
    flips = int((cls(pred) != cls(ref)).sum())
    moved = int((w_on != w_ref).sum())
    moved_pings = int((w_on != w_ref).any(axis=0).sum())
    print(f"ob: {fwd} forwards, launches {ob}, {dt:.3f} s = "
          f"{onb.shape[1] / dt:.1f} pings/s; against phase 4's store: "
          f"write masks differ on {moved} px in {moved_pings} pings "
          f"(seabed differs on "
          f"{onb.shape[1] - sb_same} pings), over the {int(both.sum())} px "
          f"both wrote: max |dprob| {float(d.max()):.6g}, mean "
          f"{float(d.mean()):.3g}, argmax changes {flips} [{card}]")
    check(float(d.max()) <= ONBOARD_PRED_ATOL
          and flips <= ONBOARD_ARGMAX_SHARE * both.sum(),
          f"ob against phase 4: max |dprob| {float(d.max())}, {flips} "
          f"argmax changes")

    # 5. oe: gridded evaluation of the onboarded survey
    ecfg = dict(cfg, eval_mode="all", partition_predict="selected surveys",
                evaluation_surveys=[2017], transfer_dtype="bfloat16")
    part = make_partition(ecfg, path_to_echograms=str(ech_root))
    readers = part.get_survey_readers(part.get_evaluation_surveys()[0])
    check(len(readers) == 1, f"oe: partition found {len(readers)} readers")
    runner = GriddedRunner(build_unet(ecfg), sd, ecfg)
    cuda_lib.reset_launches()
    t = time.perf_counter()
    curve = evaluate_survey(runner, readers, "all")
    torch.cuda.synchronize()
    edt = time.perf_counter() - t
    oe, efwd = dict(cuda_lib.launches), runner.forwards
    me = by_path.get("memm_eval")
    check(efwd > 0 and oe["binary_closing"] == oe["relu_pool_skip"] == efwd
          and oe["gather_db"] == 0 and oe["maxpool2x2"] == 0
          and (me is None or oe == me),
          f"oe: launches {oe} for {efwd} sub-batches (phase 5: {me})")
    f1 = float(curve["F1"].max())
    check(np.isfinite(curve["F1"]).all() and 0 <= f1 <= 1
          and np.isfinite(curve["precision"]).all()
          and np.isfinite(curve["recall"]).all(),
          f"oe: F1 {f1}")
    print(f"oe: {efwd} sub-batches, launches {oe}, {edt:.3f} s = "
          f"{onb.shape[1] / edt:.1f} pings/s, max F1 {f1:.6f} [{card}]")

    # 6. oz: zarr conversion, rechunk 1024 -> 512 pings, prediction from
    #    both stores
    zdir = root / "zarr"
    timed("echograms_to_zarr_survey", echograms_to_zarr_survey, [onb],
          str(zdir / "chunk1024"), "S2017843")
    spec = {"frequency": 1, "category": 1, "ping_time": 512, "range": 1000}
    t = time.perf_counter()
    for part_name in ("sv", "labels", "bottom"):
        rechunk_store(zdir / "chunk1024" / f"S2017843_{part_name}.zarr",
                      zdir / "chunk512" / f"S2017843_{part_name}.zarr", spec)
    for f in (zdir / "chunk1024").glob("*.csv"):
        shutil.copyfile(f, zdir / "chunk512" / f.name)
    walls["rechunk_store"] = time.perf_counter() - t
    print(f"onboarding: rechunk_store x 3 {walls['rechunk_store']:.3f} s "
          f"[{card}]")
    zcfg = dict(cfg, data_mode="zarr")
    zrunner = GriddedRunner(build_unet(zcfg), sd, zcfg)
    zouts = {}
    for chunks in ("chunk1024", "chunk512"):
        zr = DataReaderZarr(str(zdir / chunks / "S2017843_sv.zarr"))
        check(zr.sv.chunks[1] == int(chunks[5:]),
              f"{chunks}: sv chunks {zr.sv.chunks}")
        target = str(zdir / f"pred_{chunks}" / "S2017843_pred.zarr")
        f0 = zrunner.forwards
        cuda_lib.reset_launches()
        t = time.perf_counter()
        save_survey_predictions_zarr(zrunner, zr, target,
                                     preload_n_pings=zcfg["preload_n_pings"])
        torch.cuda.synchronize()
        zdt = time.perf_counter() - t
        counts, zfwd = dict(cuda_lib.launches), zrunner.forwards - f0
        zp, _ = _check_store(target, zr.shape[0], zr.shape[1],
                             f"oz {chunks}")
        check(zfwd > 0 and counts["gather_db"] == counts["relu_pool_skip"]
              == zfwd, f"oz {chunks}: launches {counts} for {zfwd}")
        zouts[chunks] = (zp, counts)
        print(f"oz {chunks}: {zfwd} forwards, launches {counts}, "
              f"{zdt:.3f} s = {zr.shape[0] / zdt:.1f} pings/s [{card}]")
    (a, ca), (b, cb) = zouts["chunk1024"], zouts["chunk512"]
    check(ca == cb, f"oz: launches {ca} (1024) vs {cb} (512)")
    check(np.array_equal(a == 0, b == 0), "oz: write sets differ")
    zd = np.abs(a.astype(np.float32) - b.astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
    check(np.all(zd <= 2 * ulp), f"oz: annotation max |d| {zd.max()}")
    same = "identical" if not zd.any() else f"within 2 ulp (max {zd.max()})"
    print(f"oz: rechunked store's annotation {same} to the 1024-ping "
          f"store's, write sets identical [{card}]")

    # 7. the examples on the card
    ex = {}
    for key, mod in (("oxp", example_production_serving),
                     ("oxs", example_samplers)):
        cuda_lib.reset_launches()
        t = time.perf_counter()
        mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        ex[key] = dict(cuda_lib.launches)
        print(f"{mod.__name__.split('.')[-1]} --device cuda: launches "
              f"{ex[key]}, {time.perf_counter() - t:.3f} s [{card}]")
    check(ex["oxp"]["gather_db"] == ex["oxp"]["relu_pool_skip"] > 0,
          f"serving example: launches {ex['oxp']}")
    check(ex["oxs"]["binary_closing"] == 1 and ex["oxs"]["gather_db"] == 0,
          f"samplers example: launches {ex['oxs']}")
    paths = {"ob": ob, "oe": oe, "oz": ca, "oz512": cb}
    paths.update(ex)
    rates = {"onboarded prediction": onb.shape[1] / dt,
             "onboarded evaluation": onb.shape[1] / edt}
    print("onboarding walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()) + f" [{card}]")
    return paths, rates


# -------------------------------------------------------------- phase 18
# The configuration matrix of tests/test_matrix.py at full width (depth 5)
# on the card: (name, overrides, mask law, mean bound, max bound) against
# the exact baseline (patch, float32 transfer, float16 output, per-chunk
# grid), each bound worked out for depth 5 from the mechanism before the
# first card run (PERF.md §6).  The probabilities are bfloat16
# softmax outputs near 0.3-0.5 under these seeded weights (one output step
# 2^-9 to 2^-8).  A bfloat16 transfer moves at most 3.4 % of the
# network's bfloat16 dB inputs by one step (0.0085 dB against steps of
# 0.25-0.5 dB): at most 2^-6 out, four output steps, where phase 17's
# one-step input change moved one.  The uint8 transfer moves up to half
# of them (0.147 dB): 2^-5.  Slab mode adds the far field that patch mode
# zero-pads: 2^-5.  The static grid changes the sub-batch and so maybe the
# cuDNN algorithm: one output step, 2^-8.  The uint8 output rounds by at
# most 1/510 and may only grow the zero set.  The terms add; each mean
# bound is 4-8x the reading of a CPU rehearsal at start_filts 8-32.
U8_OUT = 1 / 510
MATRIX = [
    ("bf16-static", dict(transfer_dtype="bfloat16", static_grid=True),
     "equal", 1e-3, 2 ** -6),
    ("u8in-static", dict(transfer_dtype="uint8", static_grid=True),
     "equal", 2e-3, 2 ** -5),
    ("u8out-static", dict(output_dtype="uint8", static_grid=True),
     "grow-small", 2e-3, U8_OUT + 2 ** -8),
    ("u8in-u8out", dict(transfer_dtype="uint8", output_dtype="uint8"),
     "grow-small", 3e-3, 2 ** -5 + U8_OUT),
    ("slab-static", dict(infer_mode="slab", static_grid=True),
     "equal", 1e-3, 2 ** -5),
    ("slab-bf16", dict(infer_mode="slab", transfer_dtype="bfloat16"),
     "equal", 2e-3, 2 ** -5 + 2 ** -6),
    ("serving-stack", dict(infer_mode="slab", static_grid=True,
                           transfer_dtype="uint8", output_dtype="uint8"),
     "grow-small", 4e-3, 2 ** -4 + U8_OUT),
    ("serving-stack-patch", dict(static_grid=True, transfer_dtype="uint8",
                                 output_dtype="uint8"),
     "grow-small", 3e-3, 2 ** -5 + U8_OUT),
]
MEMM_STACK = ("grow-small", 4e-3, 2 ** -4 + U8_OUT)   # the serving stack
META_STACK = ("equal", 3e-3, 2 ** -4)   # slab + static grid + uint8 in
SURFACE_STEPS = 20            # phase 18: full-width steps of run_training


def _matrix_check(base, out, name, law, mean_tol, max_tol):
    """A combination's chunks against the baseline's: the same chunks,
    finite values, the mask law, and the mean and max |dprob| over the
    pixels both wrote.  Returns (mean, max, extra zeros)."""
    import numpy as np
    check([c[:2] for c in out] == [c[:2] for c in base],
          f"{name}: chunks {[c[:2] for c in out]}")
    diffs, extra = [], 0
    for (_, _, p0), (_, _, p1) in zip(base, out):
        p0, p1 = p0.astype(np.float32), p1.astype(np.float32)
        check(np.isfinite(p1).all(), f"{name}: non-finite probabilities")
        z0, z1 = p0 == 0, p1 == 0
        if law == "equal":
            check(np.array_equal(z0, z1), f"{name}: zero set differs "
                                          f"({int((z0 != z1).sum())} px)")
        else:
            check(not (~z1 & z0).any(), f"{name}: the zero set shrank")
            grown = z1 & ~z0
            extra += int(grown.sum())
            if grown.any():
                top = p0[grown].max()
                check(top < max_tol + 0.5 / 255 + 1e-3,
                      f"{name}: zeroed a probability of {top}")
        diffs.append(np.abs(p0 - p1)[~z0 & ~z1])
    d = np.concatenate(diffs)
    check(d.size > 0, f"{name}: nothing written")
    mean, mx = float(d.mean()), float(d.max())
    check(mean <= mean_tol and mx <= max_tol,
          f"{name}: mean |dprob| {mean:.3e} (bound {mean_tol:.3e}), max "
          f"{mx:.3e} (bound {max_tol:.3e})")
    return mean, mx, extra


def _matrix_run(torch, cuda_lib, sd, reader, cfg, label, card):
    """A warm-up, then a timed full-survey ``predict_reader`` run of
    ``cfg`` with the launch counters set to 0 just before and read just
    after: (chunks, launches, pings/s)."""
    import numpy as np
    from crimac_unet_tpu_torch.models.unet import build_unet
    from crimac_unet_tpu_torch.pipeline.predict import predict_reader
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

    runner = GriddedRunner(build_unet(cfg), sd, cfg)
    preload = cfg["preload_n_pings"]
    for _ in predict_reader(runner, reader, preload):
        pass
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    f0 = runner.forwards
    t = time.perf_counter()
    chunks = [(s, e, np.array(p)) for s, e, p, _ in
              predict_reader(runner, reader, preload)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts, fwd = dict(cuda_lib.launches), runner.forwards - f0
    check(fwd > 0 and counts["gather_db"] == fwd
          and counts["relu_pool_skip"] == fwd and counts["maxpool2x2"] == 0
          and counts["binary_closing"] == 0,
          f"{label}: launches {counts} for {fwd} forwards")
    n_pings = reader.shape[0 if reader.data_format == "zarr" else 1]
    return chunks, counts, n_pings / dt


def phase_surface(torch, cuda_lib, tmp, card, ech_dir, reader, cfg, sv,
                  zreader, zarr_pred):
    """The configuration matrix and the restored JAX call surface at full
    width on the card (phase 18)."""
    import os
    import numpy as np
    from crimac_unet_tpu_torch.config import META_CHANNELS_ALL
    from crimac_unet_tpu_torch.data import samplers
    from crimac_unet_tpu_torch.data.device_pool import (DeviceSamplePool,
                                                        ZarrSamplePool,
                                                        gather_crops)
    from crimac_unet_tpu_torch.data.partition import make_partition
    from crimac_unet_tpu_torch.models.unet import build_unet, init_random_
    from crimac_unet_tpu_torch.ops import metrics
    from crimac_unet_tpu_torch.pipeline.eval_gridded import evaluate_reader
    from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner
    from crimac_unet_tpu_torch.pipeline.save_predict import \
        run_save_predictions
    from crimac_unet_tpu_torch.pipeline.train import run_training

    paths, rates = {}, {}
    t_phase = time.perf_counter()
    zcfg = dict(cfg, data_mode="zarr")
    sd = init_random_(build_unet(cfg), torch.Generator().manual_seed(
        SEED)).state_dict()

    def hold(name, sd, reader, base_cfg, ov, law, mean_tol, max_tol,
             base=None):
        if base is None:
            base, _, _ = _matrix_run(torch, cuda_lib, sd, reader,
                                     dict(base_cfg, transfer_dtype="float32"),
                                     f"{name} baseline", card)
        out, counts, rate = _matrix_run(
            torch, cuda_lib, sd, reader,
            dict(dict(base_cfg, transfer_dtype="float32"), **ov), name, card)
        mean, mx, extra = _matrix_check(base, out, name, law, mean_tol,
                                        max_tol)
        paths[f"x_{name}"] = counts
        rates[f"matrix {name}"] = rate
        print(f"matrix {name}: {law} mask law held ({extra} px newly "
              f"zero), mean |dprob| {mean:.3e} <= {mean_tol:.3e}, max "
              f"{mx:.3e} <= {max_tol:.3e}; launches {counts}, "
              f"{rate:.1f} pings/s [{card}]")
        return base

    # (a) the eight combinations on the phase-6 zarr survey, then the
    # serving stack on the phase-4 memm echogram and the metadata stacks
    base, counts, rates["matrix baseline"] = _matrix_run(
        torch, cuda_lib, sd, zreader, dict(zcfg, transfer_dtype="float32"),
        "zarr baseline", card)
    paths["x_baseline"] = counts
    print(f"matrix baseline (zarr, patch, float32 transfer, float16 out): "
          f"launches {counts}, {rates['matrix baseline']:.1f} pings/s "
          f"[{card}]")
    for name, ov, law, mean_tol, max_tol in MATRIX:
        hold(name, sd, zreader, zcfg, ov, law, mean_tol, max_tol, base)
    hold("memm-serving-stack", sd, reader, cfg, MATRIX[6][1], *MEMM_STACK)
    for late in (False, True):
        mcfg = dict(cfg, meta_channels=META_CHANNELS_ALL,
                    late_meta_inject=late)
        msd = init_random_(build_unet(mcfg), torch.Generator().manual_seed(
            SEED + 5)).state_dict()
        hold(f"meta-serving-{'late' if late else 'early'}", msd, reader,
             mcfg, dict(infer_mode="slab", static_grid=True,
                        transfer_dtype="uint8"), *META_STACK)
    t_matrix = time.perf_counter() - t_phase

    # (b) the restored surface on CUDA: pool.gather on both pools
    freqs, win = sorted(cfg["frequencies"]), tuple(cfg["patch_size"])
    rng = np.random.default_rng(SEED)
    for pool in (DeviceSamplePool([reader], freqs, win, device="cuda"),
                 ZarrSamplePool([zreader], freqs, win, device="cuda")):
        _, _, Hp, Wp = pool.data.shape
        idx = np.zeros(8, np.int32)
        starts = np.stack([rng.integers(0, Hp - win[0] + 1, 8),
                           rng.integers(0, Wp - win[1] + 1, 8)],
                          1).astype(np.int32)
        got = pool.gather(idx, starts)
        want = gather_crops(pool.data, pool.labels, torch.from_numpy(idx),
                            torch.from_numpy(starts), win)
        check(got[0].is_cuda and all(torch.equal(a, b)
                                     for a, b in zip(got, want)),
              f"{type(pool).__name__}.gather differs from gather_crops")
        print(f"{type(pool).__name__}.gather: 8 crops {tuple(got[0].shape)}"
              f" bit-equal to gather_crops on the card")
        del pool

    # the three update_pr_histogram formulations on one evaluation chunk
    first = []
    update = metrics.update_pr_histogram

    def keep_first(hist, preds, labels, impl=None):
        if not first:
            first.append((preds.clone(), labels.clone()))
        return update(hist, preds, labels, impl)
    metrics.update_pr_histogram = keep_first
    try:
        evaluate_reader(GriddedRunner(build_unet(zcfg), sd, zcfg), zreader,
                        metrics.new_histogram("cuda"), eval_mode="all",
                        chunk_cols=EVAL_CHUNK_COLS)
    finally:
        metrics.update_pr_histogram = update
    preds, labels = first[0]
    hists = {impl: update(metrics.new_histogram("cuda"), preds, labels, impl)
             for impl in ("scatter", "sort", "matmul")}
    times = {impl: cuda_ms(torch, lambda i=impl: update(
        metrics.new_histogram("cuda"), preds, labels, i), iters=5, warmup=1)
        for impl in hists}
    check(hists["scatter"].sum() > 0
          and all(torch.equal(h, hists["scatter"]) for h in hists.values()),
          "update_pr_histogram: the three formulations differ")
    print(f"update_pr_histogram on one evaluation chunk {tuple(preds.shape)}"
          f": scatter, sort and matmul bit-equal ("
          f"{int(hists['scatter'].sum())} scores); device ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" [{card}]")

    # run_save_predictions(config, runner, data_obj, predictions_dir), as
    # the JAX CLI calls it, on phase 6's survey in the nested layout
    nested = tmp / "p18_zarr" / "2017" / "S2017843" / "ACOUSTIC"
    nested.mkdir(parents=True)
    os.symlink(Path(sv).parent, nested / "GRIDDED")
    data_obj = make_partition(dict(zcfg, path_to_zarr_files=str(
        tmp / "p18_zarr")))
    out_dir = tmp / "p18_out"
    out_dir.mkdir()
    runner = GriddedRunner(build_unet(zcfg), sd, zcfg)
    cuda_lib.reset_launches()
    t = time.perf_counter()
    run_save_predictions(zcfg, runner, data_obj, str(out_dir))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    paths["x_save_predictions"] = counts = dict(cuda_lib.launches)
    n_pings, n_range = zreader.shape
    pred, _ = _check_store(str(out_dir / f"{zreader.name}_pred.zarr"),
                           n_pings, n_range, "run_save_predictions")
    check(counts["gather_db"] == counts["relu_pool_skip"] ==
          runner.forwards > 0, f"run_save_predictions: launches {counts}")
    check(np.array_equal(pred == 0, zarr_pred == 0),
          "run_save_predictions: write mask differs from phase 6's store")
    diff = np.abs(pred.astype(np.float32) - zarr_pred.astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(pred), np.abs(zarr_pred))).astype(
        np.float32)
    check(np.all(diff <= 2 * ulp), f"run_save_predictions: max |dprob| "
                                   f"{diff.max()} against phase 6's store")
    print(f"run_save_predictions(cfg, runner, data_obj, out): store equal "
          f"to phase 6's (write mask identical, max |dprob| {diff.max()}), "
          f"launches {counts}, {n_pings / dt:.1f} pings/s [{card}]")

    # run_training(config, checkpoint_dir, experiment_name, logger)
    tcfg = recipe_config(train_fixture(tmp), iterations=SURFACE_STEPS,
                         log_step=SURFACE_STEPS, test_iter=4, lr_step=100,
                         checkpoint_every=0, use_device_pool=True)
    ck = tmp / "p18_ck"
    cuda_lib.reset_launches()
    t = time.perf_counter()
    sp = run_training(tcfg, ck, "phase18", None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    paths["x_train"] = counts = dict(cuda_lib.launches)
    check(sp.model_name == "phase18" and sp.state.step == SURFACE_STEPS,
          f"run_training: model_name {sp.model_name}, step {sp.state.step}")
    check(counts["binary_closing"] == SURFACE_STEPS + 4
          and counts["maxpool2x2"] == 4 and counts["gather_db"] == 0
          and counts["relu_pool_skip"] == 0,
          f"run_training: launches {counts}")
    check((ck / "last.msgpack").is_file() and (ck / "best.msgpack").is_file(),
          f"run_training wrote {sorted(p.name for p in ck.iterdir())}")
    print(f"run_training(cfg, ckpt, 'phase18', None): {SURFACE_STEPS} steps "
          f"+ 4 validation, launches {counts}, {dt:.1f} s, best F1 "
          f"{sp.best_F1_val:.4f}, checkpoints "
          f"{sorted(p.name for p in ck.iterdir())} [{card}]")

    # get_gridded_survey_sampler with eval_mode fish: a trace sampler
    part = make_partition(dict(cfg, eval_mode="fish",
                               path_to_echograms=str(ech_dir)))
    (grid,) = part.get_gridded_survey_sampler(2017)
    kw = dict(window_size=cfg["patch_size"],
              patch_overlap=cfg["patch_overlap"])
    readers = part.get_survey_readers(2017)
    trace = samplers.Gridded(readers, mode="trace", **kw)
    full = samplers.Gridded(readers, mode="all", **kw)
    check(0 < len(grid) < len(full)
          and np.array_equal(grid.coords_list, trace.coords_list),
          f"get_gridded_survey_sampler(fish): {len(grid)} centres, trace "
          f"{len(trace)}, all {len(full)}")
    print(f"get_gridded_survey_sampler(2017), eval_mode fish: the trace "
          f"sampler ({len(grid)} of {len(full)} centres)")
    print(f"phase 18: matrix {t_matrix:.1f} s, all "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return paths, rates


# -------------------------------------------------------------- phase 19
# The JAX package's trained-weight and survey-scale checks (the six
# scripts behind config_serving.yaml's defaults), run through the port's
# scripts/torch_*.py with phase 12's trained best.msgpack.  Each bound was
# written before the first card run of phase 19 (PERF.md §6, PR 12),
# from the issue's starting table; the JAX package's records on the same
# fixtures are in brackets (docs/SESSIONS.md).
SOAK_PINGS = 20_000           # 5x the longest echogram run before phase 19
U8_DF1 = {"patch_u8": 2e-4, "serving_u8": 5e-3}   # [1e-5, 1.1e-3]
# output-u8 alone, max |d| [0.0022]: the code's rounding is at most 1/510
# (half of 1/255); the float16 output and the code's float16 dequant each
# round by at most half a float16 ulp, 2^-12 for p in [0.5, 1), so the
# law is 1/510 + 2^-11.  tests/test_torch_trained_checks.py
# ::test_output_u8_deviation_law shows every correct implementation, the
# JAX package's included, exceeds 1/510 + 2^-12 and meets this bound
# (ROADMAP C F15).
U8_OUT_MAX = 1 / 510 + 2 ** -11
U8_OUT_DF1 = 1e-4             # output-u8 alone, |dF1| [0.0]
EVAL_DF1 = 1e-4               # bfloat16 and uint8 against float32 [6.3e-6]
GEOM_DF1 = 2e-3               # each serving arm against its oracle [1e-5,
                              # 2e-5]
SOAK_RSS_CAP = 256 * 2 ** 20  # streaming RSS delta, absolute
SOAK_RSS_RATIO, SOAK_RSS_SLACK = 1.5, 32 * 2 ** 20   # ... against 4000 pings
SOAK_DEVICE_RATIO = 1.1       # peak device memory against 4000 pings
PREDICT_PATHS = ("u8_", "geom_", "school_ap", "soak_patch", "soak_slab")


def _first_call_probe(torch, card, counts=None):
    """A ``Paths`` probe: within one path, the first call of each kernel
    is held bit for bit to its plain version on the same inputs, right
    after the call (plain versions launch no kernel): K1 (``gather_db``,
    as the runner calls it) and K3 (``relu_pool_skip``, as the U-Net
    calls it), and with ``counts`` (the ``Paths``' counts, read when the
    path ends) also K2 (``maxpool2x2``, as the U-Net calls it) and K4
    (``binary_closing``, as the label chain calls it); then the kernels
    held must be those the path launched."""
    import contextlib
    from crimac_unet_tpu_torch.models import unet
    from crimac_unet_tpu_torch.ops import label_ops
    from crimac_unet_tpu_torch.ops.closing import binary_closing_reference
    from crimac_unet_tpu_torch.ops.gather_db import gather_db_reference
    from crimac_unet_tpu_torch.ops.pool import (maxpool2x2_reference,
                                                relu_pool_skip_reference)
    from crimac_unet_tpu_torch.pipeline import runner

    def same(out, want):
        if isinstance(out, tuple):
            return all(g.is_cuda and equal_nan(torch, g, w)
                       for g, w in zip(out, want))
        return out.is_cuda and equal_nan(torch, out, want)
    # kernel -> (module, attribute, plain version)
    sites = {"gather_db": (runner, "gather_db", gather_db_reference),
             "relu_pool_skip": (unet, "relu_pool_skip",
                                relu_pool_skip_reference)}
    if counts is not None:
        sites.update(maxpool2x2=(unet, "maxpool2x2", maxpool2x2_reference),
                     binary_closing=(label_ops, "binary_closing",
                                     binary_closing_reference))

    @contextlib.contextmanager
    def probe(name):
        seen = {}

        def spy(kernel, real, plain):
            def call(*args, **kw):
                out = real(*args, **kw)
                if kernel not in seen:
                    # K1 by its output (its input is the slab), the
                    # others by their input
                    shape = tuple((out if kernel == "gather_db"
                                   else args[0]).shape)
                    check(same(out, plain(*args, **kw)),
                          f"{name}: {kernel} != plain at {shape} from "
                          f"{tuple(args[0].shape)} {args[0].dtype}")
                    seen[kernel] = shape
                return out
            return call
        reals = {k: getattr(mod, attr) for k, (mod, attr, _) in sites.items()}
        for k, (mod, attr, plain) in sites.items():
            setattr(mod, attr, spy(k, reals[k], plain))
        try:
            yield
        finally:
            for k, (mod, attr, _) in sites.items():
                setattr(mod, attr, reals[k])
        if counts is None:
            predicts = name.startswith(PREDICT_PATHS)
            check("relu_pool_skip" in seen
                  and ("gather_db" in seen) == predicts,
                  f"{name}: first calls held {seen}")
        else:
            launched = {k for k in KERNELS if counts[name][k] > 0}
            check(set(seen) == launched, f"{name}: first calls held "
                                         f"{seen}, launched {launched}")
        print(f"{name}: first call bit-equal to plain: "
              + ", ".join(f"{k} {v}" for k, v in seen.items()) + f" [{card}]")
    return probe


def _check_path_launches(paths):
    """K1 = K3 = forwards on every prediction path, K4 = K3 = sub-batches
    on every evaluation path, K2 never (``fold_bn: true``)."""
    for name, c in paths.items():
        k = ("gather_db" if name.startswith(PREDICT_PATHS)
             else "binary_closing")
        off = {"gather_db", "binary_closing"} - {k}
        check(c["forwards"] > 0 and c[k] == c["relu_pool_skip"]
              == c["forwards"] and c["maxpool2x2"] == 0
              and all(c[o] == 0 for o in off),
              f"{name}: launches {c}")


def _bound(label, value, ok, bound):
    check(ok, f"{label}: {value} outside its bound {bound}")
    print(f"  {label}: {value} (bound {bound})")


def phase_trained(torch, tmp, card, sv, ckpt, soak_pings):
    """The trained-weight and survey-scale checks at full width (phase
    19): scripts/torch_u8_bound.py, torch_eval_u8_bound.py and
    torch_serving_geometry_ab.py on phase 6's survey, torch_school_ap_
    trained.py on the big held-out fixture, torch_soak50k.py (patch, slab,
    eval uint8) at ``soak_pings`` and at phase 6's 4000 pings, and
    torch_school_eval_soak.py at ``soak_pings``, each reading printed
    beside its bound."""
    sys.path.insert(0, str(ROOT))
    from scripts import torch_soak50k
    work = tmp / "p19"
    # the soak survey is written by a child while the other checks run
    child = torch_soak50k.start_fixture(work, soak_pings)
    try:
        return _trained_checks(torch, card, work, sv, ckpt, soak_pings,
                               child)
    finally:         # a failed check must not leave the writer running
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()


def _trained_checks(torch, card, work, sv, ckpt, soak_pings, child):
    import numpy as np
    from scripts import (torch_check_common as common, torch_eval_u8_bound,
                         torch_school_ap_trained, torch_school_eval_soak,
                         torch_serving_geometry_ab, torch_soak50k,
                         torch_u8_bound)
    t_phase = time.perf_counter()
    paths = common.Paths(_first_call_probe(torch, card))
    sd = common.state_dict(ckpt)
    print("phase 19: weights " + (str(ckpt) if isinstance(ckpt, (str, Path))
                                  else type(ckpt).__name__))
    mb = 2 ** -20

    u8 = torch_u8_bound.run(sd, sv, "cuda", paths=paths)
    print(f"u8 bound: exact_f32 F1 {u8['f1_exact_f32']:.6f}, walls (s) "
          f"{u8['walls_s']} [{card}]")
    for m in ("patch_u8", "serving_u8"):
        r = u8[m]
        print(f"u8 {m}: F1 {r['f1']:.6f}, |dprob| mean "
              f"{r['mean_abs_dprob']:.3e} p99 {r['p99_abs_dprob']:.3e} max "
              f"{r['max_abs_dprob']:.3e}")
        _bound(f"u8 {m} write mask equal to exact_f32's", r["masks_equal"],
               r["masks_equal"], True)
        _bound(f"u8 {m} |dF1|", r["abs_dF1"], r["abs_dF1"] <= U8_DF1[m],
               U8_DF1[m])
    r = u8["serving_out_u8"]
    print(f"u8 serving_out_u8: F1 {r['f1']:.6f}, |dF1| {r['abs_dF1']:.3e}, "
          f"|dprob| mean {r['mean_abs_dprob']:.3e} max "
          f"{r['max_abs_dprob']:.3e}")
    iso = u8["output_u8_isolated"]
    p_cut = float(np.float16(1 / 510))
    _bound("output-u8 alone, max |d|", iso["max_abs_dprob"],
           iso["max_abs_dprob"] <= U8_OUT_MAX, U8_OUT_MAX)
    _bound(f"output-u8 alone, largest p at the {iso['n_extra_zero']} "
           f"extra zeros", iso["max_p_at_extra_zero"],
           iso["max_p_at_extra_zero"] <= p_cut, f"<= f16(1/510) = {p_cut}")
    _bound("output-u8 alone, |dF1| vs serving_u8",
           iso["abs_dF1_vs_serving_u8"],
           iso["abs_dF1_vs_serving_u8"] <= U8_OUT_DF1, U8_OUT_DF1)

    ev = torch_eval_u8_bound.run(sd, sv, "cuda", paths=paths)
    for td in torch_eval_u8_bound.TRANSFERS:
        print(f"eval {td}: max F1 {ev[td]['max_f1']:.6f}, scored "
              f"{ev[td]['n_scored']}, positive {ev[td]['n_pos']} [{card}]")
    counts = {td: (ev[td]["n_scored"], ev[td]["n_pos"])
              for td in torch_eval_u8_bound.TRANSFERS}
    for td in ("bfloat16", "uint8"):
        d = abs(ev[td]["dF1_vs_float32"])
        _bound(f"eval {td} scored / positive counts", counts[td],
               counts[td] == counts["float32"], counts["float32"])
        _bound(f"eval {td} |dF1| vs float32", d, d <= EVAL_DF1, EVAL_DF1)

    ge = torch_serving_geometry_ab.run(sd, sv, "cuda", passes=2,
                                       paths=paths)
    for tag in ("ov20", "ov16"):
        r = ge[tag]
        print(f"geometry {tag} (stride {r['stride']}, aligned "
              f"{r['aligned']}): F1 oracle {r['f1_oracle']:.6f} serving "
              f"{r['f1_serving']:.6f}; slab vs patch-u8: "
              f"{r['slab_vs_patch_u8']}; {r['pings_per_sec']:.1f} pings/s "
              f"[{card}]")
        _bound(f"geometry {tag} |dF1| vs its oracle", r["abs_dF1"],
               r["abs_dF1"] <= GEOM_DF1, GEOM_DF1)
        _bound(f"geometry {tag} warned", r["warned"],
               r["warned"] == (tag == "ov20"), tag == "ov20")

    val = torch_school_ap_trained.ensure_big_val_fixture(work)
    ap = torch_school_ap_trained.run(sd, val, "cuda", paths=paths)
    for name, cm in ap["categories"].items():
        print(f"school AP {name}: AP@.25/.5/.75 {cm['ap']}, recall "
              f"{cm['recall']}, {cm['n_detections']} det / {cm['n_gt']} gt")
        want = torch_school_ap_trained.BIG_VAL_GT[name]
        _bound(f"school AP {name} ground truth", cm["n_gt"],
               cm["n_gt"] == want, want)
    _bound(f"school AP mAP over {ap['n_echograms']} echograms "
           f"({ap['eval_s']:.2f} s)", ap["mean_ap"],
           0 < ap["mean_ap"] <= 1, "(0, 1]")

    rates = {"trained geometry ov20 serving": ge["ov20"]["pings_per_sec"],
             "trained geometry ov16 serving": ge["ov16"]["pings_per_sec"]}
    t = time.perf_counter()
    big = torch_soak50k.ensure_fixture(work, soak_pings, child=child)
    print(f"soak survey waited for {time.perf_counter() - t:.1f} s")
    for mode in ("patch", "slab", "eval"):
        soak = {}
        arms = [("ref", sv, False), ("soak", big, False)]
        if mode == "slab":
            # the control arm: the same survey on one grid shape
            arms.append(("control", big, True))
        for label, survey, static in arms:
            soak[label] = r = torch_soak50k.run(
                mode, sd, survey, "cuda", out=work / f"pred_{mode}_{label}"
                                              ".zarr", paths=paths,
                static_grid=static)
            n = r["n_pings"]
            key = f"soak_{mode}" + ("_uint8" if mode == "eval" else "") \
                + ("_static" if static else "")
            paths.counts[f"{key}_{n}"] = paths.counts.pop(key)
            print(f"soak {mode} {n} pings{' static grid' if static else ''}"
                  f": {r['wall_s']:.3f} s = "
                  f"{r['pings_per_sec']:.1f} pings/s, RSS delta "
                  f"{r['rss_delta_bytes'] * mb:.1f} MiB (before "
                  f"{r['rss_before_bytes'] * mb:.1f} MiB), peak device "
                  f"{r['peak_device_bytes'] * mb:.1f} MiB, codec "
                  f"{r['codec_backend']}, survey compressor "
                  f"{r['survey_compressor']}; timers {r['timers']} [{card}]")
            # where the host memory sits, chunk by chunk (F16): RSS,
            # distinct U-Net input shapes so far, the pinned host cache,
            # glibc's malloc counters (MiB)
            print(f"  {torch_soak50k.scan_line(r)}; "
                  f"{len(r['forward_shapes'])} forward shapes "
                  f"{r['forward_shapes']}; per chunk:")
            print("\n".join(torch_soak50k.chunk_lines(
                r, max(1, len(r["chunks"]) // 25))))
            if mode == "eval":
                _bound(f"soak eval {n} pings scored px", r["n_scored"],
                       r["n_scored"] > 0, "> 0")
            else:
                print(f"  store {r['store_shape']}, compressor "
                      f"{r['store_compressor']}, {r['written_px']} px "
                      f"written, {r['pings_with_output']} pings with output")
                full = (r["store_pings"] == n and r["ping_time_equal"]
                        and r["store_finite"] and r["written_px"] > 0)
                _bound(f"soak {mode} {n} pings store complete, every ping "
                       f"written", r["store_pings"], full, n)
        ref, s = soak["ref"], soak["soak"]
        cap = min(SOAK_RSS_CAP, SOAK_RSS_RATIO * ref["rss_delta_bytes"]
                  + SOAK_RSS_SLACK)
        _bound(f"soak {mode} {soak_pings} pings RSS delta (MiB)",
               s["rss_delta_bytes"] * mb, s["rss_delta_bytes"] <= cap,
               f"min(256, 1.5 x {ref['rss_delta_bytes'] * mb:.1f} + 32) = "
               f"{cap * mb:.1f}")
        dev_cap = SOAK_DEVICE_RATIO * ref["peak_device_bytes"]
        _bound(f"soak {mode} {soak_pings} pings peak device memory (MiB)",
               s["peak_device_bytes"] * mb,
               s["peak_device_bytes"] <= dev_cap,
               f"1.1 x {ref['peak_device_bytes'] * mb:.1f} = "
               f"{dev_cap * mb:.1f}")
        rates[f"soak {mode} {soak_pings} pings"] = s["pings_per_sec"]

    det = torch_school_eval_soak.run(soak_pings)
    print(f"detector soak: {det['n_pings']} pings x {det['n_range']}, "
          f"{det['detections']} detections in {det['wall_s']:.3f} s = "
          f"{det['pings_per_sec']:.1f} pings/s, RSS delta "
          f"{det['rss_delta_bytes'] * mb:.1f} MiB [{card}]")
    _bound(f"detector soak streamed == dense on {det['dense_equal_pings']} "
           f"pings", det["dense_equal"], det["dense_equal"], True)
    rates["detector soak"] = det["pings_per_sec"]

    _check_path_launches(paths.counts)
    print("phase 19 launches: " + ", ".join(
        f"{k} {v}" for k, v in paths.counts.items()))
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {f"p19_{k}": {n: v for n, v in c.items() if n != "forwards"}
            for k, c in paths.counts.items()}, rates



# -------------------------------------------------------------- phase 20
# Where the time goes: the port's counterparts of the JAX repo's
# measurement scripts (scripts/torch_roofline.py, torch_roofline_bwd.py,
# torch_decomp.py, torch_predict_timeline.py, torch_host_slab_profile.py,
# torch_host_scaling.py) at full width with seeded weights.  Each bound
# was written before the first card run of phase 20 (PERF.md §6).
ROW_TIME_MIN = 0.95           # every roofline row: time >= 0.95 x its bound
                              # (a share above 105 % of a roofline is a
                              # miscount or an L2 hit, not a fast kernel)
DEVICE_BUSY_MAX = 1.0         # the timeline's device-busy share of the wall
THREAD_BUSY_MAX = 1.05        # each thread's intervals (nested ones merged)
                              # over the wall
WTG_TRAIN_BATCH = 4           # the forward roofline's train batch
WTG_BWD_BATCH = 8             # the training roofline's batch


def _rows_within(label, rows):
    """Each (name, ms, bound ms) at least ROW_TIME_MIN x its bound; prints
    the row closest to its bound."""
    for name, ms, b in rows:
        check(ms >= ROW_TIME_MIN * b, f"{label} {name}: {ms:.4f} ms, below "
                                      f"{ROW_TIME_MIN} x its bound {b:.4f} ms")
    name, ms, b = max(rows, key=lambda r: r[2] / max(r[1], 1e-12))
    print(f"  {label}: {len(rows)} rows, each time >= {ROW_TIME_MIN} x its "
          f"bound; closest {name} {ms:.4f} ms against {b:.4f} ms "
          f"({b / ms:.1%} of its roofline)")


def _forward_rows(res):
    rows = [("probe.read", res["probe"]["ms"], res["probe"]["bound_ms"])] \
        if "probe" in res else []
    for r in res["layers"]:
        rows.append((r["layer"], r["ms"], r["bound_ms"]))
        if r["kind"] == "pool":
            rows += [(r["layer"] + " K2", r["k2_ms"], r["k2_bound_ms"]),
                     (r["layer"] + " F.max_pool2d", r["maxpool2d_ms"],
                      r["k2_bound_ms"])]
            if "k3_ms" in r:
                rows.append((r["layer"] + " K3", r["k3_ms"],
                             r["k3_bound_ms"]))
    rows.append(("whole forward", res["whole_forward_ms"],
                 res["bound_floor_ms"]))
    return rows


def _pool_kernels_bit_equal(label, layers):
    for r in layers:
        if r["kind"] == "pool":
            check(r["k2_equal"] and r["k3_equal"],
                  f"{label} {r['layer']}: K2 {r['k2_equal']}, K3 "
                  f"{r['k3_equal']} against their plain versions")
    n = sum(r["kind"] == "pool" for r in layers)
    print(f"  {label}: K2 and K3 bit-equal to their plain versions at the "
          f"{n} pool shapes (bound: bit-equal)")


def _quiet_launches(c, on, label):
    """The kernels in ``on`` launched, every other one not."""
    check(all(c[k] > 0 for k in on)
          and all(v == 0 for k, v in c.items() if k not in on),
          f"{label}: launches {c}, expected only {on}")


def phase_where_time_goes(torch, cuda_lib, tmp, card, sv):
    """Where the time goes (phase 20): each tool's ``run()`` at full
    width, its tables printed, then every check beside its bound.
    Returns (launches by path, rates)."""
    sys.path.insert(0, str(ROOT))
    from scripts import (torch_check_common as common, torch_decomp,
                         torch_host_scaling, torch_host_slab_profile,
                         torch_predict_timeline, torch_roofline,
                         torch_roofline_bwd, torch_timing_common as tc)
    t_phase = time.perf_counter()
    check(tc.HBM_BYTES_PER_S == HBM_BYTES_PER_S,
          f"the tools' HBM rate {tc.HBM_BYTES_PER_S} != {HBM_BYTES_PER_S}")
    work = tmp / "p20"
    work.mkdir(exist_ok=True)
    by_path, rates = {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        by_path[f"p20_{name}"] = dict(cuda_lib.launches)
        return out

    print(f"phase 20: where the time goes [{card}]")
    fwd = counted("roofline", lambda: torch_roofline.run(
        "cuda", batch=32, train_batch=WTG_TRAIN_BATCH))
    bwd = counted("roofline_bwd", lambda: torch_roofline_bwd.run(
        "cuda", batch=WTG_BWD_BATCH))
    dpred = counted("decomp_predict",
                    lambda: torch_decomp.run_predict("cuda", sv))
    dtrain = counted("decomp_train", lambda: torch_decomp.run_train("cuda"))
    cfg = common.model_config()
    sd = torch_roofline.seeded_state_dict(cfg)
    reader = common.zarr_reader(sv)
    arms = {arm: counted(f"timeline_{arm}", lambda arm=arm:
                         torch_predict_timeline.run_arm(
                             arm, sd, reader, work, "cuda"))
            for arm in ("default", "serving")}
    prof = counted("host_profile", lambda: torch_host_slab_profile.run(
        "cuda", sv, work=work))
    scal = counted("host_scaling", lambda: torch_host_scaling.run(
        "cuda", sv, work=work))

    print(f"phase 20 checks [{card}]:")
    _rows_within("forward roofline, batch 32", _forward_rows(fwd))
    tb = fwd["train_batch"]
    _rows_within(f"forward roofline, batch {WTG_TRAIN_BATCH}",
                 _forward_rows(tb))
    _pool_kernels_bit_equal("forward roofline, batch 32", fwd["layers"])
    _pool_kernels_bit_equal(f"forward roofline, batch {WTG_TRAIN_BATCH}",
                            tb["layers"])
    brows = [(r["layer"] + " fwd", r["fwd_ms"], r["fwd_bound_ms"])
             for r in bwd["layers"]]
    brows += [(r["layer"] + " fwd+bwd", r["fwdbwd_ms"],
               r["fwd_bound_ms"] + r["bwd_bound_ms"]) for r in bwd["layers"]]
    _rows_within(f"training roofline, batch {WTG_BWD_BATCH}", brows)
    _rows_within(f"train-mode BatchNorm, batch {WTG_BWD_BATCH}",
                 [(r["layer"] + " fwd", r["fwd_ms"], r["bound_pass_ms"])
                  for r in bwd["bn_rows"]]
                 + [(r["layer"] + " fwd+bwd", r["fwdbwd_ms"],
                     2 * r["bound_pass_ms"]) for r in bwd["bn_rows"]])
    _rows_within("SGD update", [("update", bwd["update_ms"],
                                 bwd["update_bound_ms"])])
    _bound(f"training roofline: K4 a full step ({bwd['step_steps']} "
           f"steps)",
           bwd["step_k4_launches"], bwd["step_k4_launches"] == 1, 1)

    nb = dpred["sub_batches"]
    lp = dpred["launches"]
    _bound("decomposition: K1 bit-equal to its plain version",
           dpred["k1_equal"], dpred["k1_equal"], True)
    _bound("decomposition: full chunk bit-equal to predict_reader's",
           dpred["full_equal"], dpred["full_equal"], True)
    _bound("decomposition: full chunk K1, K3, forwards",
           (lp["gather_db"], lp["relu_pool_skip"], lp["forwards"]),
           lp["gather_db"] == lp["relu_pool_skip"] == lp["forwards"] == nb
           and lp["maxpool2x2"] == lp["binary_closing"] == 0,
           f"sub-batches = {nb}")
    for b, r in dtrain.items():
        _bound(f"train decomposition {b}: K4 a full step",
               r["full_step"]["launches"]["binary_closing"],
               r["full_step"]["launches"]["binary_closing"] == 1, 1)
        _bound(f"train decomposition {b}: K2 an eval-BN forward",
               r["fwd_evalbn"]["launches"]["maxpool2x2"],
               r["fwd_evalbn"]["launches"]["maxpool2x2"] == 1, 1)

    for arm, r in arms.items():
        _bound(f"timeline {arm}: store bit-identical to an uninstrumented "
               f"pass", r["store_equal"], r["store_equal"], True)
        busy = r["device_busy_share"]
        _bound(f"timeline {arm}: device-busy share", busy,
               busy is not None and 0 < busy <= DEVICE_BUSY_MAX,
               f"(0, {DEVICE_BUSY_MAX}]")
        worst = max(r["thread_busy_share"].items(), key=lambda kv: kv[1])
        _bound(f"timeline {arm}: busiest thread {worst[0]} (share of the "
               f"wall)", round(worst[1], 4), worst[1] <= THREAD_BUSY_MAX,
               THREAD_BUSY_MAX)
        rates[f"timeline {arm}"] = r["pings_per_sec"]

    for label, res in (("host profile", prof), ("host scaling", scal)):
        bad = [k for k, v in res["equal"].items() if not v]
        _bound(f"{label}: components equal to the pipeline's chunk 0 "
               f"({len(res['equal'])})", f"unequal {bad}", not bad,
               "unequal []")
    dt = scal["decoder_threads"]
    _bound(f"host scaling: slab identical at decoder threads {sorted(dt)}",
           all(r["slab_equal"] for r in dt.values()),
           all(r["slab_equal"] for r in dt.values()), True)
    cc = scal["concurrent"]
    _bound(f"host scaling: slabs identical at {sorted(cc)} concurrent "
           f"assemblies", all(r["slab_equal"] for r in cc.values()),
           all(r["slab_equal"] for r in cc.values()), True)

    for name, c in by_path.items():
        if name in ("p20_roofline",):
            _quiet_launches(c, ("maxpool2x2", "relu_pool_skip"), name)
        elif name in ("p20_roofline_bwd",):
            _quiet_launches(c, ("binary_closing",), name)
        elif name == "p20_decomp_train":
            _quiet_launches(c, ("binary_closing", "maxpool2x2"), name)
        else:
            _quiet_launches(c, ("gather_db", "relu_pool_skip"), name)
            if name.startswith("p20_timeline"):
                check(c["gather_db"] == c["relu_pool_skip"],
                      f"{name}: launches {c}")
    print("phase 20 launches: " + ", ".join(
        f"{k} {v}" for k, v in by_path.items()))
    rates["whole forward ms a call of 32"] = fwd["whole_forward_ms"]
    rates["train step ms at batch 8"] = bwd["step_ms"]
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return by_path, rates


# -------------------------------------------------------------- phase 21
# The JAX repo's A/B benches and recipe studies (scripts/torch_eval_quant_
# bench.py ... torch_static_grid.py, torch_r3_session.py) at full width.
# Each bound was written before the first card run of phase 21 (PERF.md
# §6); timings are printed, not bounded.
# Every recipe arm runs its exact configuration but for these three keys,
# cut so that each arm takes one validation: 20 steps, then 10 validation
# batches (b16: 20 x 16 crops, b32: 20 x 32, ab_*: 20 x 4).
RECIPE_CUT = {"iterations": 20, "log_step": 20, "test_iter": 10}
STATIC_MAX_DPROB = 4e-3       # the static-grid arms' max |dprob| (bf16 on
                              # another sub-batch size; JAX's rule)


def _launch_law(label, c, want):
    """Each kernel's count in ``c`` equal to ``want``'s (0 when absent)."""
    got = {k: c[k] for k in KERNELS}
    exp = {k: want.get(k, 0) for k in KERNELS}
    _bound(f"{label} launches", got, got == exp, exp)


def _recipe_checks(name, r):
    """A recipe arm cut to RECIPE_CUT: every loss finite, the device pool
    (and with metadata its pooled metadata path) on, K4 once per train and
    validation step, K2 once per validation step, K1 and K3 never."""
    _bound(f"{name}: steps", r["steps"],
           r["steps"] == RECIPE_CUT["iterations"], RECIPE_CUT["iterations"])
    _bound(f"{name}: every training loss finite", r["losses_finite"],
           r["losses_finite"], True)
    _bound(f"{name}: device pool on", r["pooled"], r["pooled"], True)
    if "pooled_meta" in r:
        _bound(f"{name}: pooled metadata path", r["pooled_meta"],
               r["pooled_meta"], True)
    _launch_law(name, r["launches"], {
        "binary_closing": r["steps"] + r["val_steps"],
        "maxpool2x2": r["val_steps"]})


def _hold_sub_batches(torch, card, reader, cfg, batches):
    """K1 (within one ulp, as phase 2) and K3 (bit-equal) against their
    plain versions at each forward sub-batch size in ``batches``: the
    static-grid arms run in processes of their own, out of the first-call
    probe's reach.  K1 over the main path's first-chunk slab (float32 and
    bfloat16) with its patch starts repeated to B, K3 on seeded (B, 256,
    256, 64) bfloat16 with NaN and +-Inf."""
    import numpy as np
    from crimac_unet_tpu_torch.ops.gather_db import (gather_db,
                                                     gather_db_reference)
    from crimac_unet_tpu_torch.ops.pool import (relu_pool_skip,
                                                relu_pool_skip_reference)
    dev = torch.device("cuda")
    win = tuple(cfg["patch_size"])
    raw, y0s, x0s, border, _, _ = first_chunk_inputs(torch, reader, cfg)
    for b in batches:
        idx = np.arange(b) % len(y0s)
        y0 = torch.from_numpy(np.ascontiguousarray(y0s[idx])).to(dev)
        x0 = torch.from_numpy(np.ascontiguousarray(x0s[idx])).to(dev)
        for sdtype in (torch.float32, torch.bfloat16):
            args = (raw.to(dev, sdtype), y0, x0, win, border, False,
                    torch.bfloat16)
            err, ok = max_ulp_err(torch, gather_db(*args),
                                  gather_db_reference(*args))
            torch.cuda.synchronize()
            check(ok, f"gather_db off by more than one ulp at ({b}, "
                      f"{win[0]}, {win[1]}, {raw.shape[2]}) from a "
                      f"{sdtype} slab: {err}")
        x = torch.randn((b, *win, cfg["start_filts"]),
                        generator=torch.Generator().manual_seed(SEED + b))
        x.view(-1)[:x.numel():9973] = float("nan")
        x.view(-1)[1:x.numel():10007] = float("inf")
        x = x.to(dev, torch.bfloat16)
        for got, want in zip(relu_pool_skip(x), relu_pool_skip_reference(x)):
            check(equal_nan(torch, got, want),
                  f"relu_pool_skip != plain at {tuple(x.shape)}")
        torch.cuda.synchronize()
    print(f"static grid sub-batches {sorted(batches)}: gather_db within one "
          f"ulp, relu_pool_skip bit-equal to plain [{card}]")


def phase_ab(torch, tmp, card, sv, ckpt, reader, cfg):
    """The A/B benches and recipe studies (phase 21): evaluation by
    transfer dtype, live school detection and its store law, the detector
    post-processing sweep held to live runs, pooled against host metadata
    steps, the static grid's cold arms in subprocesses, and the fast,
    metadata and float32 / bfloat16 recipe arms cut to one validation.
    Every in-process path holds the first call of each kernel it launches
    to its plain version (``_first_call_probe``); the static-grid arms'
    sub-batch sizes are held after them (``_hold_sub_batches``).
    Returns (launches by path, rates)."""
    import shutil

    sys.path.insert(0, str(ROOT))
    from scripts import (torch_check_common as common, torch_eval_quant_bench,
                         torch_fast_recipe, torch_meta_recipe,
                         torch_pooled_meta_bench, torch_r3_session,
                         torch_school_ap_trained, torch_school_postproc_sweep,
                         torch_school_serving_bench, torch_static_grid)
    t_phase = time.perf_counter()
    work = tmp / "p21"
    work.mkdir(exist_ok=True)
    paths = common.Paths()
    paths.probe = _first_call_probe(torch, card, paths.counts)
    sd = common.state_dict(ckpt)
    rates = {}
    print("phase 21: weights " + (str(ckpt) if isinstance(ckpt, (str, Path))
                                  else type(ckpt).__name__) + f" [{card}]")

    ev = torch_eval_quant_bench.run(sd, sv, "cuda", paths=paths)
    t32 = ev["transfers"]["float32"]
    for td, r in ev["transfers"].items():
        print(f"eval {td}: {r['pings_per_sec']:.1f} pings/s (walls "
              f"{r['walls_s']} s, first pass {r['first_pass_s']:.2f} s), F1 "
              f"{r['f1']:.6f}, scored {r['n_scored']}, positive "
              f"{r['n_pos']} [{card}]")
        rates[f"eval {td} transfer (trained)"] = r["pings_per_sec"]
        if td != "float32":
            _bound(f"eval {td} scored / positive counts",
                   (r["n_scored"], r["n_pos"]),
                   (r["n_scored"], r["n_pos"])
                   == (t32["n_scored"], t32["n_pos"]),
                   (t32["n_scored"], t32["n_pos"]))
            _bound(f"eval {td} |dF1| vs float32", r["abs_dF1_vs_float32"],
                   r["abs_dF1_vs_float32"] <= EVAL_DF1, EVAL_DF1)
        c = paths.counts[f"evalq_{td}"]
        _launch_law(f"eval {td} ({c['forwards']} sub-batches over 3 passes)",
                    c, {"binary_closing": c["forwards"],
                        "relu_pool_skip": c["forwards"]})

    se = torch_school_serving_bench.run(sd, sv, "cuda", paths=paths)
    for tag in torch_school_serving_bench.ARMS:
        r = se[tag]
        print(f"live school detection [{tag}]: {r['pings_per_sec']:.1f} "
              f"pings/s (walls {r['walls_s']} s), detections "
              f"{r['n_detections']}; prediction alone "
              f"{r['predict_pings_per_sec']:.1f} pings/s (walls "
              f"{r['predict_walls_s']} s): detector {r['detector_s']:.3f} s, "
              f"share {r['detector_share']:.3f} [{card}]")
        rates[f"live school detection {tag} (trained)"] = r["pings_per_sec"]
        rates[f"prediction alone {tag} (trained)"] = \
            r["predict_pings_per_sec"]
        _bound(f"school detection [{tag}]: live == from its store",
               r["store_equal"], r["store_equal"], True)
    for name in ("detect_patch", "detect_patch_store", "detect_serving",
                 "detect_serving_store"):
        c = paths.counts[name]
        check(c["forwards"] > 0, f"{name}: no forwards")
        _launch_law(f"{name} ({c['forwards']} forwards)", c,
                    {"gather_db": c["forwards"],
                     "relu_pool_skip": c["forwards"]})

    val = torch_school_ap_trained.ensure_big_val_fixture(tmp / "p19")
    sw = torch_school_postproc_sweep.run(sd, val, work / "preds_bigval",
                                         "cuda", paths=paths,
                                         log=lambda m: None)
    print(f"sweep: {len(sw['rows'])} points from the stores of "
          f"{sw['n_echograms']} echograms in {sw['sweep_s']:.1f} s "
          f"({sw['sweep_s_per_point']:.3f} s a point, host); predict pass "
          f"{sw['predict_s']:.2f} s [{card}]")
    print(f"sweep baseline: {sw['baseline']}")
    print(f"sweep chosen:   {sw['chosen']}")
    _bound("sweep ground truth", sw["n_gt"],
           sw["n_gt"] == torch_school_ap_trained.BIG_VAL_GT,
           torch_school_ap_trained.BIG_VAL_GT)
    for key in ("baseline", "chosen"):
        _bound(f"sweep {key} row == a live school_eval_survey at its "
               f"settings", sw["live"][key], sw["live"][key] == sw[key],
               sw[key])
    for name in ("sweep_predict", "sweep_live"):
        c = paths.counts[name]
        check(c["forwards"] > 0, f"{name}: no forwards")
        _launch_law(f"{name} ({c['forwards']} forwards)", c,
                    {"gather_db": c["forwards"],
                     "relu_pool_skip": c["forwards"]})
    rates["sweep ms a point (host)"] = sw["sweep_s_per_point"] * 1e3

    pm = torch_pooled_meta_bench.run("cuda", paths=paths, log=lambda m: None)
    print(f"pooled metadata training (batch {pm['batch']}): host "
          f"{pm['host_ms']:.2f}, pooled {pm['pooled_ms']:.2f}, staged "
          f"{pm['staged_ms']:.2f} ms a step, speedup_pooled_vs_host "
          f"{pm['speedup_pooled_vs_host']:.2f}; first losses "
          f"{pm['first_loss']} [{card}]")
    for arm in ("host", "pooled", "staged"):
        _bound(f"pooled metadata {arm}: every loss finite",
               pm[f"{arm}_losses_finite"], pm[f"{arm}_losses_finite"], True)
        _launch_law(f"pooled metadata {arm}", paths.counts[f"meta_{arm}"],
                    {"binary_closing": pm["warmup"] + pm["steps"]})
        rates[f"metadata ms a step, {arm}"] = pm[f"{arm}_ms"]

    sg = torch_static_grid.run("cuda", work)
    for arm in ("static", "dynamic"):
        r = sg[arm]
        print(f"static grid {arm} arm (fresh process): cold "
              f"{r['cold_wall_s']:.3f} s = {r['pings_per_sec_cold']:.1f} "
              f"pings/s, {r['n_chunks']} chunks, grids "
              f"{r['distinct_predict_sigs']}, {len(r['distinct_mask_sigs'])} "
              f"mask signatures, {r['conv_shapes']} conv shapes, "
              f"sub-batches {r['sub_batches']}, launches "
              f"{r['launches']} [{card}]")
        rates[f"static grid {arm} cold"] = r["pings_per_sec_cold"]
        paths.counts[f"static_grid_{arm}"] = dict(r["launches"],
                                                  forwards=r["forwards"])
        _launch_law(f"static grid {arm} ({r['forwards']} forwards)",
                    r["launches"], {"gather_db": r["forwards"],
                                    "relu_pool_skip": r["forwards"]})
    n_static = len(sg["static"]["distinct_predict_sigs"])
    n_dyn = len(sg["dynamic"]["distinct_predict_sigs"])
    _bound("static grid: (R, C) signatures static, dynamic",
           (n_static, n_dyn), n_static == 1 and n_dyn > 1, "(1, > 1)")
    _bound("static grid: write masks identical",
           sg["write_masks_identical"], sg["write_masks_identical"], True)
    _bound("static grid: max |dprob| between the arms",
           sg["max_abs_prob_diff"],
           sg["max_abs_prob_diff"] <= STATIC_MAX_DPROB, STATIC_MAX_DPROB)

    _hold_sub_batches(torch, card, reader, cfg, {
        b for arm in ("static", "dynamic") for b in sg[arm]["sub_batches"]})

    diff = torch_fast_recipe.preset_differences(train_fixture(tmp))
    _bound("fast_config b16_sqrt differs from config_fast_train.yaml at",
           diff, not diff, {})
    out = work / "recipes.json"
    arms = {}
    for arm in torch_fast_recipe.ARMS:
        arms[f"fast_{arm}"] = torch_fast_recipe.run_arm(
            tmp, out, arm, paths, cut=RECIPE_CUT, device="cuda")
    for late in (False, True):
        arms["meta_late" if late else "meta_early"] = torch_meta_recipe.run(
            tmp, out, late, paths, cut=RECIPE_CUT, device="cuda")
    for dtype in ("float32", "bfloat16"):
        arms[f"ab_{dtype}"] = torch_r3_session.stage_ab(
            tmp, out, dtype, paths, device="cuda", **RECIPE_CUT)
    for name, r in arms.items():
        print(f"recipe arm {name} (cut: {RECIPE_CUT}): best F1 "
              f"{r['best_F1']:.4f}, wall {r['wall_min'] * 60:.1f} s, "
              f"{r['steps']} steps + {r['val_steps']} validation steps, "
              f"launches {r['launches']} [{card}]")
        _recipe_checks(name, r)
        shutil.rmtree(Path(r["ckpt"]).parent, ignore_errors=True)

    print("phase 21 launches: " + ", ".join(
        f"{k} {v}" for k, v in paths.counts.items()))
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {f"p21_{k}": {n: v for n, v in c.items() if n != "forwards"}
            for k, c in paths.counts.items()}, rates


# -------------------------------------------------------------- phase 22
# The JAX repo's last probes (scripts/torch_pool_probe.py, torch_pool_v2.py,
# torch_l0_probe.py, torch_dldw_probe.py, torch_int8_probe.py,
# torch_h2d_probe.py) at full width, P1-P3 (csrc/pool_probe.cu) among them.
# Each bound was written before the first card run of phase 22 (PERF.md
# §6); the probes' own checks (bit-equal pools, convs within 0.05, dW within
# REL_TOL, int8 exact) raise inside the tools and are read back here.
POOL_ONOFF_DLOGIT = 1e-2      # ON (K3) vs OFF (F.max_pool2d) logits: max |d|
                              # <= this x max |logit| (the pool is exact; a
                              # conv on another layout may round otherwise)
PROBE_SHAPES = (32, 8)        # P1-P3 held at (B, 256, 256, 64) for these B


def _probe_kernel_rows(pp, held):
    """The kernels-line entries of P1-P3 (``ops/pool_probe.py``
    ``VARIANTS``) from the pool probe's run ``pp`` and the bit-equality
    runs ``held`` ({B: checks})."""
    from crimac_unet_tpu_torch.ops.pool_probe import VARIANTS
    rows = {r["name"]: r for r in pp["rows"]}
    out = {}
    for name, (_, _, replaces) in VARIANTS.items():
        out[name] = dict(
            name=name, route="cuda",
            source="crimac_unet_tpu_torch/csrc/pool_probe.cu",
            replaces=replaces, launches=pp["timed_launches"][name],
            max_abs_err=max(h[name]["max_abs_err"] for h in held.values()),
            ms=rows[name]["ms"], plain_ms=rows[f"{name} plain"]["ms"],
            bound_ms=pp["bound_ms"], bound_by="bytes",
            library_ms=rows["F.max_pool2d"]["ms"],
            k2_ms=rows["K2 maxpool2x2"]["ms"],
            shape=[pp["batch"], pp["size"], pp["size"], pp["chan"]])
    return out


def phase_probes(torch, cuda_lib, card):
    """The probes (phase 22): each tool's ``run()`` at full width, its
    table printed, then every check beside its bound.  Returns (launches
    by path, rates, the P1-P3 entries of the kernels line)."""
    sys.path.insert(0, str(ROOT))
    from scripts import (torch_dldw_probe, torch_h2d_probe, torch_int8_probe,
                         torch_l0_probe, torch_pool_probe, torch_pool_v2,
                         torch_timing_common as tc)
    t_phase = time.perf_counter()
    by_path, rates = {}, {}

    def counted(name, fn):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        by_path[f"p22_{name}"] = dict(cuda_lib.launches)
        return out

    print(f"phase 22: the probes [{card}]")
    pp = counted("pool_probe", lambda: torch_pool_probe.run("cuda"))
    held = {pp["batch"]: pp["checks"]}
    for b in PROBE_SHAPES:
        if b not in held:
            x = torch.randn((b, 256, 256, 64), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(
                                SEED + b)).mul_(.1).to(torch.bfloat16)
            held[b] = counted(f"pool_probe_b{b}", lambda x=x:
                              torch_pool_probe.probe_kernels_equal(x))
    pv = counted("pool_v2", lambda: torch_pool_v2.run("cuda"))
    l0 = counted("l0_probe", lambda: torch_l0_probe.run("cuda"))
    dw = counted("dldw_probe", lambda: torch_dldw_probe.run("cuda"))
    i8 = counted("int8_probe", lambda: torch_int8_probe.run("cuda"))
    h2d = counted("h2d_probe", lambda: torch_h2d_probe.run("cuda"))

    print(f"phase 22 checks [{card}]:")
    for b, checks in sorted(held.items()):
        for name, r in checks.items():
            _bound(f"{name} at ({b}, 256, 256, 64) vs F.max_pool2d and its "
                   f"plain version, NaN and +-Inf seeded (max |d|)",
                   r["max_abs_err"], r["equal"], "bit-equal")
    st = pv["standalone"]
    _bound("pool v2 stage 1: K2 vs F.max_pool2d", st["k2_equal"],
           st["k2_equal"], True)
    fw = pv["forward"]
    lim = POOL_ONOFF_DLOGIT * fw["max_abs_logit"]
    _bound("pool v2 stage 2: logits max |d| ON vs OFF", fw["max_abs_dlogit"],
           fw["logits_finite"] and fw["max_abs_dlogit"] <= lim,
           f"{POOL_ONOFF_DLOGIT} x max |logit| = {lim:.4g}")
    _bound("pool v2 stage 2: K3 a forward ON, OFF",
           (fw["on"]["k3_launches"], fw["off"]["k3_launches"]),
           (fw["on"]["k3_launches"], fw["off"]["k3_launches"]) == (1, 0),
           (1, 0))
    for b in l0["batches"]:
        for name, r in b["checks"].items():
            _bound(f"level-0 batch {b['batch']}: {name} vs production "
                   f"(max |d|)", r["max_abs_err"], r["ok"], r["tol"])
    for r in dw["rows"]:
        _bound(f"dL/dW {r['layer']}: taps vs default rel |d|",
               f"{r['rel']:.3e}", r["rel_ok"], dw["rel_tol"])
    for r in i8["rows"]:
        _bound(f"int8 ({r['batch']}, {r['H']}, {r['W']}, {r['cin']} -> "
               f"{r['cout']}): im2col + _int_mm vs the int64 reference",
               r["int8_exact"], r["int8_exact"], True)
    keys = h2d["chunk"]["default"]["keys"]
    _bound("h2d chunk set keys", sorted(keys),
           sorted(keys) == ["data_slab", "lab_bits", "sb_row"],
           ["data_slab", "lab_bits", "sb_row"])

    probes = _probe_kernel_rows(pp, held)
    for name, c in by_path.items():
        if name.startswith("p22_pool_probe"):
            _quiet_launches(c, tuple(probes) + (
                ("maxpool2x2",) if name == "p22_pool_probe" else ()), name)
        elif name == "p22_pool_v2":
            _quiet_launches(c, ("maxpool2x2", "relu_pool_skip"), name)
        elif name == "p22_l0_probe":
            _quiet_launches(c, ("maxpool2x2", "relu_pool_skip"), name)
        else:
            _quiet_launches(c, (), name)
    for name, r in probes.items():
        check(r["launches"] > 0, f"{name} was not launched by phase 22's "
                                 f"timing run: {pp['timed_launches']}")
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    print("phase 22 launches: " + ", ".join(
        f"{k} {v}" for k, v in by_path.items()))
    rates["forward ms a call of 32, pool kernel ON"] = fw["on"]["ms"]
    rates["forward ms a call of 32, pool kernel OFF"] = fw["off"]["ms"]
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s [{card}]")
    check(tc.HBM_BYTES_PER_S == HBM_BYTES_PER_S,
          f"the tools' HBM rate {tc.HBM_BYTES_PER_S} != {HBM_BYTES_PER_S}")
    return by_path, rates, probes


# -------------------------------------------------------------- phase 23
# The production image (Dockerfile.torch) without docker: its file set
# (the port alone), its build steps, its command.
IMAGE_TIMEOUT_S = 900         # the build step and the docker entry, each


def dockerfile_steps(path=None) -> list:
    """The ``RUN python -c "..."`` steps of ``Dockerfile.torch`` (line
    continuations joined), each as its Python source, in file order."""
    import shlex
    text = Path(path or ROOT / "Dockerfile.torch").read_text()
    steps = []
    for line in text.replace("\\\n", " ").splitlines():
        if not line.startswith("RUN "):
            continue
        argv = shlex.split(line[4:])
        if argv[:2] == ["python", "-c"] and len(argv) == 3:
            steps.append(argv[2])
    return steps


def _image_env(app, **extra):
    """The environment of a process of the image's file set: this one's,
    with ``app`` alone on ``PYTHONPATH`` and the docker entry's variables
    unset but for ``extra``."""
    import os
    env = {k: v for k, v in os.environ.items() if k not in (
        "PYTHONPATH", "MODEL", "SURVEY", "CONFIG", "ZARRFILE",
        "MODELWEIGHTS", "SURVEY_PATH", "CONFIG_PATH", "OUTPUT_DIR",
        "PRED_FILE")}
    env.update(PYTHONPATH=str(app), **extra)
    return env


def _kernel_build_files(app):
    d = app / ".kernel_build"
    return {p.name: p.stat().st_mtime_ns for p in sorted(d.iterdir())} \
        if d.is_dir() else {}


def phase_image(tmp, sv, card, docker_counts):
    """Phase 23: ``crimac_unet_tpu_torch/`` copied alone into an
    ``/app``-like directory, ``Dockerfile.torch``'s kernel build step run
    there, then its command, ``python -m
    crimac_unet_tpu_torch.pipeline.dockerscript``, as a subprocess over
    phase 6's survey and weights through the MODELWEIGHTS / SURVEY_PATH /
    CONFIG_PATH / OUTPUT_DIR / PRED_FILE contract: it exits 0, loads the
    prebuilt library (no build, the build directory unchanged), writes a
    store bit-equal to phase 6's docker store and launches K1 and K3 as
    phase 6's docker run did."""
    import ctypes.util
    import re
    from crimac_unet_tpu_torch.data.zarrlite import ZGroup
    t_phase = time.perf_counter()
    app = tmp / "app"
    shutil.copytree(ROOT / "crimac_unet_tpu_torch",
                    app / "crimac_unet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    check(sorted(p.name for p in app.iterdir()) == ["crimac_unet_tpu_torch"],
          f"image file set {sorted(app.iterdir())}")
    steps = dockerfile_steps()
    kernel_steps = [c for c in steps if "cuda_lib.build()" in c]
    codec_steps = [c for c in steps if "blosc_codec" in c]
    check(len(kernel_steps) == 1 and len(codec_steps) == 1,
          f"Dockerfile.torch build steps {steps}")
    # the codec step needs libblosc, which the image installs; a host
    # without it runs the pure codec, as phase 6 does
    run_steps = kernel_steps + (codec_steps if ctypes.util.find_library(
        "blosc") else [])
    for code in run_steps:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=app,
                              env=_image_env(app), capture_output=True,
                              text=True, timeout=IMAGE_TIMEOUT_S)
        check(proc.returncode == 0,
              f"image build step exited {proc.returncode}: {code}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        print(f"image build step ({time.perf_counter() - t:.1f} s): {code} "
              f"-> {proc.stdout.strip()}")
    if len(run_steps) == 1:
        print("image codec step not run: this host has no libblosc (the "
              "image installs libblosc1); the entry runs the pure codec")
    built = _kernel_build_files(app)
    libs = [n for n in built if n.startswith("libcrimac_kernels-")]
    check(len(libs) == 1, f"kernel build left {sorted(built)}")

    config = tmp / "image_config.yaml"
    config.write_text("# the flagship defaults, on the card\ndevice: cuda\n")
    out_dir = tmp / "image_out"
    env = _image_env(app, MODELWEIGHTS=str(tmp / "zarr_model.pt"),
                     SURVEY_PATH=str(sv), CONFIG_PATH=str(config),
                     OUTPUT_DIR=str(out_dir), PRED_FILE="pred.zarr")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "crimac_unet_tpu_torch.pipeline.dockerscript"],
        cwd=app, env=env, capture_output=True, text=True,
        timeout=IMAGE_TIMEOUT_S)
    wall = time.perf_counter() - t
    check(proc.returncode == 0,
          f"image entry exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-6000:]}")
    launches = re.search(r"^Kernel launches: (\{.*\})$", proc.stdout, re.M)
    fwd = re.search(r"^U-Net forwards: (\d+); kernel library (\S+), built "
                    r"by this process: (yes|no)$", proc.stdout, re.M)
    check(launches is not None and fwd is not None,
          f"image entry printed no launch lines:\n{proc.stdout[-3000:]}")
    counts, n_fwd = json.loads(launches.group(1)), int(fwd.group(1))
    check(fwd.group(3) == "no" and Path(fwd.group(2)).name == libs[0]
          and _kernel_build_files(app) == built,
          f"image entry rebuilt its kernels: {fwd.group(0)}; build "
          f"directory {built} -> {_kernel_build_files(app)}")
    check(n_fwd > 0 and counts["gather_db"] == counts["relu_pool_skip"]
          == n_fwd and counts == docker_counts,
          f"image entry launches {counts} ({n_fwd} forwards) against phase "
          f"6's docker run {docker_counts}")
    got = ZGroup.open(str(out_dir / "pred.zarr"))
    want = ZGroup.open(str(tmp / "docker_out" / "pred.zarr"))
    for key in ("annotation", "ping_time", "range", "category"):
        a, b = got[key][:], want[key][:]
        check(a.dtype == b.dtype and a.shape == b.shape
              and a.tobytes() == b.tobytes(),
              f"image entry's {key} differs from phase 6's docker store")
    print(f"image entry ({wall:.1f} s, {proc.stdout.count(chr(10))} lines "
          f"of output): exit 0, {n_fwd} forwards, launches {counts} = phase "
          f"6's docker run, kernel library {libs[0]} prebuilt and not "
          f"rebuilt, store bit-equal to phase 6's docker store "
          f"{tuple(got['annotation'].shape)}; codec line: "
          + next((ln for ln in proc.stdout.splitlines()
                  if ln.startswith("Blosc codec backend")), "none")
          + f" [{card}]")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"image": counts}, {
        "image entry pings/s": got["annotation"].shape[1] / wall}


RECIPES = ("baseline", "fast", "meta-early", "meta-late", "zarr")


def run_recipe(torch, tmp, name, dtype, card):
    """A full recipe through run_training: the reference recipe on the
    memm fixture (``baseline``) or its zarr form (``zarr``), the fast
    preset (crimac_unet_tpu_torch/configs/config_fast_train.yaml: 3750 x 16,
    lr 0.01, lr_step 250), or the fast preset with the six metadata families
    early or late injected (scripts/meta_recipe.py: ``meta-early``,
    ``meta-late``)."""
    from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
    from crimac_unet_tpu_torch.pipeline.train import run_training
    sys.path.insert(0, str(ROOT))
    from scripts import torch_fast_recipe, torch_meta_recipe
    if name == "zarr":
        root = zarr_train_fixture(tmp)
        cfg = recipe_config(root, train_dtype=dtype, data_mode="zarr",
                            path_to_zarr_files=str(root))
    elif name == "fast":      # the preset's settings have one home
        cfg = torch_fast_recipe.ARMS["b16_sqrt"](train_fixture(tmp),
                                                 train_dtype=dtype)
    elif name.startswith("meta"):
        cfg = torch_meta_recipe.meta_config(train_fixture(tmp),
                                            name == "meta-late",
                                            train_dtype=dtype)
    else:
        cfg = recipe_config(train_fixture(tmp), train_dtype=dtype)
    val_s = []
    restore = _timed_spy(torch, SegPipeUNet, "validate_model_training",
                         val_s)
    log = Scalars()
    try:
        t0 = time.perf_counter()
        sp = run_training(cfg, tmp / f"recipe_{name}_{dtype}", logger=log,
                          progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    check(sp.pool is not None, f"recipe {name}: the device pool is off")
    train_s = wall - sum(val_s)
    n = sp.state.step
    print(f"recipe {name} ({dtype}): best F1 {sp.best_F1_val:.4f}, "
          f"validation F1 {log.values('test/F1_score')}, validation loss "
          f"{[round(v, 4) for v in log.values('test/loss')]}, wall "
          f"{wall / 60:.2f} min, {n} steps x batch {cfg['batch_size']}, "
          f"{train_s / n * 1e3:.2f} ms a step outside validation, "
          f"validation {sum(val_s):.1f} s in {len(val_s)} passes, pool "
          f"{type(sp.pool).__name__} [{card}]")
    return sp.best_F1_val, wall


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--parallel-worker"]:      # one rank of phase 16
        parallel_worker(int(argv[1]), int(argv[2]), argv[3])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, range(1, 24))),
                    help="comma-separated subset of phases 1-23 (11 and 18 "
                         "need 4 and 6, 17 needs 4, 19 and 21 need 6 and 12, "
                         "20 and 23 need 6)")
    ap.add_argument("--recipe", choices=RECIPES,
                    help="also train a full recipe (baseline: 15000 x "
                         "batch 4; fast: 3750 x 16; meta-early / meta-late: "
                         "the fast preset with the six metadata families; "
                         "zarr: the baseline on the zarr fixture) and print "
                         "the best F1 and wall")
    ap.add_argument("--recipe-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="train_dtype of --recipe")
    ap.add_argument("--soak-pings", type=int, default=SOAK_PINGS,
                    help="pings of phase 19's soak survey")
    ap.add_argument("--trained-ckpt", default=None,
                    help="phase 19's and 21's weights in place of phase "
                         "12's best.msgpack (a .msgpack of either package or "
                         "a .pt)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if 11 in phases and not phases >= {4, 6}:
        ap.error("phase 11 reads the stores of phases 4 and 6")
    if 17 in phases and 4 not in phases:
        ap.error("phase 17 holds the onboarded survey to phase 4's store")
    if 18 in phases and not phases >= {4, 6}:
        ap.error("phase 18 runs phase 4's echogram and holds its store to "
                 "phase 6's")
    if 19 in phases and (6 not in phases
                         or 12 not in phases and not args.trained_ckpt):
        ap.error("phase 19 runs phase 6's survey with phase 12's trained "
                 "best.msgpack (or --trained-ckpt)")
    if 21 in phases and (6 not in phases
                         or 12 not in phases and not args.trained_ckpt):
        ap.error("phase 21 runs phase 6's survey with phase 12's trained "
                 "best.msgpack (or --trained-ckpt)")
    if 20 in phases and 6 not in phases:
        ap.error("phase 20 measures phase 6's survey")
    if 23 in phases and 6 not in phases:
        ap.error("phase 23 holds the image's entry to phase 6's docker run")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from crimac_unet_tpu_torch.ops import cuda_lib

    card = phase_card(torch, cuda_lib)
    kernels, launches, by_path, rates = {}, {}, {}, {}
    probe_rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ech_dir, reader, cfg = main_setup(torch, tmp)
        if 2 in phases:
            kernels = phase_kernels(torch, cuda_lib, card, reader, cfg)
            phase_pool_gathers(torch, tmp, card)
        if 3 in phases:
            phase_agreement(torch, tmp)
        if 4 in phases:
            launches, rates["memm prediction"], paths, memm_store = \
                phase_main(torch, cuda_lib, ech_dir, reader, cfg, card)
            by_path.update(paths)
        if 5 in phases:
            by_path["memm_eval"], rates["memm evaluation"] = phase_eval(
                torch, cuda_lib, ech_dir, reader, cfg, card)
            launches["binary_closing"] = \
                by_path["memm_eval"]["binary_closing"]
        if phases & {6, 7, 8, 11, 15, 16, 18, 19, 20, 21, 23}:
            sv, zreader = zarr_setup(torch, tmp)
        zarr_pred = None
        if 6 in phases:
            (by_path["zarr_predict"], by_path["zarr_docker"],
             rates["zarr prediction"], zarr_pred, zarr_store) = \
                phase_zarr_main(torch, cuda_lib, tmp, sv, zreader, cfg, card)
        if 7 in phases:
            by_path["zarr_eval"], rates["zarr evaluation"] = \
                phase_zarr_eval(torch, cuda_lib, zreader, cfg, card)
        if 8 in phases:
            by_path["zarr_serving"], rates["serving preset"] = \
                phase_serving(torch, cuda_lib, tmp, zreader, zarr_pred, card)
        if 9 in phases:
            by_path["memm_static_grid"] = phase_static_grid(
                torch, cuda_lib, tmp, cfg, card)
        if 10 in phases:
            paths, r = phase_meta(torch, cuda_lib, ech_dir, reader, cfg,
                                  card)
            by_path.update(paths)
            rates.update(r)
        if 11 in phases:
            paths, r = phase_school(torch, cuda_lib, tmp, cfg, [
                ("memm", cfg, [reader], memm_store),
                ("zarr", dict(cfg, data_mode="zarr"), [zreader],
                 zarr_store)], card)
            by_path.update(paths)
            rates.update(r)
        if 12 in phases:
            by_path["tr"], r = phase_train(torch, cuda_lib, tmp, card,
                                           TRAIN_ITERATIONS)
            rates.update(r)
        if 13 in phases:
            by_path["tz"], r = phase_zarr_train(torch, cuda_lib, tmp, card,
                                                TRAIN_ITERATIONS_13_14)
            rates.update(r)
        if 14 in phases:
            paths, r = phase_meta_train(torch, cuda_lib, tmp, card,
                                        TRAIN_ITERATIONS_13_14)
            by_path.update(paths)
            rates.update(r)
        if 15 in phases:
            paths, r = phase_export(torch, cuda_lib, tmp, ech_dir, reader,
                                    zreader, cfg, card)
            by_path.update(paths)
            rates.update(r)
        if 16 in phases:
            paths, r = phase_parallel(torch, cuda_lib, tmp, card)
            by_path.update(paths)
            rates.update(r)
        if 17 in phases:
            paths, r = phase_onboarding(torch, cuda_lib, tmp, reader, cfg,
                                        card, by_path, memm_store)
            by_path.update(paths)
            rates.update(r)
        if 18 in phases:
            paths, r = phase_surface(torch, cuda_lib, tmp, card, ech_dir,
                                     reader, cfg, sv, zreader, zarr_pred)
            by_path.update(paths)
            rates.update(r)
        if 19 in phases:
            paths, r = phase_trained(
                torch, tmp, card, sv, args.trained_ckpt
                or tmp / "train_ck_tr" / "best.msgpack", args.soak_pings)
            by_path.update(paths)
            rates.update(r)
        if 20 in phases:
            paths, r = phase_where_time_goes(torch, cuda_lib, tmp, card, sv)
            by_path.update(paths)
            rates.update(r)
        if 21 in phases:
            paths, r = phase_ab(torch, tmp, card, sv, args.trained_ckpt
                                or tmp / "train_ck_tr" / "best.msgpack",
                                reader, cfg)
            by_path.update(paths)
            rates.update(r)
        if 22 in phases:
            paths, r, probe_rows = phase_probes(torch, cuda_lib, card)
            by_path.update(paths)
            rates.update(r)
        if 23 in phases:
            paths, r = phase_image(tmp, sv, card, by_path["zarr_docker"])
            by_path.update(paths)
            rates.update(r)
        if args.recipe:
            run_recipe(torch, tmp, args.recipe, args.recipe_dtype, card)
    rows = []
    if phases >= {2, 4, 5}:
        for name in KERNELS:
            check(launches.get(name, 0) > 0,
                  f"{name} was not launched on the main path")
        rows += [dict(name=name, route="cuda", **KERNELS[name],
                      launches=launches[name], **kernels[name],
                      launches_by_path={p: c.get(name, 0)
                                        for p, c in by_path.items()})
                 for name in KERNELS]
    rows += list(probe_rows.values())
    if rows:
        print(json.dumps({"kernels": rows}))
        print("main paths: " + ", ".join(
            f"{k} {v:.1f}" + ("" if "/s" in k or " ms " in k else " pings/s")
            for k, v in rates.items()) + f" [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
