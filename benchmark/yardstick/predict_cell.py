"""Survey prediction cells: ``save_survey_predictions_zarr`` over a zarr
survey (``predict_zarr``) and the ``predict_reader`` generator over a
memmap echogram (``predict_memm``), whole survey passes back to back.

A pass of the zarr cell writes a store of its own (the serving preset
resumes a store it finds, and would skip the pass).  A pass of the memmap
cell consumes the yielded float16 predictions on the host and writes
nothing; one chunk of each pass, drawn from the seed before the window,
is kept for the check.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time

import numpy as np
import torch

from ..reference import predict as ref_predict
from ..reference import surveys as ref_surveys
from . import counts, generators
from .zarr_plain import PlainArray


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_inputs(spec, folder, seed):
    """The cell's survey under ``folder``; returns its path."""
    if spec["format"] == "zarr":
        return generators.make_zarr_survey(
            folder, spec["year"], spec["n_range"], spec["n_pings"], seed,
            n_schools=spec["n_schools"])
    return generators.make_survey_dir(
        folder, spec["year"], 1, spec["n_range"], spec["n_pings"], seed,
        n_schools=spec["n_schools"])[0]


def reference_survey(spec, path):
    return (ref_surveys.ZarrSurvey(path) if spec["format"] == "zarr"
            else ref_surveys.MemmSurvey(path))


def geometry(cfg, survey, arch):
    """The configuration's grid law over ``survey``."""
    return ref_predict.Geometry(cfg, survey.n_range, survey.n_pings,
                                survey.seabed, survey.known,
                                isinstance(survey, ref_surveys.ZarrSurvey),
                                arch.slab_alignment(cfg))


class PredictCell:
    """Set-up, timed passes and the check of one prediction cell."""

    def __init__(self, cfg, work, input_path, state, device, rng, arch):
        from crimac_unet_tpu_torch.pipeline.runner import GriddedRunner

        self.cfg, self.spec = cfg, work["survey"]
        self.work, self.state, self.arch = work, state, arch
        self.zarr = self.spec["format"] == "zarr"
        self.input_path = input_path
        self.device = device
        self.rng = rng
        self.runner = GriddedRunner(
            arch.program(cfg),
            {k: v.detach().cpu() for k, v in state.items()},
            cfg, device=device)
        if self.zarr:
            from crimac_unet_tpu_torch.data.zarr_reader import DataReaderZarr
            self.reader = DataReaderZarr(input_path)
        else:
            from crimac_unet_tpu_torch.data.memmap_reader import Echogram
            self.reader = Echogram(input_path)
        self.n_pings = self.spec["n_pings"]
        self.out_dir = None
        self.passes = 0
        self.kept = {}          # (pass, chunk) -> (2, n_range, w) float16
        self.kept_passes = []   # zarr: the passes whose stores are kept
        self.errors = 0         # passes or chunks the program got wrong
        self.splits = ref_predict.chunk_splits(self.n_pings,
                                               int(cfg["preload_n_pings"]))

    # ---------------------------------------------------------- one pass
    def run_pass(self, tag):
        """One whole survey pass through the program's entry."""
        from crimac_unet_tpu_torch.pipeline import predict as prog
        cfg = self.cfg
        if self.zarr:
            target = os.path.join(self.out_dir, f"{tag}_pred.zarr")
            prog.save_survey_predictions_zarr(
                self.runner, self.reader, target,
                preload_n_pings=int(cfg["preload_n_pings"]),
                resume_writing=bool(cfg["resume_writing"]),
                save_labels=bool(cfg["save_labels"]))
            return target
        keep_chunk = int(self.rng.integers(len(self.splits)))
        for k, (s, e, out, _) in enumerate(prog.predict_reader(
                self.runner, self.reader,
                int(cfg["preload_n_pings"]))):
            if (s, e) != self.splits[k] or out.shape != (
                    2, self.spec["n_range"], e - s):
                self.errors += 1
            if k == keep_chunk:
                self.kept[(tag, k)] = out
        return None

    def _timed_pass(self, span):
        """A pass of the window.  A zarr pass's store is checked for its
        extent at once and kept only while a seeded reservoir sample of
        ``check_chunks`` passes holds it: a deleted store's pages are
        never written back, so the stores' writeback does not slow the
        later passes, and each pass is as likely to be checked."""
        with span("bench.pass"):
            target = self.run_pass(f"p{self.passes}")
        n, k = self.passes, int(self.work["check_chunks"])
        self.passes += 1
        if target is None:
            return
        self.errors += self._store_errors(target)
        if len(self.kept_passes) < k:
            self.kept_passes.append(n)
            return
        j = int(self.rng.integers(n + 1))
        drop = n
        if j < k:
            drop, self.kept_passes[j] = self.kept_passes[j], n
        shutil.rmtree(os.path.join(self.out_dir, f"p{drop}_pred.zarr"))

    def warm_up(self, out_dir):
        """One pass, which builds the kernels, picks the convolution
        algorithms of the cell's one grid shape and fills the readers'
        seabed caches."""
        self.out_dir = out_dir
        self.run_pass("warmup")
        sync(self.device)
        if self.zarr:
            shutil.rmtree(os.path.join(out_dir, "warmup_pred.zarr"))
        self.kept.clear()
        self.errors = 0
        # the disk settled before the window: nothing a former run or the
        # warm-up left unwritten is written back inside it
        os.sync()

    def window(self, seconds, span):
        """Passes back to back until ``seconds`` have passed; returns
        (pings, wall seconds)."""
        t0 = time.perf_counter()
        while True:
            self._timed_pass(span)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        return self.passes * self.n_pings, time.perf_counter() - t0

    def after_window(self):
        """Nothing to run: the check reads what the window wrote."""

    def traced(self, span):
        """The profiled window: ``trace_passes`` passes."""
        t0 = time.perf_counter()
        for _ in range(int(self.work["trace_passes"])):
            self._timed_pass(span)
        sync(self.device)
        return self.passes * self.n_pings, time.perf_counter() - t0

    def timer_snapshot(self):
        """The program's phase totals and counts (its threads are idle
        between passes)."""
        t = self.runner.timer
        return dict(t.totals), dict(t.counts)

    def timer_delta(self, before):
        (t0, c0), (t1, c1) = before, self.timer_snapshot()
        return {k: (t1[k] - t0.get(k, 0.0), c1[k] - c0.get(k, 0))
                for k in t1}

    def layer_context(self, done):
        """What the per-layer readers need besides the trace: the
        useful FLOPs and kernel bytes of the passes traced."""
        survey = reference_survey(self.spec, self.input_path)
        passes = done // self.n_pings
        by = kernel_bytes_per_pass(self.cfg, survey, self.arch)
        return {"flops": passes * useful_flops_per_pass(self.cfg, survey,
                                                        self.arch),
                "k1_bytes": passes * by["k1"], "k3_bytes": passes * by["k3"]}

    def attempted(self):
        return self.passes * len(self.splits)

    def failed(self):
        return self.errors

    def free(self):
        self.runner = self.reader = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def judge(self, quant=None):
        return judge(self, self.cfg, self.state, self.device, self.arch,
                     quant)

    # ----------------------------------------------------------- check
    def _store_chunk(self, p, k):
        s, e = self.splits[k]
        arr = PlainArray(os.path.join(self.out_dir, f"p{p}_pred.zarr",
                                      "annotation"))
        return arr[:, s:e, :].transpose(0, 2, 1)

    def _store_errors(self, root):
        """1 when a pass's store lacks any ping of the survey, else 0."""
        try:
            with open(os.path.join(root, "annotation", ".zarray")) as f:
                ann = json.load(f)["shape"]
            with open(os.path.join(root, "ping_time", ".zarray")) as f:
                pt = json.load(f)["shape"]
        except (OSError, KeyError, ValueError):
            return 1
        return int(ann != [2, self.n_pings, self.spec["n_range"]]
                   or pt != [self.n_pings])

    def samples(self):
        """The (pass, chunk) pairs the check compares, drawn from the
        seed: ``check_chunks`` of the chunks kept (zarr: a chunk of each
        kept store; memmap: one chunk a pass), so that every chunk the
        window produced is as likely to be compared."""
        if self.zarr:
            return [(p, int(self.rng.integers(len(self.splits))))
                    for p in sorted(self.kept_passes)]
        pool = sorted((int(t[1:]), k) for t, k in self.kept)
        n = min(int(self.work["check_chunks"]), len(pool))
        pick = self.rng.choice(len(pool), size=n, replace=False)
        return [pool[i] for i in sorted(pick)]

    def program_chunk(self, p, k):
        return self._store_chunk(p, k) if self.zarr \
            else self.kept[(f"p{p}", k)]


def compare(prog, ref, keep, output_dtype):
    """Partial sums of the numbers compared, for one chunk."""
    prog = prog.astype(np.float32)
    gap = np.abs(prog - ref)[:, keep]
    # a pixel the mask keeps, whose reference probability is surely not
    # stored as 0, reads 0: the mask dropped it
    floor = 4.0 / 255.0 if output_dtype == "uint8" else 1e-3
    dropped = int(np.sum((prog == 0) & (ref > floor) & keep[None]))
    stray = int(np.sum((prog != 0) & ~keep[None]))
    return {"gap_max": float(gap.max(initial=0.0)),
            "gap_sum": float(gap.sum(dtype=np.float64)),
            "n": int(gap.size), "mask_errors": dropped + stray}


@torch.no_grad()
def judge(cell, cfg, state, device, arch, quant=None):
    """The numbers compared over the cell's sampled chunks: the program's,
    or (``quant``) the control's, the reference put in the program's
    place at a lower precision."""
    survey = reference_survey(cell.spec, cell.input_path)
    g = geometry(cfg, survey, arch)
    forward = functools.partial(arch.forward, cfg)
    tot = {"gap_max": 0.0, "gap_sum": 0.0, "n": 0, "mask_errors": 0}
    for p, k in cell.samples():
        s, e = cell.splits[k]
        ref, keep = ref_predict.chunk_reference(g, survey, s, e, state, cfg,
                                                forward, device=device)
        if quant is None:
            prog = cell.program_chunk(p, k)
        else:
            ctl, _ = ref_predict.chunk_reference(g, survey, s, e, state,
                                                 cfg, forward, quant, device)
            prog = ref_predict.quantize_output(ctl, cfg["output_dtype"])
        part = compare(prog, ref, keep, cfg["output_dtype"])
        tot["gap_max"] = max(tot["gap_max"], part["gap_max"])
        for key in ("gap_sum", "n", "mask_errors"):
            tot[key] += part[key]
    return {"prob_gap_max": tot["gap_max"],
            "prob_gap_mean": tot["gap_sum"] / max(tot["n"], 1),
            "mask_errors": tot["mask_errors"],
            "output_errors": cell.errors if quant is None else 0,
            "pixels_compared": tot["n"]}


def _pass_forwards(cfg, survey, arch):
    """Each chunk of a pass as (its grid's extents, n, h, w): it runs n
    forwards of (h, w) by the configuration's grid law, every patch
    (patch mode) or the grid padded to the architecture's alignment (slab
    mode)."""
    g = geometry(cfg, survey, arch)
    for s, e in g.splits:
        ext = g.chunk(s, e)
        if g.slab:
            p = g.align
            yield ext, 1, -(-ext["Hp"] // p) * p, -(-ext["Wp"] // p) * p
        else:
            yield ext, ext["R"] * ext["C"], g.wh, g.ww


def useful_flops_per_pass(cfg, survey, arch):
    """The forward FLOPs a pass needs by the configuration's grid law."""
    return sum(n * arch.forward_flops(cfg, h, w)
               for _, n, h, w in _pass_forwards(cfg, survey, arch))


def kernel_bytes_per_pass(cfg, survey, arch):
    """Bytes of K1 and K3 over a pass, by the grid law and the shapes
    the configuration fixes; no K3 bytes where the architecture runs no
    K3."""
    C = len(cfg["frequencies"])
    item = {"uint8": 1, "bfloat16": 2, "float32": 4}[cfg["transfer_dtype"]]
    f0 = arch.k3_channels(cfg)
    k1 = k3 = 0
    for ext, n, h, w in _pass_forwards(cfg, survey, arch):
        k1 += counts.k1_bytes(ext["Hs"], ext["Wp"], C, item, n, h, w)
        if f0 is not None:
            k3 += counts.k3_bytes(n, h, w, f0)
    return {"k1": k1, "k3": k3}


def calibration_crops(survey, rng, device, n=4, size=256):
    """``n`` crops of the survey's dB image at seeded places, for the
    architecture's ``calibrate``."""
    import torch
    crops = []
    for _ in range(n):
        y = int(rng.integers(0, max(survey.n_range - size, 0) + 1))
        x = int(rng.integers(0, max(survey.n_pings - size, 0) + 1))
        raw = torch.from_numpy(np.ascontiguousarray(
            survey.sv(x, x + size, y + size)[y:])).to(device)
        crops.append(ref_predict._db(raw).permute(2, 0, 1))
    return torch.stack(crops)


def make_state(gen, survey, rng, cfg, device, arch):
    state = arch.init_state(cfg, gen, device)
    crops = calibration_crops(survey, rng, device,
                              size=int(cfg["patch_size"][0]))
    return arch.calibrate(cfg, state, crops)


def build(cfg, work, input_path, gen, device, rng, arch):
    """The cell, with weights made on ``device`` from ``gen`` by the
    architecture's adapter ``arch``."""
    if cfg.get("infer_mode", "patch") == "slab" and \
            arch.slab_alignment(cfg) is None:
        raise SystemExit(f"bench: {arch.__file__} gives no slab alignment, "
                         "so its architecture has no slab mode, and the "
                         "configuration asks for infer_mode slab")
    survey = reference_survey(work["survey"], input_path)
    state = make_state(gen, survey, rng, cfg, device, arch)
    return PredictCell(cfg, work, input_path, state, device, rng, arch)
