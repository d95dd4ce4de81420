"""Training cells: ``SegPipeUNet.train_step`` fed by ``device_prefetch``
over a ``BatchPrefetcher`` on the pooled training factory, built as
``pipeline/train.py`` ``run_training`` builds them (partition, sampler
battery, ``DeviceSamplePool``), on memmap surveys of the recipe's years.

Set-up builds the one train-step object, drives it through its first
steps by the window's own call and feed, and hands the same object to
the window.  Once the window has closed, the object is put back to its
seeded start (weights, momentum, step count, augmentation generator) and
drives the checked steps by the same call and feed, keeping their crops'
coordinates, their losses, the momentum after step 1 and the weights
after step 3: the check sees the step as the window ran it, after every
warm-up.  The recipe validates every ``log_step`` steps, outside any
window, so the window holds training steps only.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..reference import train as ref_train
from . import counts, generators
from .predict_cell import sync

CHECKED_STEPS = 3
# the batch stream is lazy (a batch is made as the step takes it), so its
# length only has to outlast any window
N_BATCHES = 10 ** 7


def make_inputs(spec, folder, seed):
    """One memmap echogram a survey year; returns the echogram root."""
    root = os.path.join(folder, "memm")
    for i, year in enumerate(spec["train_years"] + spec["validation_years"]):
        train = year in spec["train_years"]
        W = spec["n_pings"] if train else spec["validation_pings"]
        generators.make_survey_dir(
            root, year, 1, spec["n_range"], W, (seed + 7919 * i) % 2 ** 32,
            n_schools=max(3, spec["schools_per_4000"] * W // 4000))
    return root


def _echograms(root, years):
    """The train echograms in the partition's order: sorted names whose
    year (characters 9:13) is one of ``years``."""
    return [os.path.join(root, n) for n in sorted(os.listdir(root))
            if "." not in n and int(n[9:13]) in years]


class TrainCell:
    def __init__(self, cfg, work, input_path, gen, device, rng, arch):
        from crimac_unet_tpu_torch.data.dataset import BatchPrefetcher
        from crimac_unet_tpu_torch.data.partition import make_partition
        from crimac_unet_tpu_torch.parallel.prefetch import device_prefetch
        from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet
        from crimac_unet_tpu_torch.pipeline.train import (make_datasets,
                                                          maybe_build_pool)

        spec = work["survey"]
        self.cfg = cfg = dict(
            cfg, path_to_echograms=input_path,
            train_surveys=list(spec["train_years"]),
            validation_surveys=list(spec["validation_years"]),
            use_device_pool=True)
        self.work, self.device, self.input_path = work, device, input_path
        self.arch = arch
        self.B = int(cfg["batch_size"])
        self.state = arch.init_state(cfg, gen, device)
        self.aug_seed = int(rng.integers(2 ** 62))
        data_obj = make_partition(cfg)
        train_factory, _, readers_train, _ = make_datasets(cfg, data_obj)
        self.pool = maybe_build_pool(cfg, readers_train, device=device)
        self.segpipe = SegPipeUNet(cfg)
        self.segpipe.attach_pool(self.pool)
        self.segpipe.init_model(state_dict={
            k: v.detach().cpu() for k, v in self.state.items()})
        self.segpipe.generator = torch.Generator(
            device=device).manual_seed(self.aug_seed)
        self.batches = BatchPrefetcher(
            lambda seed_offset=0: train_factory(seed_offset).use_pool(
                self.pool), self.B, N_BATCHES,
            num_workers=int(cfg.get("num_workers", 4)))
        self.it = device_prefetch(self.batches, torch.device(device),
                                  depth=int(cfg.get("prefetch_depth", 2)))
        self.coords, self.losses = [], []
        self.steps = 0
        self.window_losses = []

    def _params(self):
        return {k: p.detach().clone()
                for k, p in self.segpipe.model.named_parameters()}

    def warm_up(self, out_dir):
        """``warm_steps`` steps, the checked steps' count among them."""
        for _ in range(max(int(self.work["warm_steps"]), CHECKED_STEPS)):
            self.segpipe.train_step(next(self.it))
        sync(self.device)

    def after_window(self):
        """The checked steps: the object put back to its seeded start,
        then driven by the window's own call and feed."""
        ts, opt = self.segpipe.state, self.segpipe.state.optimizer
        ts.model.load_state_dict(self.state)
        opt.state.clear()
        ts.step = 0
        self.segpipe.generator.manual_seed(self.aug_seed)
        for k in range(CHECKED_STEPS):
            batch = next(self.it)
            self.coords.append((batch["ech_idx"].cpu().numpy(),
                                batch["starts"].cpu().numpy()))
            self.losses.append(float(self.segpipe.train_step(batch)))
            if k == 0:
                self.grad1 = {
                    name: opt.state[p]["momentum_buffer"].detach().clone()
                    if "momentum_buffer" in opt.state.get(p, {})
                    else torch.zeros_like(p)
                    for name, p in ts.model.named_parameters()}
        self.params3 = self._params()

    def _steps(self, span, until=None, count=None):
        t0 = time.perf_counter()
        n = 0
        while True:
            with span("bench.next_batch"):
                batch = next(self.it)
            with span("bench.train_step"):
                self.window_losses.append(self.segpipe.train_step(batch))
            n += 1
            if count is not None and n >= count:
                break
            if until is not None and time.perf_counter() - t0 >= until:
                break
        sync(self.device)
        self.steps += n
        return n * self.B, time.perf_counter() - t0

    def window(self, seconds, span):
        return self._steps(span, until=seconds)

    def traced(self, span):
        return self._steps(span, count=int(self.work["trace_steps"]))

    def timer_snapshot(self):
        return None

    def timer_delta(self, before):
        return {}

    def layer_context(self, done):
        steps = done // self.B
        return {"flops": self.arch.train_step_flops(
                    self.cfg, self.B, *self.cfg["patch_size"]) * steps,
                "k4_bytes": steps * counts.k4_bytes(
                    self.B, *self.cfg["patch_size"])}

    def attempted(self):
        return self.steps

    def failed(self):
        """Steps of the window whose loss is not finite."""
        return self.nonfinite

    def free(self):
        self.nonfinite = int((~torch.isfinite(torch.stack(
            self.window_losses))).sum()) if self.window_losses else 0
        self.batches.close()
        self.it = None
        self.segpipe = self.pool = None
        self.window_losses = []
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_batches(self):
        """The checked steps' crops, worked out from the raw echograms at
        the coordinates the program drew."""
        wh, ww = self.cfg["patch_size"]
        spec = self.work["survey"]
        dirs = _echograms(self.input_path, spec["train_years"])
        cache = {}
        out = []
        for idx, starts in self.coords:
            data, labels = [], []
            for e, (y0, x0) in zip(idx, starts):
                if e not in cache:
                    from ..reference.surveys import MemmSurvey
                    s = MemmSurvey(dirs[e])
                    cache[e] = (np.moveaxis(s.sv(0, s.n_pings, s.n_range),
                                            -1, 0),
                                np.asarray(s._labels))
                d, lab = ref_train.crop(*cache[e], int(y0), int(x0), wh, ww)
                data.append(d)
                labels.append(lab)
            out.append((torch.from_numpy(np.stack(data)).to(self.device),
                        torch.from_numpy(np.stack(labels)).to(self.device)))
        return out

    def judge(self, quant=None):
        """Loss, first gradient and update, each by its worst gap against
        the reference; ``quant``: the control's instead of the
        program's.  The workload's limits name those compared: the first
        gradient's gap is a reading only, as neither the control nor a
        fault reads it far enough above the program to hold a limit."""
        batches = self.reference_batches()
        forward = functools.partial(self.arch.forward, self.cfg)

        def follow(q):
            gen = torch.Generator(device=self.device).manual_seed(
                self.aug_seed)
            return ref_train.run_steps(self.state, batches, gen, self.cfg,
                                       forward, q)

        losses, grad1, params = follow(None)
        if quant is None:
            p_losses, p_grad1, p_params = self.losses, self.grad1, \
                self.params3
        else:
            p_losses, p_grad1, p_params = follow(quant)
        norms = {k: float(torch.linalg.vector_norm(g))
                 for k, g in grad1.items()}
        med = float(np.median(list(norms.values())))
        # leaves whose reference gradient is nought to rounding (a conv
        # bias under BatchNorm) move by round-off alone: left out by rule
        skip = {k for k, n in norms.items() if n < 1e-3 * med}
        init = {k: self.state[k] for k in params}
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(p_losses, losses)),
            "grad_gap": ref_train.leaf_gaps(p_grad1, grad1, skip),
            "update_gap": ref_train.leaf_gaps(
                {k: p_params[k] - init[k] for k in params},
                {k: params[k] - init[k] for k in params}, skip),
        }


def build(cfg, work, input_path, gen, device, rng, arch):
    return TrainCell(cfg, work, input_path, gen, device, rng, arch)
