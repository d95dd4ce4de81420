"""Pooled against host-crop metadata training: the port's counterpart of
``scripts/pooled_meta_bench.py``.

Flagship shapes (patch 256, depth 5, start_filts 64, bf16 compute,
batch 8) with all six metadata families (10 input channels) on a 2 x 600
x 1500 memmap survey (seed 11).  Three arms, each a serial feed + step
loop of 3 warm-up and 10 timed steps ending in
``torch.cuda.synchronize()``:

  host    ``crop_data`` + ``crop_labels`` + ``crop_meta`` on the host per
          batch, their h2d, then the crop step (``make_train_step``);
  pooled  the host draws (echogram, center) coordinates only
          (``DeviceSamplePool.prepare_batch``); the crops and the metadata
          maps are gathered and computed on the card inside the pooled
          step (``make_train_step_pooled`` with ``pool.meta_vectors`` /
          ``pool.meta_flags``);
  staged  one batch made resident once and stepped on (compute alone).

Each arm starts from the same seeded weights (``init_train_state``), its
own augmentation generator seeded alike, and the same coordinate draws
(``RandomState(3)``), so the host and pooled arms take their first step
on the same crops.

    python scripts/torch_pooled_meta_bench.py [--device cuda]

Prints one JSON line with the JAX script's keys (ms a step per arm and
``speedup_pooled_vs_host``) and the port's (first losses, launches).
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from crimac_unet_tpu_torch.config import \
    META_CHANNELS_ALL as ALL_META  # noqa: E402
from scripts import torch_check_common as common  # noqa: E402

PATCH = 256
BATCH = 8
STEPS = 10
WARMUP = 3


def bench_config(model=None, batch=BATCH) -> dict:
    """The JAX script's step settings; ``model`` overrides (smaller
    models in the tests)."""
    cfg = {"patch_size": [PATCH, PATCH], "frequencies": common.FREQS,
           "lr": 0.005, "lr_step": 1000, "lr_reduction": 0.5,
           "momentum": 0.95, "depth": 5, "start_filts": 64,
           "compute_dtype": "bfloat16", "batch_size": batch,
           "meta_channels": ALL_META, **(model or {})}
    cfg["train_dtype"] = cfg["compute_dtype"]
    return cfg


def run(device="cuda", model=None, batch=BATCH, steps=STEPS, warmup=WARMUP,
        H=600, W=1500, paths=None, log=print) -> dict:
    """The three arms on a fresh (2, H, W) survey; ``paths`` gets each
    arm's launches (``meta_<arm>``)."""
    from crimac_unet_tpu_torch.data.device_pool import DeviceSamplePool
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir
    from crimac_unet_tpu_torch.data.memmap_reader import get_echograms
    from crimac_unet_tpu_torch.data.meta_channels import crop_meta
    from crimac_unet_tpu_torch.pipeline import engine
    from scripts.torch_roofline_bwd import train_model
    dev = common.device_of(device)
    cfg = bench_config(model, batch)
    window = list(cfg["patch_size"])
    freqs = cfg["frequencies"]
    paths = paths if paths is not None else common.Paths()
    host_step = engine.make_train_step(cfg)
    pool_step = engine.make_train_step_pooled(cfg)
    out, first = {}, {}

    with tempfile.TemporaryDirectory() as td:
        make_survey_dir(td, year=2017, n_echograms=2, H=H, W=W, seed=11)
        readers = get_echograms(years=[2017], path_to_echograms=td,
                                minimum_shape=window[0])
        pool = DeviceSamplePool(readers, freqs, window,
                                meta_channels=ALL_META, device=dev)

        def drawer():
            rng = np.random.RandomState(3)
            return lambda: [(readers[rng.randint(len(readers))],
                             [rng.randint(0, H), rng.randint(0, W)])
                            for _ in range(batch)]

        def host_batch(draw):
            s = draw()
            data = np.stack([r.crop_data(list(c), window, freqs)
                             for r, c in s])
            labels = np.stack([r.crop_labels(list(c), window)
                               for r, c in s]).astype(np.int32)
            meta = np.stack([crop_meta(r, list(c), window, ALL_META)
                             for r, c in s])
            return tuple(torch.from_numpy(a).to(dev)
                         for a in (data, labels, meta))

        def pool_batch(draw):
            idxs, starts = pool.prepare_batch(draw())
            return torch.from_numpy(idxs).to(dev), \
                torch.from_numpy(starts).to(dev)

        def arm(name, step):
            """``step(state, gen, draw)`` -> loss; warm-up, then the timed
            steps, from fresh weights and fresh draws."""
            state = train_model(cfg, dev, seed=0)
            gen = torch.Generator(device=dev).manual_seed(1)
            draw = drawer()
            losses = []
            with paths.path(f"meta_{name}", device=dev):
                for i in range(warmup):
                    losses.append(step(state, gen, draw))
                    if i == 0:
                        first[name] = float(losses[0])
                common.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(steps):
                    losses.append(step(state, gen, draw))
                common.synchronize(dev)
                out[f"{name}_ms"] = (time.perf_counter() - t0) / steps * 1e3
            out[f"{name}_losses_finite"] = bool(torch.isfinite(
                torch.stack(losses)).all())
            log(f"# {name}: {out[f'{name}_ms']:.2f} ms a step, first loss "
                f"{first[name]:.6f}")

        def host(state, gen, draw):
            d, lab, meta = host_batch(draw)
            return host_step(state, d, lab, gen, meta=meta)

        def pooled(state, gen, draw):
            i_, s_ = pool_batch(draw)
            return pool_step(state, pool.data, pool.labels, i_, s_, gen,
                             meta_vectors=pool.meta_vectors,
                             flags=pool.meta_flags)

        resident = []

        def staged(state, gen, draw):
            if not resident:        # made once, in the first warm-up step
                resident.append(host_batch(draw))
            d, lab, meta = resident[0]
            return host_step(state, d, lab, gen, meta=meta)

        arm("host", host)
        arm("pooled", pooled)
        arm("staged", staged)

    out["speedup_pooled_vs_host"] = out["host_ms"] / out["pooled_ms"]
    out.update(first_loss=first, batch=batch, steps=steps, warmup=warmup,
               launches=paths.counts, device=common.card_name(dev))
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device), args.out)


if __name__ == "__main__":
    main()
