"""The streaming school detector at survey scale (host only): the port's
counterpart of ``scripts/school_eval_soak.py``.

Feeds a seeded synthetic sandeel probability stream of ``n_pings`` x
1000 range, made chunk by chunk (1000 pings) and never held whole,
through ``pipeline/school_eval.StreamingDetector`` and reports the wall,
pings/s, the detections and the host RSS delta (the largest ``VmRSS``
sampled during the stream minus the value before it); then holds the
stream to the dense detector on a 4000-ping slice of the same generator
(components crossing chunk borders included).

    python scripts/torch_school_eval_soak.py [--pings 50000]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402

N_RANGE = 1000
CHUNK = 1000


def chunk_probs(rng, w):
    """Speckle and a few coherent blobs for one chunk of ``w`` pings (the
    blobs are chunk-local; the dense speckle connects across borders)."""
    probs = np.where(rng.rand(N_RANGE, w) < 0.02,
                     rng.uniform(0.5, 1.0, (N_RANGE, w)),
                     0.0).astype(np.float32)
    for _ in range(6):
        y, x = rng.randint(0, N_RANGE - 12), rng.randint(0, w - 12)
        probs[y:y + rng.randint(3, 12), x:x + rng.randint(3, 12)] = \
            rng.uniform(0.6, 1.0)
    return probs


def stream(n_pings, seed=0):
    """The seeded stream's detections (threshold 0.5, min_area 2)."""
    from crimac_unet_tpu_torch.pipeline.school_eval import StreamingDetector
    rng = np.random.RandomState(seed)
    det = StreamingDetector(0.5, min_area=2)
    for x0 in range(0, n_pings, CHUNK):
        det.add_chunk(chunk_probs(rng, min(CHUNK, n_pings - x0)), x0)
    return det.finalize()


def run(n_pings=50_000, check_pings=4000) -> dict:
    from crimac_unet_tpu_torch.pipeline.school_eval import detect_schools
    with common.RssPeak() as rss:
        t0 = time.perf_counter()
        dets = stream(n_pings)
        wall = time.perf_counter() - t0
    # the dense detector on a slice of the same generator
    rng = np.random.RandomState(0)
    sl = np.concatenate([chunk_probs(rng, CHUNK)
                         for _ in range(0, check_pings, CHUNK)], axis=1)

    def key(d):
        return tuple(d["bounding_box"]), d["n_pixels"]
    streamed = sorted(map(key, stream(check_pings)))
    dense = sorted(map(key, detect_schools(sl, 0.5, min_area=2)))
    return {"n_pings": n_pings, "n_range": N_RANGE, "detections": len(dets),
            "wall_s": wall, "pings_per_sec": n_pings / wall,
            "rss_delta_bytes": rss.delta_bytes,
            "dense_equal_pings": check_pings,
            "dense_equal": streamed == dense,
            "dense_detections": len(dense)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pings", type=int, default=50_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = common.finish(run(args.pings), args.out)
    if not res["dense_equal"]:
        raise SystemExit("streamed != dense on the cross-check slice")


if __name__ == "__main__":
    main()
