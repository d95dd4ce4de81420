"""Host-to-device copies of the prediction pipeline on the card: the
port's counterpart of ``scripts/h2d_probe.py``.

Does the port's per-chunk copy cost anything, and does it overlap
compute?  ``pipeline/predict.py`` ``_to_device`` pins each chunk's host
arrays anew (``pin_memory()``) and copies them ``non_blocking`` on a side
stream behind an event.  The JAX probe's six sections, each with three
arms:

* ``port``: ``_to_device`` itself (pin, then the side-stream copy), the
  wall until its event completes;
* ``plain``: a pageable ``.to(device)`` of each array on the current
  stream, then a synchronize;
* ``pinned``: the same side-stream copy from buffers pinned once, out of
  the timing (what reusing pinned buffers would cost).

1. a 1-element put; 2. puts of 1-40 MB; 3. 10 x 80 KB put separately
against one 800 KB put; 4. one chunk's transfer set (:func:`chunk_set`:
the arrays ``prepare`` hands to ``_to_device`` at the JAX probe's
geometry, a 5 x 5 grid of 256 windows at stride 216, overlap 20: the
bfloat16 (1120, 1120, 4) slab, the ``lab_bits`` planes, ``sb_row``; and
again with the grid metadata of the six families); 5. the cropped slab
(1020 x 1040) against the padded one; 6. a put while a bfloat16 4096^2
matmul chain of 100 runs on the current stream.

Times are host walls (``time.perf_counter``), the best of ``--reps``.

    python scripts/torch_h2d_probe.py
    python scripts/torch_h2d_probe.py --device cpu --reps 2 --mm-size 64

Prints the readings and one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import torch_check_common as common  # noqa: E402
from scripts import torch_timing_common as tc  # noqa: E402

ARMS = ("port", "plain", "pinned")
# the six metadata families of configs/config_meta_train.yaml
META_FAMILIES = {"portion_year": True, "portion_day": True,
                 "time_diff": True, "depth_rel": True,
                 "depth_abs_surface": True, "depth_abs_seabed": True}
_SLAB_FAMILIES = ("time_diff", "depth_rel", "depth_abs_surface",
                  "depth_abs_seabed")


def chunk_set(R=5, C=5, stride=(216, 216), overlap=20, n_freq=4,
              transfer_dtype="bfloat16", meta_channels=None, fwd_batch=32,
              Hs=None, nr=None, seed=0) -> dict:
    """One patch-mode chunk's host arrays as ``predict_reader``'s
    ``prepare`` hands them to ``_to_device``, for an R x C grid: the
    (Hs, Wp, n_freq) slab in its transfer dtype (a torch tensor), the
    packed write-mask bit planes (uint8; a third for uint8 transfer),
    ``sb_row`` (int64: seabed row a column, then the cut row) and, with
    ``meta_channels``, the (Hp, Wp, Ms) metadata slab and the (Np, Mc)
    per-patch constants (float32).  ``Hs`` (default the grid height Hp)
    and ``nr`` (default R x stride) as ``chunk_geometry`` gives them."""
    from crimac_unet_tpu_torch.pipeline.infer_common import _quantize_db_u8
    from crimac_unet_tpu_torch.pipeline.runner import sub_batch_shape
    sh, sw = stride
    Hp, Wp = R * sh + 2 * overlap, C * sw + 2 * overlap
    Hs = Hp if Hs is None else Hs
    nr = R * sh if nr is None else nr
    ncols = C * sw
    rng = np.random.RandomState(seed)
    slab = rng.randn(Hs, Wp, n_freq).astype(np.float32)
    planes = [np.packbits(rng.rand(nr, ncols) < .5, axis=1)
              for _ in range(3 if transfer_dtype == "uint8" else 2)]
    if transfer_dtype == "uint8":
        slab_x = torch.from_numpy(_quantize_db_u8(slab))
    elif transfer_dtype == "bfloat16":
        slab_x = torch.from_numpy(slab).to(torch.bfloat16)
    else:
        slab_x = torch.from_numpy(slab)
    host = {}
    if meta_channels:
        ms = sum(bool(meta_channels.get(k)) for k in _SLAB_FAMILIES)
        mc = (int(bool(meta_channels.get("portion_year")))
              + 2 * int(bool(meta_channels.get("portion_day"))))
        Np = sub_batch_shape(R * C, fwd_batch)[1]
        host["meta_slab"] = rng.rand(Hp, Wp, ms).astype(np.float32)
        host["consts"] = rng.rand(Np, mc).astype(np.float32)
    host.update(data_slab=slab_x, lab_bits=np.stack(planes),
                sb_row=rng.randint(0, nr, ncols + 1).astype(np.int64))
    return host


def _tensors(host: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in host.items()}


class Copier:
    """The three arms' copies of a dict of host arrays to ``dev``; each
    returns once the arrays are on the device."""

    def __init__(self, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.runner = SimpleNamespace(device=dev)

    def port(self, host: dict) -> dict:
        from crimac_unet_tpu_torch.pipeline.predict import _to_device
        staged = _to_device(self.runner, host, self.stream)
        if staged.event is not None:
            staged.event.synchronize()
        return staged.tensors

    def plain(self, host: dict) -> dict:
        out = {k: t.to(self.dev) for k, t in _tensors(host).items()}
        tc.synchronize(self.dev)
        return out

    def pin(self, host: dict) -> dict:
        """``host`` pinned once (the ``pinned`` arm's input)."""
        return {k: t.pin_memory() if self.cuda else t
                for k, t in _tensors(host).items()}

    def pinned(self, pinned: dict) -> dict:
        if not self.cuda:
            return dict(pinned)
        with torch.cuda.stream(self.stream):
            out = {k: t.to(self.dev, non_blocking=True)
                   for k, t in pinned.items()}
            ev = torch.cuda.Event()
            ev.record(self.stream)
        ev.synchronize()
        return out

    def best_ms(self, arm: str, host: dict, reps: int) -> float:
        src = self.pin(host) if arm == "pinned" else host
        fn = getattr(self, arm)
        fn(src)                                     # warm
        best = float("inf")
        for _ in range(reps):
            tc.synchronize(self.dev)
            t0 = time.perf_counter()
            fn(src)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3


def _arms(cp, host, reps) -> dict:
    return {arm: cp.best_ms(arm, host, reps) for arm in ARMS}


def _nbytes(host: dict) -> int:
    return sum(v.nbytes if isinstance(v, np.ndarray)
               else v.numel() * v.element_size() for v in host.values())


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.3f} ms" for k, v in d.items())


def put_during_compute(cp, host, dev, n_mm=100, size=4096) -> dict:
    """Section 6: a bfloat16 ``size``^2 matmul chain of ``n_mm`` enqueued on
    the current stream, then each arm's put of ``host`` while it runs:
    (dispatch, put, put + the rest of the compute) ms, and the chain
    alone."""
    gen = torch.Generator(device=dev).manual_seed(5)
    w = (torch.randn((size, size), generator=gen, device=dev)
         / size ** .5).to(torch.bfloat16)

    def chain():
        a = w
        for _ in range(n_mm):
            a = a @ w / 64.0
        return a

    chain()
    tc.synchronize(dev)
    t0 = time.perf_counter()
    chain()
    tc.synchronize(dev)
    out = {"compute_alone_ms": (time.perf_counter() - t0) * 1e3}
    for arm in ARMS:
        src = cp.pin(host) if arm == "pinned" else host
        getattr(cp, arm)(src)                       # warm
        tc.synchronize(dev)
        t0 = time.perf_counter()
        chain()
        t_disp = time.perf_counter() - t0
        t1 = time.perf_counter()
        getattr(cp, arm)(src)
        t_put = time.perf_counter() - t1
        tc.synchronize(dev)
        t_total = time.perf_counter() - t1
        out[arm] = {"dispatch_ms": t_disp * 1e3, "put_ms": t_put * 1e3,
                    "total_ms": t_total * 1e3}
    return out


def run(device="cuda", reps=5, mm_size=4096, log=print) -> dict:
    dev = common.device_of(device)
    card = common.card_name(dev)
    cp = Copier(dev)
    rng = np.random.RandomState(0)
    log(f"device: {card}; arms: port (_to_device), plain (pageable "
        f".to), pinned (pinned once); best of {reps}")
    res = {"device": card, "reps": reps}

    res["one_element"] = _arms(cp, {"a": np.zeros(8, np.float32)}, reps)
    log(f"1. 1-elem put: {_fmt(res['one_element'])}")

    res["bandwidth"] = {}
    for mb in (1, 4, 10, 20, 40):
        a = rng.randn(mb * 2 ** 20 // 4).astype(np.float32)
        r = _arms(cp, {"a": a}, reps)
        res["bandwidth"][mb] = {arm: {"ms": ms, "mb_per_s": mb / (ms / 1e3)}
                                for arm, ms in r.items()}
        log(f"2. {mb:3d} MB put: " + ", ".join(
            f"{arm} {ms:.3f} ms ({mb / (ms / 1e3):.0f} MB/s)"
            for arm, ms in r.items()))

    smalls = {f"s{i}": rng.randn(20000).astype(np.float32)
              for i in range(10)}
    res["smalls"] = {
        "separate": _arms(cp, smalls, reps),
        "one": _arms(cp, {"cat": np.concatenate(list(smalls.values()))},
                     reps)}
    log(f"3. 10 x 80 KB separate: {_fmt(res['smalls']['separate'])}; one "
        f"800 KB put: {_fmt(res['smalls']['one'])}")

    res["chunk"] = {}
    for tag, meta in (("default", None), ("meta", META_FAMILIES)):
        host = chunk_set(meta_channels=meta)
        slab = {"data_slab": host["data_slab"]}
        small = {k: v for k, v in host.items() if k != "data_slab"}
        r = {"keys": {k: [list(v.shape), str(v.dtype)]
                      for k, v in host.items()},
             "bytes": _nbytes(host), "slab_bytes": _nbytes(slab),
             "all": _arms(cp, host, reps), "slab": _arms(cp, slab, reps),
             "small": _arms(cp, small, reps)}
        res["chunk"][tag] = r
        log(f"4. chunk set ({tag}, {r['bytes'] / 1e6:.2f} MB; slab "
            f"{r['slab_bytes'] / 1e6:.2f} MB): slab {_fmt(r['slab'])}; "
            f"{len(small)} small arrays {_fmt(r['small'])}; all together "
            f"{_fmt(r['all'])}")

    padded = chunk_set()["data_slab"]
    cropped = padded[:1020, :1040].contiguous()
    res["crop"] = {"padded_mb": padded.numel() * 2 / 1e6,
                   "cropped_mb": cropped.numel() * 2 / 1e6,
                   "padded": _arms(cp, {"s": padded}, reps),
                   "cropped": _arms(cp, {"s": cropped}, reps)}
    log(f"5. cropped slab {res['crop']['cropped_mb']:.2f} MB: "
        f"{_fmt(res['crop']['cropped'])} (padded "
        f"{res['crop']['padded_mb']:.2f} MB: {_fmt(res['crop']['padded'])})")

    res["during_compute"] = put_during_compute(cp, {"s": padded}, dev,
                                               size=mm_size)
    dc = res["during_compute"]
    log(f"6. put during a 100-matmul chain of {mm_size}^2 (alone "
        f"{dc['compute_alone_ms']:.2f} ms): " + "; ".join(
            f"{arm} dispatch {dc[arm]['dispatch_ms']:.2f}, put "
            f"{dc[arm]['put_ms']:.2f}, total {dc[arm]['total_ms']:.2f} ms"
            for arm in ARMS))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mm-size", type=int, default=4096,
                    help="side of section 6's bfloat16 matmuls")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    common.finish(run(args.device, args.reps, args.mm_size), args.out)


if __name__ == "__main__":
    main()
