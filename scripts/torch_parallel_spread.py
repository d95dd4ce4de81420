"""How far float32 training on two ranks drifts from one rank, against how
far one rank drifts from itself (the port, on one card).

``chip_smoke.py`` phase 16(b) holds 20 full-width float32 training steps
on two gloo ranks sharing one card against the same steps on one rank.
This study repeats that comparison over several seeds and sets two
one-rank references beside it on each seed: the run repeated in the same
process (does a run repeat itself bit for bit?), and the run with cuDNN's
autotuned algorithms in place of its deterministic ones (another float32
summation order, with no distribution at all).  Each comparison prints
one ``SPREAD {json}`` line: the weights outside the elementwise rtol 1e-3
/ atol 1e-4, the weights' max |d|, the largest ratio over the tensors of
max |d| to ``1e-3 * max |w| + 1e-4`` (phase 16's per-tensor bound, which
fails above 1), the losses' max |d| and the first step whose loss
differs.

    python3 scripts/torch_parallel_spread.py [--seeds 10,11,12]

Needs one card (TF32 off throughout, as phase 16); each seed takes about
a minute on an H100.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def train(tmp, mesh_devices, seed, tag, deterministic=True, rank=0):
    """Phase 16(b)'s training (``parallel_train_config``) with
    ``random_seed`` ``seed``; rank 0 keeps its losses and weights in
    ``tmp/<tag>.pt``."""
    from crimac_unet_tpu_torch.pipeline.train import run_training
    cfg = cs.parallel_train_config(tmp, mesh_devices)
    cfg["random_seed"] = seed
    log = cs.Scalars()
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic
    t = time.perf_counter()
    sp = run_training(cfg, tmp / f"ck_{tag}_r{rank}", logger=log,
                      progress=False)
    if rank == 0:
        torch.save({"losses": log.values("train/loss"),
                    "params": {k: v.detach().cpu() for k, v in
                               sp.model.named_parameters()}},
                   tmp / f"{tag}.pt")
        print(f"{tag}: {time.perf_counter() - t:.1f} s", flush=True)


def worker(rank, port, tmp, seed, tag):
    """One of two gloo ranks on card 0 (NCCL refuses two ranks on one
    device), as phase 16(b)'s workers."""
    from crimac_unet_tpu_torch.ops import cuda_lib
    from crimac_unet_tpu_torch.parallel import mesh as pmesh
    cuda_lib.lib()
    _tf32_off()
    pmesh.init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, device="cuda:0",
                           backend="gloo", timeout_s=cs.PARALLEL_TIMEOUT_S)
    try:
        train(Path(tmp), 2, seed, tag, True, rank)
    finally:
        pmesh.shutdown_distributed()


def two_ranks(tmp, seed, tag):
    from crimac_unet_tpu_torch.parallel.multihost_check import (free_port,
                                                                run_ranks)
    port = free_port()
    run_ranks(lambda r: [sys.executable, __file__, "--worker", str(r),
                         str(port), str(tmp), str(seed), tag], 2,
              cs.PARALLEL_TIMEOUT_S)


def compare(name, seed, a, b):
    a, b = torch.load(a), torch.load(b)
    pa, pb = a["params"], b["params"]
    la, lb = a["losses"], b["losses"]
    row = {
        "comparison": name, "seed": seed,
        "outside_elementwise": sum(
            int((~torch.isclose(pb[k], v, rtol=1e-3, atol=1e-4)).sum())
            for k, v in pa.items()),
        "weights": sum(v.numel() for v in pa.values()),
        "weights_max_abs_d": max(float((pb[k] - v).abs().max())
                                 for k, v in pa.items()),
        "max_ratio_to_tensor_bound": max(
            float((pb[k] - v).abs().max())
            / (1e-4 + 1e-3 * float(v.abs().max())) for k, v in pa.items()),
        "losses_max_abs_d": max(abs(x - y) for x, y in zip(la, lb)),
        "first_differing_step": next(
            (i for i, (x, y) in enumerate(zip(la, lb)) if x != y), None)}
    print("SPREAD " + json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="10,11,12")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    from crimac_unet_tpu_torch.ops import cuda_lib
    cs.phase_card(torch, cuda_lib)     # the card, its power limit, build
    _tf32_off()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cs.train_fixture(tmp)
        for seed in map(int, args.seeds.split(",")):
            train(tmp, 1, seed, f"one{seed}")
            train(tmp, 1, seed, f"again{seed}")
            train(tmp, 1, seed, f"autotuned{seed}", deterministic=False)
            two_ranks(tmp, seed, f"two{seed}")
            one = tmp / f"one{seed}.pt"
            compare("one rank, repeated", seed, one, tmp / f"again{seed}.pt")
            compare("one rank, cuDNN autotuned", seed, one,
                    tmp / f"autotuned{seed}.pt")
            compare("two ranks", seed, one, tmp / f"two{seed}.pt")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               int(sys.argv[5]), sys.argv[6])
    else:
        sys.exit(main())
