"""Executable two-process ``torch.distributed`` self-check.

The port's counterpart of ``crimac_unet_tpu/parallel/multihost_check.py``:
two gloo CPU workers form a real process group over localhost, each runs
one train step (depth 2, start_filts 4, float32, augmentation on) on its
half of a global batch of 8 seeded 32x32 patches, with the BatchNorm
statistics, the loss denominator and the gradient summed across the
process boundary.  Each worker's loss and float64 parameter checksum must
equal a single-process oracle's on the whole batch within rtol 1e-5 (the
two halves are summed in another order than the whole batch: float32
reassociation, ~1e-7 here).  ``device="cuda"`` (the default) runs both
ranks on one card, over gloo (NCCL refuses two ranks on one device), TF32
off, and raises without a card; ``device="cpu"`` runs them on the CPU.

Run standalone:  python -m crimac_unet_tpu_torch.parallel.multihost_check
[--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
MODULE = "crimac_unet_tpu_torch.parallel.multihost_check"
RTOL = 1e-5
CONFIG = {"patch_size": [32, 32], "frequencies": [18, 38, 120, 200],
          "lr": 0.005, "lr_step": 1000, "lr_reduction": 0.5,
          "momentum": 0.95, "depth": 2, "start_filts": 4,
          "compute_dtype": "float32", "loss_type": "CE"}


def _run_step(mesh, device="cpu") -> dict:
    """One train step on this rank's rows of the global batch (all of it
    without a mesh); shared by workers and oracle, so the comparison can
    only fail on distribution."""
    import torch
    torch.backends.cudnn.allow_tf32 = False

    from ..models.unet import build_unet, init_train_
    from ..pipeline import engine
    from .mesh import replicate_, shard_rows

    torch.set_num_threads(1)
    model = init_train_(build_unet(CONFIG), torch.Generator().manual_seed(0))
    model.to(device)
    replicate_(mesh, model)
    state = engine.init_train_state(model, CONFIG)
    step = engine.make_train_step(CONFIG, mesh)

    B = 8
    rng = np.random.RandomState(0)
    data = rng.lognormal(np.log(1e-6), 2.0, (B, 4, 32, 32)).astype(
        np.float32)
    labels = rng.choice([0, 27, 1], size=(B, 32, 32)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(1)
    loss = step(state, shard_rows(mesh, torch.from_numpy(data).to(device)),
                shard_rows(mesh, torch.from_numpy(labels).to(device)), gen)
    checksum = sum(float(p.detach().double().abs().sum())
                   for p in model.parameters())
    return {"loss": float(loss), "checksum": checksum}


def _worker_main(rank: int, world: int, port: int, device: str) -> None:
    from .mesh import get_mesh, init_distributed, shutdown_distributed
    # two ranks share the one card of a CUDA check (card 0): NCCL refuses
    # that, so they talk over gloo, which takes CUDA tensors
    device = "cuda:0" if device == "cuda" else device
    ok = init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                          world_size=world, rank=rank, device=device,
                          backend="gloo", timeout_s=120)
    assert ok, "init_distributed returned False with explicit arguments"
    try:
        # the cluster must have the shape the check is about: a world of
        # any other size fails here
        mesh = get_mesh(2)
        assert mesh is not None and mesh.size == 2 and mesh.rank == rank
        res = _run_step(mesh, device)
    finally:
        shutdown_distributed()
    print("RESULT" + json.dumps(dict(res, rank=rank)), flush=True)


def _oracle_main(device: str) -> None:
    from .mesh import get_mesh
    assert get_mesh(0) is None, "the oracle must run without a group"
    print("RESULT" + json.dumps(_run_step(None, device)), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    """The environment of a spawned rank: the repo importable, one
    thread, and no inherited torchrun variables."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "CRIMAC_MULTIHOST")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def result_line(stdout: str, tag: str = "RESULT") -> dict:
    for line in stdout.splitlines():
        if line.startswith(tag):
            return json.loads(line[len(tag):])
    raise RuntimeError(f"no {tag} line in:\n{stdout[-2000:]}")


def run_ranks(argv_of_rank, n: int, timeout: float) -> list[str]:
    """Start ``n`` processes (``argv_of_rank(r)``) at once and wait for
    all of them; raise with the failing rank's output if any exits
    nonzero or outlives ``timeout``, after killing the rest."""
    procs = [subprocess.Popen(argv_of_rank(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=worker_env()) for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} did not finish within "
                                   f"{timeout} s") from None
            outs.append(out)
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {r} exited with {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_two_process_check(timeout: float = 300.0, device="cuda") -> dict:
    """Spawn the 2-rank gloo group and the single-process oracle on
    ``device`` (``cuda`` unless the caller asks for the CPU); verify that
    every rank's loss and parameter checksum equal the oracle's.  Returns
    the oracle's numbers; raises on any worker failure, timeout or
    mismatch, and without a card when ``device`` is ``cuda``."""
    import torch
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the check runs on the "
                           "GPU unless the caller passes device='cpu' "
                           "(CLI: --device cpu)")
    port = free_port()
    outs = run_ranks(lambda r: [sys.executable, "-m", MODULE, "--worker",
                                str(r), "2", str(port), device], 2, timeout)
    results = [result_line(o) for o in outs]
    want = result_line(run_ranks(
        lambda r: [sys.executable, "-m", MODULE, "--oracle", device], 1,
        timeout)[0])
    for r in results:
        for k in ("loss", "checksum"):
            if not np.isclose(r[k], want[k], rtol=RTOL, atol=0):
                raise RuntimeError(f"rank {r['rank']} {k} {r[k]!r} != "
                                   f"oracle {want[k]!r} (rtol {RTOL})")
    return want


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker_main(*(int(a) for a in sys.argv[i + 1:i + 4]),
                     sys.argv[i + 4])
    elif "--oracle" in sys.argv:
        _oracle_main(sys.argv[sys.argv.index("--oracle") + 1])
    else:
        ap = argparse.ArgumentParser(
            description="Two gloo ranks against one process: loss and "
                        "parameter checksum within rtol 1e-5.")
        ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        ap.add_argument("--timeout", type=float, default=300.0)
        args = ap.parse_args()
        res = run_two_process_check(args.timeout, args.device)
        print(f"two-process group parity ok on {args.device}: "
              f"loss={res['loss']:.6f}")
