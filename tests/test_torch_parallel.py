"""The port's data-parallel layer (``crimac_unet_tpu_torch/parallel``) on
the CPU, in one process and in a two-process gloo group.

Mirrors tests/test_multichip.py and tests/test_multihost.py: the
single-host ``init_distributed`` is a no-op, a mesh larger than the world
raises (in ``get_mesh``, the runner and ``SegPipeUNet``), a batch the
mesh does not divide names its key, the two-process check passes and
catches a wrong cluster shape.  Besides: the sub-batch split equals the
JAX runner's on a 2-device mesh, the sharded augmentation equals the
global one row for row, the slab halo covers the measured receptive
field, the batch order does not depend on thread timing, and a one-rank
gloo group trains bit-equal to no group.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from crimac_unet_tpu_torch.data.dataset import BatchPrefetcher
from crimac_unet_tpu_torch.models.unet import (UNet, build_unet,
                                               init_random_, init_train_,
                                               receptive_radius)
from crimac_unet_tpu_torch.ops import augment
from crimac_unet_tpu_torch.parallel import mesh as pmesh
from crimac_unet_tpu_torch.parallel import multihost_check as mc
from crimac_unet_tpu_torch.pipeline import engine
from crimac_unet_tpu_torch.pipeline.runner import (GriddedRunner,
                                                   sub_batch_shape)
from crimac_unet_tpu_torch.pipeline.segpipe import SegPipeUNet

SERVE = {"patch_size": [32, 32], "patch_overlap": 4,
         "frequencies": [18, 38, 120, 200], "fwd_batch": 8, "depth": 2,
         "start_filts": 4, "compute_dtype": "float32", "device": "cpu"}


def _fake_mesh(rank, size):
    return pmesh.Mesh(rank=rank, size=size, group=None)


def test_init_distributed_single_host_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "CRIMAC_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed() is False
    assert not dist.is_initialized()
    assert pmesh.get_mesh(0) is None and pmesh.get_mesh(1) is None


def test_writer_helpers_without_a_group():
    """A process without a process group is its own writer; the barrier
    and the broadcast are no-ops."""
    assert not dist.is_initialized()
    assert pmesh.is_writer()
    pmesh.barrier()
    obj = {"start_ping": 3}
    assert pmesh.broadcast_object(obj) is obj


def test_init_distributed_defaults_to_the_card(monkeypatch):
    """A rank runs on the card unless the caller asks for the CPU: with
    no card and no ``device`` it raises instead of joining over gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.init_distributed(
            init_method=f"tcp://127.0.0.1:{mc.free_port()}", world_size=1,
            rank=0)
    assert not dist.is_initialized()


def test_two_process_check_defaults_to_the_card():
    """``run_two_process_check`` and its CLI run on the card unless asked
    for the CPU (``device="cpu"``, ``--device cpu``)."""
    import subprocess
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mc.run_two_process_check(timeout=60)
    p = subprocess.run([sys.executable, "-m", mc.MODULE], env=mc.worker_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "CUDA is not available" in p.stderr


@pytest.mark.parametrize("n", [2, 8])
def test_get_mesh_larger_than_world_raises(n):
    with pytest.raises(ValueError, match=rf"get_mesh\({n}\) but only 1 "
                       "process"):
        pmesh.get_mesh(n)


def test_checked_shard_names_the_key_and_keeps_rank_rows():
    batch = {"ech_idx": np.arange(6), "starts": np.zeros((5, 2))}
    with pytest.raises(ValueError, match=r"batch\['starts'\] leading axis 5"
                       " is not divisible by the 2-rank mesh"):
        pmesh.checked_shard(batch, _fake_mesh(0, 2))
    batch["starts"] = np.arange(12).reshape(6, 2)
    got = pmesh.checked_shard(batch, _fake_mesh(1, 3))
    np.testing.assert_array_equal(got["ech_idx"], [2, 3])
    np.testing.assert_array_equal(got["starts"], [[4, 5], [6, 7]])
    assert pmesh.checked_shard(batch, None)["ech_idx"] is batch["ech_idx"]


def test_runner_and_segpipe_raise_without_a_world_of_two():
    net = init_random_(build_unet(SERVE), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"get_mesh\(2\)"):
        GriddedRunner(build_unet(SERVE), net.state_dict(),
                      dict(SERVE, mesh_devices=2))
    with pytest.raises(ValueError, match=r"get_mesh\(2\)"):
        SegPipeUNet(dict(SERVE, mesh_devices=2, batch_size=4, lr=0.005,
                         lr_reduction=0.5, lr_step=10, momentum=0.95))


def test_sub_batch_shape_matches_jax_on_a_two_device_mesh():
    import jax
    import jax.numpy as jnp

    from crimac_unet_tpu.models.unet import UNet as JaxUNet
    from crimac_unet_tpu.pipeline.inference import GriddedRunner as JaxRunner

    model = JaxUNet(n_classes=3, depth=2, start_filts=4)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)),
                   train=False)
    for fwd in (8, 12, 32):
        jr = JaxRunner(model, v, dict(SERVE, fwd_batch=fwd, mesh_devices=2))
        for n in (1, 7, 25, 33, 64, 100):
            assert sub_batch_shape(n, jr.fwd_batch, 2) == \
                jr._sub_batch_shape(n), (fwd, n)


@pytest.mark.parametrize("meta", [False, True])
def test_sharded_augmentation_equals_the_global_batch(meta):
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.rand(4, 4, 16, 16).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    mdata = torch.from_numpy(rng.rand(4, 2, 16, 16).astype(np.float32))

    def run(rows, shard):
        gen = torch.Generator().manual_seed(7)
        if meta:
            return augment.augment_train_meta(gen, data[rows], mdata[rows],
                                              labels[rows], shard=shard)
        return augment.augment_train(gen, data[rows], labels[rows],
                                     shard=shard)

    whole = run(slice(0, 4), None)
    parts = [run(slice(2 * r, 2 * r + 2), (r, 2)) for r in range(2)]
    for k, w in enumerate(whole):
        torch.testing.assert_close(torch.cat([p[k] for p in parts]), w,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("depth", [2, 3, 5])
def test_slab_halo_covers_the_measured_receptive_field(depth):
    """Perturb the input and see which logits move: one column reaches
    exactly ``receptive_radius``; and past a range end aligned to the
    pooling step (both phases of the end, both sides of it) the runner's
    halo is exactly what the range's interior reads: input beyond the
    halo leaves every interior logit's bits as they are, input beyond one
    pooling step less moves some."""
    torch.manual_seed(0)
    m = init_random_(UNet(depth=depth, start_filts=4),
                     torch.Generator().manual_seed(1)).eval()
    div = 2 ** (depth - 1)
    W = 32 * div
    x = torch.rand(1, 2 * div, W, 4)
    base = m(x)
    reach = 0
    for c in range(W // 2 - 2 ** depth, W // 2 + 2 ** depth):
        x2 = x.clone()
        x2[:, :, c] += 100.0
        moved = torch.nonzero((m(x2) - base).abs().amax(dim=(0, 1, 3)) > 0)
        reach = max(reach, c - int(moved.min()), int(moved.max()) - c)
    assert reach == receptive_radius(depth)
    net = init_random_(build_unet(dict(SERVE, depth=depth)),
                       torch.Generator().manual_seed(0))
    halo = GriddedRunner(build_unet(dict(SERVE, depth=depth)),
                         net.state_dict(), SERVE).slab_halo
    assert halo % div == 0

    def interior_moves(h):
        moves = []
        for end in (W // 2, W // 2 + div):
            right, left = x.clone(), x.clone()
            right[:, :, end + h:] += 100.0
            left[:, :, :end - h] += 100.0
            moves += [bool((m(right) - base)[:, :, :end].ne(0).any()),
                      bool((m(left) - base)[:, :, end:].ne(0).any())]
        return moves
    assert not any(interior_moves(halo))
    assert any(interior_moves(halo - div))


def test_receptive_radius_at_the_flagship_depth():
    assert receptive_radius(5) == 107


class _Jittery:
    """Batches that depend on the worker's seed, made after a random
    pause, so a timing-ordered queue would interleave them."""

    def __init__(self, seed):
        self.seed, self.n = seed, 0
        self.lock = threading.Lock()

    def batch(self, batch_size):
        time.sleep(np.random.uniform(0, 0.01))
        self.n += 1
        return {"x": np.full(batch_size, 1000 * self.seed + self.n)}


def test_batch_prefetcher_order_does_not_depend_on_timing():
    runs = [[int(b["x"][0]) for b in BatchPrefetcher(
        lambda seed_offset=0: _Jittery(seed_offset), 2, 13, num_workers=3)]
        for _ in range(2)]
    assert runs[0] == runs[1]
    assert runs[0][:4] == [1, 1001, 2001, 2]


def test_one_rank_group_trains_like_no_group():
    """A gloo group of one rank runs every collective of the step (the
    BatchNorm sums, the loss denominator, the gradient bucket, the loss)
    and must leave the numbers as they are."""
    cfg = {"patch_size": [32, 32], "frequencies": [18, 38, 120, 200],
           "lr": 0.005, "lr_step": 1000, "lr_reduction": 0.5,
           "momentum": 0.95, "depth": 2, "start_filts": 4,
           "compute_dtype": "float32", "loss_type": "Combined"}
    rng = np.random.RandomState(2)
    data = torch.from_numpy(rng.lognormal(np.log(3e-6), 1.5,
                                          (4, 4, 32, 32)).astype(np.float32))
    labels = torch.from_numpy(rng.choice([0, 27, 1], (4, 32, 32)).astype(
        np.int32))

    def train(mesh):
        net = init_train_(build_unet(cfg), torch.Generator().manual_seed(0))
        state = engine.init_train_state(net, cfg)
        step = engine.make_train_step(cfg, mesh)
        gen = torch.Generator().manual_seed(3)
        losses = [float(step(state, data, labels, gen)) for _ in range(2)]
        return losses, [p.detach().clone() for p in net.parameters()]

    want = train(None)
    assert pmesh.init_distributed(
        init_method=f"tcp://127.0.0.1:{mc.free_port()}", world_size=1,
        rank=0, device="cpu")
    try:
        mesh = pmesh.get_mesh(0)
        assert mesh is not None and mesh.size == 1
        got = train(mesh)
    finally:
        pmesh.shutdown_distributed()
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_two_process_check_passes():
    res = mc.run_two_process_check(timeout=240, device="cpu")
    assert np.isfinite(res["loss"]) and res["loss"] > 0
    assert np.isfinite(res["checksum"]) and res["checksum"] > 0


def test_two_process_check_detects_a_wrong_cluster_shape():
    """A worker alone in a world of one must fail its 2-rank mesh, and
    the harness must raise on it."""
    with pytest.raises(RuntimeError, match=r"get_mesh\(2\) but only 1 "
                       r"rank\(s\)"):
        mc.run_ranks(lambda r: [sys.executable, "-m", mc.MODULE, "--worker",
                                "0", "1", str(mc.free_port()), "cpu"], 1,
                     120)


def test_train_cli_under_torchrun(tmp_path):
    """The documented launch: ``torchrun --nproc_per_node 2 -m
    crimac_unet_tpu_torch.pipeline.train`` on the CPU.  Both ranks join
    from torchrun's environment (gloo), train data parallel, and rank 0
    writes one run directory with both checkpoints."""
    import json
    import subprocess

    from crimac_unet_tpu_torch.config import parse_config_options
    from crimac_unet_tpu_torch.data.fixtures import make_survey_dir

    make_survey_dir(tmp_path / "memm", year=2017, n_echograms=1, H=80,
                    W=200, seed=21)
    make_survey_dir(tmp_path / "memm", year=2016, n_echograms=1, H=80,
                    W=200, seed=22)
    cfg = parse_config_options({
        "path_to_echograms": str(tmp_path / "memm"), "patch_size": [32, 32],
        "depth": 2, "start_filts": 4, "batch_size": 4, "iterations": 2,
        "test_iter": 1, "log_step": 2, "lr_step": 2, "num_workers": 1,
        "train_surveys": [2017], "validation_surveys": [2016],
        "train_dtype": "float32"})
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(json.dumps(               # JSON is YAML
        {k: v for k, v in cfg.items() if k not in ("yaml_path", "device")}))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(mc.free_port()), "-m", "crimac_unet_tpu_torch.pipeline.train",
         "--yaml_path", str(yaml_path), "--device", "cpu"],
        cwd=tmp_path, env=mc.worker_env(), capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    (run,) = (tmp_path / "saved_models" / "tiny").iterdir()
    assert {q.name for q in run.iterdir()} >= {"best.msgpack",
                                               "last.msgpack"}
